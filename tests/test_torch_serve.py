"""Port serving vs the JAX reference engine, and the port's guards.

Greedy tokens must be identical to the reference's for ragged prompts on
the reduced configs the port serves (fp32 on the CPU, same weights).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import transformer as jtransformer
from repro.models.model_zoo import build_model as jbuild_model
from repro.serve.engine import ServeConfig as JServeConfig, ServeEngine as JServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.weights import from_jax_params, init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = [[5, 17, 300, 2, 9], [44] * 12, [1, 2, 3, 4, 5, 6, 7, 8, 9]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _engines(name, temperature=0.0):
    jcfg = JARCHS[name].reduced()
    shapes = jax.eval_shape(lambda k: jtransformer.init_lm_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(7)
    np_params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    jeng = JServeEngine(jbuild_model(jcfg), jax.tree_util.tree_map(jnp.asarray, np_params),
                        JServeConfig(max_len=48, max_new_tokens=6, temperature=temperature))
    cfg = ARCHS[name].reduced()
    eng = ServeEngine(build_model(cfg, device="cpu"),
                      from_jax_params(cfg, np_params, device="cpu"),
                      ServeConfig(max_len=48, max_new_tokens=6, temperature=temperature),
                      device="cpu")
    return jeng, eng


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "gemma2-9b", "rwkv6-7b"])
def test_greedy_tokens_match_reference(name):
    jeng, eng = _engines(name)
    want = jeng.generate(PROMPTS)
    got = eng.generate(PROMPTS)
    assert got == want
    assert [len(o) for o in got] == [6, 6, 6]
    assert eng.last_timing["prefill_len"] == 12
    # as in the reference, the loop also decodes after the last kept token
    assert len(eng.last_timing["decode_s"]) == 6


def test_temperature_sampling_matches_reference():
    """Same probabilities to ~1e-7, same numpy stream: the same draws."""
    jeng, eng = _engines("gemma2-9b", temperature=0.8)
    assert eng.generate(PROMPTS, rng_seed=3) == jeng.generate(PROMPTS, rng_seed=3)


def test_launch_serve_runs_on_cpu(capsys):
    res = launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "40", "--min-prompt-len", "36",
                             "--max-len", "64", "--max-new", "3"])
    assert [len(o) for o in res["outputs"]] == [3, 3]
    assert all(36 <= len(p) <= 40 for p in res["prompts"])  # past the window of 32
    assert res["dtype"] == "float32"
    assert res["timing"]["prefill_len"] == max(len(p) for p in res["prompts"])
    assert "generated 6 tokens" in capsys.readouterr().out


def test_launch_serve_runs_rwkv6_on_cpu(capsys):
    res = launch_serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "20", "--min-prompt-len", "9",
                             "--max-len", "64", "--max-new", "3"])
    assert [len(o) for o in res["outputs"]] == [3, 3]
    assert res["cfg"].mixer_pattern == ("rwkv",) and res["dtype"] == "float32"
    assert res["timing"]["prefill_len"] == max(len(p) for p in res["prompts"])
    assert len(res["timing"]["decode_s"]) == 3
    assert "generated 6 tokens" in capsys.readouterr().out


def test_entry_points_raise_without_a_card(monkeypatch):
    """Asked for nothing, every entry point wants the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["gemma2-9b"].reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(model, model.init(), ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--reduced"])


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    port = ROOT / "src" / "repro_torch"
    for module in ("train/optimizer.py", "train/train_loop.py", "data/pipeline.py",
                   "checkpoint/ckpt.py", "launch/train_lm.py", "core/surrogate.py",
                   "core/training.py", "core/predict_cache.py", "launch/dispatch.py"):
        assert port / module in files, module
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)
