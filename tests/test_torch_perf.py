"""The perf experiments (``repro_torch.launch.perf``) and their knobs, on
the CPU, against the reference's ``repro.launch.perf``.

* The registry equals the reference's, name for name and knob for knob. It
  is read from the reference's source with ``ast.literal_eval``: importing
  that module rewrites ``XLA_FLAGS``.
* ``run_experiment`` sets an experiment's variables for the build and the
  trace only, and restores every one after a success and after an exception.
* ``REPRO_CAST_BARRIER=1`` on a fake 2 x 2 mesh (a reduced gemma-7b train
  step): each weight is gathered over ``data`` in bf16, byte for byte, and
  every other collective is as without it (the gradients are reduced in
  fp32); a prefill, a decode step and whisper's train step trace as without
  it (the barrier is ``lm_loss``'s, and serving's weights are bf16 already).
* ``rs_grads`` records as ``baseline`` (``run_experiment`` passes no
  ``constrain_grads`` on): each gradient of a weight laid out on ``data`` is
  already reduce-scattered there, and only the weights replicated on
  ``data`` are all-reduced over it.
* ``REPRO_ATTN_CHUNK_THRESHOLD`` sends ``attention_plain`` down the query
  chunks and it equals the reference's ``attention(..., backend="reference")``
  under the same variable within 1e-5 (fp32).
* The stream's gathers over ``model`` carry bf16 in bf16 compute, with or
  without ``REPRO_ATTN_BF16_WIRE``: the port has no fp32 wire to take off.
* ``REPRO_ATTN_BF16_WIRE=1``: ``mha_reference`` on bf16 inputs equals the
  reference's under the same variable within one bf16 rounding of the
  output's largest value (2^-8 of it: both accumulate exact products in
  fp32, in different orders, and round the result to bf16); without the
  variable the two part by more.
* The refused experiments raise their named ``NotImplementedError``, and the
  CLI exits 1 on them; the CLI runs ``baseline`` and ``cast_barrier`` on a
  full-width cell without a card, and the barrier halves the weight gathers
  over ``data``.
"""

import ast
import contextlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import dryrun, perf, shapes as shp, steps
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

from test_torch_train import _two_threads  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location(
    "predict_cast_barrier", ROOT / "scripts" / "predict_cast_barrier.py")
_PREDICT = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_PREDICT)
KNOBS = ("REPRO_CAST_BARRIER", "REPRO_ATTN_BF16_WIRE", "REPRO_ATTN_CHUNK_THRESHOLD",
         "REPRO_GRAD_SYNC_BF16", "REPRO_SP_GATHER")
REFUSED = {"sp_gather_off", "moe_ep2d", "moe_ep2d+bf16_wire", "moe_ep2d+bf16_wire+rs_grads",
           "moe_kitchen_sink", "optimized_moe"}
CHUNK_TOL = 1e-5
WIRE_TOL = 2.0 ** -8  # of the output's largest value
TINY_TRAIN = shp.ShapeCell("tiny", 32, 4, "train")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _reference_registry():
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "perf.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and [ast.unparse(t) for t in n.targets] == ["EXPERIMENTS"])
    return ast.literal_eval(node.value)


def test_registry_is_the_reference():
    want = _reference_registry()
    assert len(want) == 21
    assert list(perf.EXPERIMENTS) == list(want)
    assert perf.EXPERIMENTS == want
    assert {n for n, knobs in want.items() if perf.refusal(knobs)} == REFUSED


@contextlib.contextmanager
def _mesh(world=4):
    with dryrun.fake_world(world):
        yield make_mesh_from_devices(range(world), (2, 2), ("data", "model"), "cuda")
    assert not torch.distributed.is_initialized()


def _trace(cfg, cell, env=None, **kw):
    """(summary, collective bytes by kind and axis) of one step on the 2 x 2 mesh."""
    with perf.environment(env or {}), _mesh() as mesh:
        counter = dryrun.count(steps.build_step(cfg, cell, mesh, **kw))
        return counter.summary(), perf.by_axis(counter.collectives, mesh)


def _counts(summary):
    return {k: summary[k] for k in ("flops", "bytes", "n_ops", "nvlink", "nic", "by_kind",
                                    "n_collectives", "peak_bytes", "peak_by_category")}


# ---------------------------------------------------------------------------
# run_experiment and the environment
# ---------------------------------------------------------------------------

def test_run_experiment_restores_the_environment(monkeypatch):
    """kitchen_sink sets four variables: one was "0" before, three unset."""
    monkeypatch.setenv("REPRO_GRAD_SYNC_BF16", "0")
    seen = []
    build = steps.build_step

    def spy(*a, **kw):
        seen.append({k: os.environ.get(k) for k in KNOBS})
        if len(seen) == 2:
            raise RuntimeError("build failed")
        return build(*a, **kw)

    monkeypatch.setattr(perf.steps, "build_step", spy)
    rec = perf.run_experiment("gemma-7b", "decode_32k", "kitchen_sink")
    assert rec["experiment"] == "kitchen_sink" and rec["collective_ms"] > 0
    with pytest.raises(RuntimeError, match="build failed"):
        perf.run_experiment("gemma-7b", "decode_32k", "kitchen_sink")
    inside = {"REPRO_CAST_BARRIER": "1", "REPRO_ATTN_BF16_WIRE": "1",
              "REPRO_ATTN_CHUNK_THRESHOLD": "2097152", "REPRO_GRAD_SYNC_BF16": "1",
              "REPRO_SP_GATHER": None}
    assert seen == [inside, inside]
    assert {k: os.environ.get(k) for k in KNOBS} == {
        "REPRO_CAST_BARRIER": None, "REPRO_ATTN_BF16_WIRE": None,
        "REPRO_ATTN_CHUNK_THRESHOLD": None, "REPRO_GRAD_SYNC_BF16": "0",
        "REPRO_SP_GATHER": None}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_experiments_raise_their_reason(name):
    reason = perf.SP_GATHER_OFF if name == "sp_gather_off" else perf.EXPERT_FF_ON_DATA
    with pytest.raises(NotImplementedError) as err:
        perf.run_experiment("phi3.5-moe-42b-a6.6b", "train_4k", name)
    assert str(err.value) == f"{name}: {reason}"


# ---------------------------------------------------------------------------
# The knobs on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

def _weight_bytes(cfg, strategy="fsdp_tp"):
    """Elements a rank gathers over ``data`` in one train step (the shape
    rule of ``scripts/predict_cast_barrier.py``), the elements of the
    gradient blocks it reduce-scatters over ``data``, and the elements of
    the weights ``data`` replicates (their gradients all-reduced)."""
    params = shp.param_specs_shapes(cfg, torch.float32)
    with _mesh() as mesh:
        specs = shd.param_specs(mesh, shd.STRATEGIES[strategy](), params)
        gathered = _PREDICT.weight_gathers(cfg, mesh, strategy)["data"]
    scattered = replicated = 0
    for name, p in params.named_parameters():
        axes = [a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        if "data" in axes:
            split = tp.splits_compute(name) and "model" in axes
            scattered += p.numel() // 2 if split else p.numel()
        else:
            replicated += p.numel()
    return gathered, scattered, replicated


def test_cast_barrier_gathers_the_weights_over_data_in_bf16():
    cfg = ARCHS["gemma-7b"].reduced()
    base, base_axes = _trace(cfg, TINY_TRAIN)
    cast, cast_axes = _trace(cfg, TINY_TRAIN, {"REPRO_CAST_BARRIER": "1"})
    gathered, scattered, _ = _weight_bytes(cfg)
    assert base_axes["all-gather"]["data"] == 4 * gathered
    assert cast_axes["all-gather"]["data"] == 2 * gathered
    # the gradients reduced in fp32, the stream's collectives over model (bf16 already)
    assert cast_axes["reduce-scatter"]["data"] == 4 * scattered
    cast_axes["all-gather"]["data"] = base_axes["all-gather"]["data"]
    assert cast_axes == base_axes
    assert cast["flops"] == base["flops"] and cast["bytes"] < base["bytes"]


def test_the_streams_gathers_carry_the_compute_dtype():
    """What the reference's bf16 wire keeps off GSPMD's gathers never rides
    the port's: under the sequence split each all-gather over ``model`` is
    a rank's rows of the normed stream, whole along the sequence, in bf16
    (bf16 compute), with or without the knobs."""
    cfg = ARCHS["gemma-7b"].reduced()
    rows = TINY_TRAIN.global_batch // 2
    for env in ({}, {"REPRO_ATTN_BF16_WIRE": "1"}):
        with perf.environment(env), _mesh() as mesh:
            counter = dryrun.count(steps.build_step(cfg, TINY_TRAIN, mesh))
            over_model = [op for op in counter.collectives
                          if op.kind == "all-gather" and op.ranks == (0, 1)]
        assert over_model and {op.bytes for op in over_model} == {
            rows * TINY_TRAIN.seq_len * cfg.d_model * 2}


@pytest.mark.parametrize("arch,kind", [("gemma-7b", "prefill"), ("gemma-7b", "decode"),
                                       ("whisper-medium", "train")])
def test_cast_barrier_leaves_serving_and_whisper_unchanged(arch, kind):
    cfg = ARCHS[arch].reduced()
    cell = shp.ShapeCell("tiny", 32, 4, kind)
    base, base_axes = _trace(cfg, cell)
    cast, cast_axes = _trace(cfg, cell, {"REPRO_CAST_BARRIER": "1"})
    assert _counts(cast) == _counts(base) and cast_axes == base_axes
    assert base["n_collectives"] > 0


@pytest.mark.parametrize("strategy,pair", [
    ("fsdp_tp", ("baseline", "rs_grads")),
    ("fsdp_tp_noseq", ("no_seq_shard", "no_seq_shard+rs_grads"))])
def test_rs_grads_is_the_ports_only_gradient_reduction(monkeypatch, strategy, pair):
    """``constrain_grads`` changes nothing: ``run_experiment`` builds the
    same step with it (gemma-7b x train_4k, the record equal less the
    seconds), and that step already reduce-scatters. On the 2 x 2 mesh a
    weight on ``data`` has its gradient reduce-scattered there, byte for
    byte, and the all-reduces over ``data`` are the replicated weights'
    gradients and the loss's scalars alone."""
    monkeypatch.setitem(perf.EXPERIMENTS, "no_seq_shard+rs_grads",
                        {"strategy": "fsdp_tp_noseq", "constrain_grads": True})
    base, rs = (perf.run_experiment("gemma-7b", "train_4k", e) for e in pair)
    for r in (base, rs):
        del r["experiment"], r["wall_s"]
    assert rs == base
    cfg = ARCHS["gemma-7b"].reduced()
    _, base_axes = _trace(cfg, TINY_TRAIN, strategy=strategy)
    _, scattered, replicated = _weight_bytes(cfg, strategy)
    assert base_axes["reduce-scatter"]["data"] == 4 * scattered
    assert 0 < base_axes["all-reduce"]["data"] - 4 * replicated < 4 * min(
        p.numel() for p in shp.param_specs_shapes(cfg, torch.float32).parameters()
        if p.ndim == 2)


# ---------------------------------------------------------------------------
# The attention knobs against the reference
# ---------------------------------------------------------------------------

def _qkv(dtype, S=48, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, S, h, 32)).astype(np.float32) for h in (4, 2, 2)]


def test_chunk_threshold_is_read_at_each_call(monkeypatch):
    q, k, v = _qkv(np.float32)
    calls = []
    chunked = fa_ref.mha_chunked
    monkeypatch.setattr(fa_ref, "mha_chunked", lambda *a, **kw: calls.append(1) or
                        chunked(*a, **kw))
    jcalls = []
    jchunked = jfa_ref.mha_chunked
    monkeypatch.setattr(jfa_ref, "mha_chunked", lambda *a, **kw: jcalls.append(1) or
                        jchunked(*a, **kw))
    kw = dict(causal=True, window=20, softcap=30.0)
    t = [torch.tensor(x) for x in (q, k, v)]
    whole = fa_ref.attention_plain(*t, **kw).numpy()
    assert not calls
    monkeypatch.setenv("REPRO_ATTN_CHUNK_THRESHOLD", str(16 * 48))
    got = fa_ref.attention_plain(*t, **kw).numpy()
    want = np.asarray(jfa_ops.attention(*(jnp.asarray(x) for x in (q, k, v)),
                                        backend="reference", **kw))
    assert calls and jcalls  # both took the query chunks
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHUNK_TOL * scale)
    np.testing.assert_allclose(got, whole, rtol=0, atol=CHUNK_TOL * scale)


@pytest.mark.parametrize("opts", [dict(causal=True), dict(causal=True, window=16, softcap=20.0),
                                  dict(causal=False)])
def test_bf16_wire_takes_the_references_numerics(monkeypatch, opts):
    q, k, v = _qkv(np.float32, seed=1)

    def both():
        got = fa_ref.mha_reference(*(torch.tensor(x).bfloat16() for x in (q, k, v)), **opts)
        want = jfa_ref.mha_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), **opts)
        return got.float().numpy(), np.asarray(want.astype(jnp.float32))

    off, want_off = both()
    monkeypatch.setenv("REPRO_ATTN_BF16_WIRE", "1")
    on, want_on = both()
    scale = np.abs(want_on).max()
    np.testing.assert_allclose(on, want_on, rtol=0, atol=WIRE_TOL * scale)
    np.testing.assert_allclose(off, want_off, rtol=0, atol=WIRE_TOL * scale)
    # the knob moves both sides alike: on against off is more than their gap
    assert np.abs(on - off).max() > np.abs(on - want_on).max()
    assert np.abs(want_on - want_off).max() > WIRE_TOL * scale
    # fp32 inputs compute as without the knob
    t32 = [torch.tensor(x) for x in (q, k, v)]
    wire32 = fa_ref.mha_reference(*t32, **opts)
    monkeypatch.delenv("REPRO_ATTN_BF16_WIRE")
    assert torch.equal(wire32, fa_ref.mha_reference(*t32, **opts))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, cell, *exps):
    out = tmp_path / "perf"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--cell", cell, "--exp", *exps,
         "--out", str(out)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    lines = (tmp_path / "perf.jsonl").read_text().splitlines()
    return proc, [json.loads(line) for line in lines]


def test_cli_refuses_an_unported_experiment(tmp_path):
    proc, records = _cli(tmp_path, "phi3.5-moe-42b-a6.6b:train_4k", "moe_ep2d")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert records == [{"experiment": "moe_ep2d", "arch": "phi3.5-moe-42b-a6.6b",
                        "shape": "train_4k",
                        "error": f"NotImplementedError: moe_ep2d: {perf.EXPERT_FF_ON_DATA}"}]
    assert "ROADMAP.md A.1" in proc.stdout


def test_cli_runs_cast_barrier_on_a_full_width_cell_without_a_card(tmp_path):
    proc, records = _cli(tmp_path, "gemma-7b:train_4k", "baseline", "cast_barrier")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    base, cast = records
    assert [r["experiment"] for r in records] == ["baseline", "cast_barrier"]
    for r in records:
        assert f"[{r['experiment']:<28}] compute=" in proc.stdout
        assert set(r) == {"experiment", "arch", "shape", "wall_s", "compute_ms", "memory_ms",
                          "collective_ms", "bottleneck", "useful_ratio", "roofline_frac",
                          "peak_gb", "nvlink_gb", "nic_gb", "by_kind", "by_axis"}
    # every weight of gemma-7b splits along model: the gathers over data are the weights'
    assert cast["by_axis"]["all-gather"]["data"] * 2 == base["by_axis"]["all-gather"]["data"]
    assert cast["by_axis"]["all-gather"]["model"] == base["by_axis"]["all-gather"]["model"]
    assert cast["by_axis"]["reduce-scatter"] == base["by_axis"]["reduce-scatter"]
    assert cast["compute_ms"] == base["compute_ms"]
    assert cast["collective_ms"] < base["collective_ms"]
