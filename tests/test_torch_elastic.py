"""The port's elastic path against the JAX reference, on the CPU:
``ft/elastic.py`` (a copy), the coordinator's decisions, a checkpoint saved
on one mesh and restored into another, the training launcher on gloo ranks,
and ``launch/elastic.py`` against ``examples/elastic_recovery.py``.

Multi-rank cases run on gloo ranks, each its own process
(``tests/_torch_ranks.py``). Tolerances:
  * the coordinator: decisions and logs equal (its scores are the numpy
    ground truth in both packages);
  * restore into a new mesh: the resumed losses within 1e-5 relative of an
    uninterrupted single-process run (fp32; sums in another order);
  * the elastic flow from the reference's own init against the reference
    example: 80 fp32 steps through a restore, the logged losses within 1e-4
    relative (the single-process loop holds 1e-4 over 5 steps in
    ``test_torch_train.py``; about 1e-6 is seen here).
"""

import ast
import pathlib
import re
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import ARCHS as JARCHS
from repro.core import cluster as jcluster
from repro.ft import elastic as jelastic
from repro.launch import mesh as jmesh
from repro.models.model_zoo import build_model as jbuild_model
import repro_torch.core as core
from repro_torch.configs import ARCHS
from repro_torch.core import cluster as pcluster
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft import elastic
from repro_torch.launch import elastic as launch_elastic
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, train_loop

from _torch_ranks import ROOT, run_ranks

ROOT = pathlib.Path(ROOT)
LOSS_RTOL = 1e-5
FLOW_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The copy
# ---------------------------------------------------------------------------

def _code(path, rewrite):
    """The module's code as an AST dump: docstrings dropped, ``repro.``
    imports rewritten to ``repro_torch.`` when ``rewrite``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if rewrite and isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "repro":
            node.module = "repro_torch" + node.module[len("repro"):]
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                body = body[1:]
            node.body = body or [ast.Pass()]
    return ast.dump(tree)


def test_elastic_is_a_copy_of_the_reference():
    assert _code(ROOT / "src" / "repro_torch" / "ft" / "elastic.py", False) == \
        _code(ROOT / "src" / "repro" / "ft" / "elastic.py", True)


# ---------------------------------------------------------------------------
# The coordinator's decisions
# ---------------------------------------------------------------------------

def _stack(pkg, cl, **kw):
    sim = pkg.BandwidthSimulator(cl)
    tables = pkg.IntraHostTables(cl, sim)
    return pkg.BandPilotDispatcher(cl, tables, pkg.GroundTruthPredictor(sim), **kw)


def _plain(x):
    """Logs and decisions as plain Python values (numpy floats as floats)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    if hasattr(x, "new_allocation"):
        return (_plain(x.new_allocation), float(x.predicted_bw), x.reason)
    return x


def _both(fn):
    """fn(package, elastic module) for the reference and the port."""
    return _plain(fn(jcore, jelastic)), _plain(fn(core, elastic))


def test_redispatch_log_matches_reference():
    """``tests/test_substrate.py``'s host-failure case."""
    def run(pkg, el):
        coord = el.ElasticCoordinator(pkg.h100_cluster(), _stack(pkg, pkg.h100_cluster()),
                                      request_size=16)
        trained = []

        def build_and_train(alloc, start):
            trained.append(list(alloc))
            return start + 10, 1.0

        log = el.run_elastic_training(coord, build_and_train, [
            el.FailureEvent(step=10, failed_gpus=list(range(8, 16)))], total_steps=20)
        return log, trained

    (jlog, jtrained), (log, trained) = _both(run)
    assert log == jlog and trained == jtrained
    assert [e["event"] for e in log] == ["dispatch", "train", "redispatch", "train"]
    assert not set(log[2]["alloc"]) & set(range(8, 16)) and len(log[2]["alloc"]) == 16


@pytest.mark.parametrize("steps", [
    [{0: 1.0, 1: 1.0, 2: 1.0, 3: 5.0}] * 2 + [{0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}],
    [{0: 1.0, 1: 1.0, 2: 1.0, 3: 10.0}] * 2 + [{0: 1.0, 1: 1.0, 2: 1.0}]
    + [{0: 1.0, 1: 1.0, 2: 1.0, 3: 10.0}] * 3,
])
def test_straggler_monitor_matches_reference(steps):
    jmon, mon = jelastic.StragglerMonitor(1.5, 2), elastic.StragglerMonitor(1.5, 2)
    assert [mon.observe(s) for s in steps] == [jmon.observe(s) for s in steps]


def test_handle_failure_rounding_matches_reference(monkeypatch):
    """``tests/test_faults.py``'s mixed 8-4-4 pool: the request rounds to the
    surviving pool's dominant host size."""
    def run(pkg, el):
        cm = jcluster if pkg is jcore else pcluster
        monkeypatch.setitem(cm.HOST_TYPES, "H100x4", cm.HostType(
            "H100x4", tuple(tuple(r) for r in cm._uniform_topology("NV16", 4)), 50.0, True))
        cl = cm.Cluster([("H100", 1), ("H100x4", 2)], name="mixed-8-4-4")
        coord = el.ElasticCoordinator(cl, _stack(pkg, cl), request_size=cl.n_gpus)
        first = coord.initial_dispatch()
        dead = list(cl.hosts[0].gpu_ids) + list(cl.hosts[1].gpu_ids[:2])
        return first, coord.handle_failure(el.FailureEvent(step=1, failed_gpus=dead))

    want, got = _both(run)
    assert got == want
    assert len(got[1][0]) == 4


def test_consider_rebalance_matches_reference():
    """``tests/test_scheduler.py``'s rebalance and ``tests/test_faults.py``'s
    contended grading: the same decisions, the same predictor calls."""
    def run(pkg, el):
        cl = pkg.h100_cluster()
        disp = _stack(pkg, cl, contention_aware=False)
        coord = el.ElasticCoordinator(cl, disp, 8, migration_cost_per_gpu=2.0)
        with pytest.raises(RuntimeError):
            coord.consider_rebalance()
        out = [coord.initial_dispatch(), coord.consider_rebalance()]
        coord.current = [0, 1, 8, 9, 16, 17, 24, 25]  # 2+2+2+2: rail-bound
        out.append(coord.consider_rebalance())
        aware = _stack(pkg, cl)
        coord = el.ElasticCoordinator(cl, aware, request_size=4)
        out.append(coord.initial_dispatch())
        calls, orig = [], aware.contention_predictor.predict
        aware.contention_predictor.predict = lambda s: calls.append(list(s)) or orig(s)
        out += [coord.consider_rebalance(), calls]
        return out

    want, got = _both(run)
    assert got == want
    assert got[2][2] == "rebalance" and got[1] is None and got[5]


# ---------------------------------------------------------------------------
# Restore into a new mesh
# ---------------------------------------------------------------------------

def _restore_setup():
    cfg = ARCHS["gemma-7b"].reduced()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=2))
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-3, weight_decay=0.01), total_steps=6,
                         warmup_steps=2, compute_dtype=torch.float32)
    return cfg, data, run


_RESTORE = """
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import LM
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.train.train_loop import make_train_step, train_loop

cfg, data, run, ckpt_dir = inputs
rules = shd.STRATEGIES["fsdp_tp"]()
model = build_model(cfg, device="cpu")
ck = Checkpointer(ckpt_dir, keep=1)
first = ShardedModel(model, make_mesh_from_devices(range(4), (2, 2), ("data", "model"), "cpu"),
                     rules)
lm, state, hist = train_loop(first, first.init(0), data.batches(3), run, log_every=1,
                             checkpointer=ck, checkpoint_every=3)
result = {"before": [h["loss"] for h in hist], "steps": ck.all_steps()}
# ranks 1 and 3 are lost: a 2 x 1 mesh over ranks 0 and 2, built by every rank
second = ShardedModel(model, make_mesh_from_devices([0, 2], (2, 1), ("data", "model"), "cpu"),
                      rules)
if second.mesh.get_coordinate() is not None:
    fresh = second.shard(LM(cfg, torch.device("cpu"), torch.float32))
    step, restored = ck.restore({"params": fresh, "opt": make_train_step(second, run)[1](fresh)})
    lm, state, hist = train_loop(second, restored["params"], data.batches(3, start=step), run,
                                 log_every=1, start_step=step, opt_state=restored["opt"])
    result.update(step=step, after=[h["loss"] for h in hist], opt_step=state.step,
                  placements={n: tuple(p.placements) for n, p in lm.named_parameters()})
"""


def test_checkpoint_from_a_2x2_mesh_resumes_on_a_2x1_mesh(tmp_path):
    cfg, data, run = _restore_setup()
    ranks = run_ranks(_RESTORE, 4, tmp_path, inputs=(cfg, data, run, str(tmp_path / "ck")))
    model = build_model(cfg, device="cpu")
    _, state, hist = train_loop(model, model.init(0), data.batches(6), run, log_every=1)
    losses = [h["loss"] for h in hist]
    for rank, res in enumerate(ranks):
        assert res["steps"] == [3]
        np.testing.assert_allclose(res["before"], losses[:3], rtol=LOSS_RTOL)
        if rank in (1, 3):
            assert "after" not in res  # left out of the new mesh
            continue
        assert res["step"] == 3 and res["opt_step"] == state.step == 6
        np.testing.assert_allclose(res["after"], losses[3:], rtol=LOSS_RTOL)
        # on the 2 x 1 mesh the FSDP dim splits 2 ways and "model" has size 1
        assert res["placements"]["embed"][0].is_shard()
    assert ranks[0]["placements"] == ranks[2]["placements"]


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def _launch(module, *args, timeout=120):
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launch_train_on_four_gloo_ranks():
    out = _launch("repro_torch.launch.train", "--arch", "gemma-7b", "--reduced", "--steps", "6",
                  "--devices", "4", "--mesh", "2x2", "--device", "cpu", "--log-every", "2")
    assert "pool: 4 devices; request k=4; dispatcher=bandpilot" in out
    assert "dispatched devices: [0, 1, 2, 3]; mesh {'data': 2, 'model': 2}" in out
    losses = [float(x) for x in re.findall(r"step \d+: loss=([-\d.naif]+)", out)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert out.count("training complete") == 1


def test_launch_train_dispatches_as_the_reference_and_leaves_ranks_out():
    """8 ranks, 4 requested: BandPilot's choice on the reference's one-tray
    cluster; the 4 ranks left out build the mesh and exit."""
    out = _launch("repro_torch.launch.train", "--arch", "gemma-7b", "--reduced", "--steps", "2",
                  "--devices", "8", "--request", "4", "--mesh", "2x2", "--device", "cpu",
                  "--log-every", "1")
    cl = jcore.tpu_pod_cluster(1)
    sim = jcore.BandwidthSimulator(cl)
    want = jmesh.bandpilot_device_order(jcore.BandPilotDispatcher(
        cl, jcore.IntraHostTables(cl, sim), jcore.GroundTruthPredictor(sim)), range(8), 4)
    assert f"dispatched devices: {want}; mesh {{'data': 2, 'model': 2}}" in out
    assert out.count("training complete") == 1 and "step 2: loss=" in out


def test_launchers_want_the_card_unless_told():
    from repro_torch.launch import train as launch_train

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_elastic.main(["--quick"])


def _event_log(text):
    return text[text.index("event log:"):].split("\n\n")[0].splitlines()


@pytest.fixture(scope="module")
def reference_example(tmp_path_factory):
    """``examples/elastic_recovery.py`` run here; its printed output."""
    import io
    import contextlib
    import tempfile

    buf = io.StringIO()
    before = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("example"))
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / "elastic_recovery.py"),
                           run_name="elastic_recovery")["main"]()
    finally:
        tempfile.tempdir = before
    return buf.getvalue()


def test_launch_elastic_quick_flow_logs_the_reference_events(reference_example):
    out = _launch("repro_torch.launch.elastic", "--quick", "--device", "cpu")
    got, want = _event_log(out), _event_log(reference_example)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if "trained to step" in w:  # the port draws its own weights
            assert g.split("(loss")[0] == w.split("(loss")[0]
        else:
            assert g == w
    assert "restored checkpoint @ step 40" in out
    assert "recovered and completed all steps." in out


_FLOW = """
import numpy as np
from repro_torch.launch import elastic
from repro_torch.weights import from_jax_params

flow = elastic.quick_flow()
lm = from_jax_params(flow.cfg, inputs["params"], device="cpu")
out = elastic.run(flow, torch.device("cpu"), inputs["dir"], params=lm)
result = {k: out[k] for k in ("log", "history", "allocations", "saves", "recover", "opt_step")}
"""


def test_elastic_flow_from_the_reference_init_tracks_the_example(reference_example, tmp_path):
    """The example's weights (``init(PRNGKey(0))``) through the port's flow
    on one gloo rank: the same events, and the losses the example logs."""
    jcfg = JARCHS["gemma-7b"].reduced()
    params = jax.tree_util.tree_map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    (res,) = run_ranks(_FLOW, 1, tmp_path, inputs={"params": params,
                                                   "dir": str(tmp_path / "ck")})
    want = {int(s): float(v) for s, v in re.findall(r"step (\d+): loss=([\d.]+)",
                                                    reference_example)}
    got = {h["step"]: h["loss"] for h in res["history"]}
    assert sorted(got) == sorted(want) == [20, 40, 60, 80]
    for s in want:  # the example prints 4 decimals
        assert abs(got[s] - want[s]) <= FLOW_RTOL * want[s] + 5e-5, (s, got[s], want[s])
    events = [e["event"] for e in res["log"]]
    assert events == ["dispatch", "train", "redispatch", "train"]
    printed = _event_log(reference_example)
    assert f"dispatch: 16 GPUs, predicted B={res['log'][0]['bw']:.0f} GB/s" in printed[1]
    assert res["allocations"] == [res["log"][0]["alloc"], res["log"][2]["alloc"]]
    assert not set(res["log"][2]["alloc"]) & set(range(8, 16))
    assert res["opt_step"] == 80
    assert [s["step"] for s in res["saves"]] == list(range(10, 90, 10))
    assert set(res["recover"]) == {"redispatch_s", "mesh_s", "restore_s", "first_step_s",
                                   "total_s"}
