"""The port's dispatcher (``repro_torch.core``) against the JAX reference, on
the CPU.

Inputs come from numpy seeds; weights are the reference's pytrees carried
across with ``surrogate_from_jax_params``; the port runs with
``device="cpu"``.

Tolerances, all float32:
  * a surrogate apply (normalized log-bandwidth, values in about [0, 2]):
    ``APPLY_ATOL`` 2e-5 absolute -- six encoder layers and a 3-layer head
    summed in another order by the two frameworks (about 2e-6 is seen);
  * decoded GB/s: ``BW_RTOL`` 1e-4 relative -- decoding is
    ``expm1(5 y)``, so an absolute error e in y becomes a relative one of
    about 5e;
  * a fused descent's round scores against the port's own host loop:
    ``SCAN_RTOL`` 1e-5 relative -- the same model on the same channels in
    another batch shape; every elimination must be identical;
  * a training loss curve: ``LOSS_RTOL`` 2e-3 relative per step -- Adam
    divides by the root of small second moments, so float32 rounding
    differences in the early gradients are magnified step by step;
  * a trained model's test MAPE: within ``MAPE_POINTS`` 0.5 percentage
    points of the reference's from the same init and batches.
Searches and dispatches must choose the reference's subsets.
"""

import ast
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import features as jfeat
from repro.core import surrogate as jsurr
from repro.core import training as jtraining
from repro.core.tenancy import JobLedger as JJobLedger
from repro.train import optimizer as joptim
import repro_torch.core as core
from repro_torch.core import features as feat
from repro_torch.core import surrogate as surr
from repro_torch.core import training
from repro_torch.core.predict_cache import InferenceBatcher
from repro_torch.core.tenancy import JobLedger
from repro_torch.launch import dispatch as launch_dispatch
from repro_torch.weights import surrogate_from_jax_params, surrogate_to_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
APPLY_ATOL = 2e-5
BW_RTOL = 1e-4
SCAN_RTOL = 1e-5
LOSS_RTOL = 2e-3
MAPE_POINTS = 0.5
CLUSTERS = ["H100", "Het-4Mix", "Het-RA", "Het-VA"]
COPIED = ["cluster", "bandwidth_sim", "intra_host", "tenancy", "features", "telemetry",
          "predict_cache", "contention", "search", "baselines", "faults", "controlplane",
          "forensics", "defrag", "scheduler", "dispatcher", "contended_dataset", "__init__"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Stack:
    """One cluster built by both packages, with one set of weights."""

    def __init__(self, name):
        self.name = name
        self.jcl = jcore.PAPER_CLUSTERS[name]()
        self.jsim = jcore.BandwidthSimulator(self.jcl)
        self.jtables = jcore.IntraHostTables(self.jcl, self.jsim)
        self.cl = core.PAPER_CLUSTERS[name]()
        self.sim = core.BandwidthSimulator(self.cl)
        self.tables = core.IntraHostTables(self.cl, self.sim)
        self.jparams = _np_tree(jsurr.init_hierarchical_params(jax.random.PRNGKey(0)))
        self.params = surrogate_from_jax_params(self.jparams, device="cpu")
        # a contended model whose context embedding is not zero, so the
        # ledger channels reach the output
        jc = _np_tree(jsurr.init_contended_params(self.jparams))
        jc["ctx_embed"]["w"] = np.random.default_rng(5).normal(
            0.0, 0.3, jc["ctx_embed"]["w"].shape).astype(np.float32)
        self.jcparams = jc
        self.cparams = surrogate_from_jax_params(jc, device="cpu")

    def ledgers(self):
        """The same tenanted ledger in both packages."""
        cl = self.cl
        jobs = [("a", [0, 1, cl.hosts[1].gpu_ids[0]]),
                ("b", [cl.hosts[1].gpu_ids[1], cl.hosts[-1].gpu_ids[0]]),
                ("s", [cl.hosts[0].gpu_ids[5]])]
        jled, led = JJobLedger(self.jcl), JobLedger(self.cl)
        for job_id, gpus in jobs:
            jled.admit(job_id, gpus)
            led.admit(job_id, gpus)
        return jled, led


@pytest.fixture(scope="module", params=CLUSTERS)
def stack(request):
    return Stack(request.param)


@pytest.fixture(scope="module")
def stacks():
    return {}


def _get(stacks, name):
    if name not in stacks:
        stacks[name] = Stack(name)
    return stacks[name]


def _multi_host_subsets(cl, rng, n, exclude=()):
    pool = [g for g in range(cl.n_gpus) if g not in set(exclude)]
    out = []
    while len(out) < n:
        k = int(rng.integers(2, min(len(pool), 24) + 1))
        s = sorted(rng.choice(pool, size=k, replace=False).tolist())
        if len(cl.partition_by_host(s)) > 1:
            out.append(s)
    return out


_JIT = {}


def _jit(fn):
    """One jitted reference apply per function for the whole module."""
    return _JIT.setdefault(fn, jax.jit(fn))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The copies of the numpy core
# ---------------------------------------------------------------------------

def _code(path, rewrite, drop=()):
    """The module's code as an AST dump: docstrings dropped (the copies
    reword the reference's notes on its own history), ``repro.`` imports
    rewritten to ``repro_torch.`` when ``rewrite``, and the methods named
    in ``drop`` removed."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if rewrite and isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "repro":
            node.module = "repro_torch" + node.module[len("repro"):]
        if rewrite and isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "repro":
                    alias.name = "repro_torch" + alias.name[len("repro"):]
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = [n for n in node.body
                    if not (isinstance(n, ast.FunctionDef) and n.name in drop)]
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                body = body[1:]
            node.body = body or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIED)
def test_copies_match_reference(module):
    """Each copied module is the reference's code with its imports
    rewritten; the one named difference is ``InferenceBatcher._fuse``, which
    calls the torch apply on tensors on the parameters' device."""
    ref = ROOT / "src" / "repro" / "core" / f"{module}.py"
    port = ROOT / "src" / "repro_torch" / "core" / f"{module}.py"
    drop = ("_fuse",) if module == "predict_cache" else ()
    assert _code(port, False, drop) == _code(ref, True, drop)
    if module == "predict_cache":
        fuse = next(n for n in ast.walk(ast.parse(port.read_text()))
                    if isinstance(n, ast.FunctionDef) and n.name == "_fuse")
        names = {a.name for n in ast.walk(fuse) if isinstance(n, ast.Import) for a in n.names}
        assert names == {"torch"}


def test_public_names_match_reference():
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert hasattr(core, name), name


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_converter_round_trip(stack):
    for jtree, params in ((stack.jparams, stack.params), (stack.jcparams, stack.cparams)):
        back = surrogate_to_jax_params(params)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jtree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
            np.testing.assert_array_equal(a, b)
    assert surr.param_count(stack.params) == jsurr.param_count(stack.jparams)
    assert surr.param_bytes(stack.cparams) == jsurr.param_bytes(stack.jcparams)
    naive = _np_tree(jsurr.init_naive_params(jax.random.PRNGKey(1), stack.cl.n_gpus))
    assert surrogate_from_jax_params(naive, device="cpu").variant == "naive"


def test_applies_match_reference(stack):
    """All three applies on the reference featurizers' outputs: normalized
    outputs within APPLY_ATOL, GB/s within BW_RTOL. The port's copied
    featurizers give the same arrays."""
    rng = np.random.default_rng(1)
    subsets = _multi_host_subsets(stack.cl, rng, 256)
    jx, jm = jfeat.featurize_batch(stack.jcl, stack.jtables, subsets)
    x, m = feat.featurize_batch(stack.cl, stack.tables, subsets)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(m, jm)
    ref = np.asarray(_jit(jsurr.apply_hierarchical)(stack.jparams, jx, jm))
    got = surr.apply_hierarchical(stack.params, _t(x), _t(m)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=APPLY_ATOL)
    ref_bw = np.asarray(jsurr._apply_hierarchical_bw(stack.jparams, jx, jm))
    got_bw = surr._apply_hierarchical_bw(stack.params, _t(x), _t(m)).numpy()
    np.testing.assert_allclose(got_bw, ref_bw, rtol=BW_RTOL)

    jled, led = stack.ledgers()
    free = _multi_host_subsets(stack.cl, rng, 128, exclude=led.busy())
    jcx, jcm = jfeat.featurize_contended_batch(
        stack.jcl, stack.jtables, [(s, jled) for s in free] + [(s, None) for s in free[:32]])
    cx, cm = feat.featurize_contended_batch(
        stack.cl, stack.tables, [(s, led) for s in free] + [(s, None) for s in free[:32]])
    np.testing.assert_array_equal(cx, jcx)
    assert np.abs(cx[..., feat.N_FEATURES:]).sum() > 0  # the context reaches the model
    ref = np.asarray(_jit(jsurr.apply_contended)(stack.jcparams, jcx, jcm))
    got = surr.apply_contended(stack.cparams, _t(cx), _t(cm)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=APPLY_ATOL)

    jnaive = _np_tree(jsurr.init_naive_params(jax.random.PRNGKey(2), stack.cl.n_gpus))
    naive = surrogate_from_jax_params(jnaive, device="cpu")
    ids, im = jfeat.featurize_gpu_ids(stack.jcl, subsets, stack.cl.n_gpus)
    ref = np.asarray(_jit(jsurr.apply_naive)(jnaive, ids, im))
    got = surr.apply_naive(naive, _t(ids), _t(im)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=APPLY_ATOL)


def test_init_statistics_and_contended_warm_start():
    """Random init cannot match JAX's bits; it keeps the reference's shapes
    and rules: embed row N_FEATURES-1 zero, the contended init the base
    model plus a zero context embedding."""
    gen = torch.Generator().manual_seed(0)
    p = surr.init_hierarchical_params(gen, device="cpu")
    assert set(p.state_dict()) == set(
        surrogate_from_jax_params(_np_tree(jsurr.init_hierarchical_params(
            jax.random.PRNGKey(0))), device="cpu").state_dict())
    assert torch.all(p.embed.w[feat.N_FEATURES - 1] == 0)
    assert torch.all(p.embed.w[: feat.N_FEATURES - 1] != 0)
    w = p.trunk.layers[0].ff2.w.detach()
    assert abs(float(w.std()) - 1 / np.sqrt(w.shape[0])) < 0.2 / np.sqrt(w.shape[0])
    c = surr.init_contended_params(p)
    assert torch.all(c.ctx_embed.w == 0)
    x = torch.rand(4, 4, feat.N_FEATURES)
    m = torch.ones(4, 4)
    ctx = torch.cat([x, torch.zeros(4, 4, feat.N_LEDGER_FEATURES)], dim=-1)
    torch.testing.assert_close(surr.apply_contended(c, ctx, m),
                               surr.apply_hierarchical(p, x, m), rtol=0, atol=0)
    q = surr.init_hierarchical_params(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(p.parameters(), q.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Predictors
# ---------------------------------------------------------------------------

def test_predictors_match_reference(stack):
    rng = np.random.default_rng(2)
    jpred = jcore.SurrogatePredictor(stack.jcl, stack.jtables, stack.jparams)
    pred = core.SurrogatePredictor(stack.cl, stack.tables, stack.params)
    subsets = _multi_host_subsets(stack.cl, rng, 40) + [list(stack.cl.hosts[0].gpu_ids[:3])]
    np.testing.assert_allclose(pred.predict(subsets), jpred.predict(subsets), rtol=BW_RTOL)
    assert pred.stats.n_model_calls == jpred.stats.n_model_calls == 40
    for f in ("predict_seconds", "featurize_seconds", "infer_seconds"):
        assert getattr(pred.stats, f) > 0, f
    parent = _multi_host_subsets(stack.cl, rng, 1)[0]
    np.testing.assert_allclose(pred.predict_children(parent),
                               jpred.predict_children(parent), rtol=BW_RTOL)
    # the loop featurizer and the naive model
    slow = core.SurrogatePredictor(stack.cl, stack.tables, stack.params, vectorized=False)
    np.testing.assert_allclose(slow.predict(subsets), jpred.predict(subsets), rtol=BW_RTOL)
    jnaive = _np_tree(jsurr.init_naive_params(jax.random.PRNGKey(2), stack.cl.n_gpus))
    naive = surrogate_from_jax_params(jnaive, device="cpu")
    np.testing.assert_allclose(
        core.SurrogatePredictor(stack.cl, stack.tables, naive, naive=True).predict(subsets),
        jcore.SurrogatePredictor(stack.jcl, stack.jtables, jnaive, naive=True).predict(subsets),
        rtol=BW_RTOL)

    jled, led = stack.ledgers()
    jcpred = jcore.ContendedSurrogatePredictor(stack.jcl, stack.jtables, stack.jcparams)
    cpred = core.ContendedSurrogatePredictor(stack.cl, stack.tables, stack.cparams)
    free = _multi_host_subsets(stack.cl, rng, 24, exclude=led.busy())
    jpairs = [(s, jled if i % 2 else None) for i, s in enumerate(free)]
    pairs = [(s, led if i % 2 else None) for i, s in enumerate(free)]
    np.testing.assert_allclose(cpred.predict_pairs(pairs), jcpred.predict_pairs(jpairs),
                               rtol=BW_RTOL)
    np.testing.assert_allclose(cpred.predict(free, led), jcpred.predict(free, jled),
                               rtol=BW_RTOL)
    assert cpred.predict_one(free[0], led) == pytest.approx(
        jcpred.predict_one(free[0], jled), rel=BW_RTOL)


def test_inference_batcher_matches_solo_apply(stacks):
    """Four threads fuse their applies through the batcher; each gets its
    own rows, equal to a solo apply within APPLY_ATOL (padding changes the
    batch shape, so not bit for bit)."""
    st = _get(stacks, "H100")
    rng = np.random.default_rng(3)
    reqs = []
    for b in (3, 5, 8, 1):
        x, m = feat.featurize_batch(st.cl, st.tables, _multi_host_subsets(st.cl, rng, b))
        t = int(rng.integers(2, 5))
        reqs.append((x[:, :t], m[:, :t]))
    solo = [surr._apply_np(surr._apply_hierarchical_bw, st.params, x, m) for x, m in reqs]
    batcher = InferenceBatcher(wait_timeout=5.0)
    out = [None] * len(reqs)
    go = threading.Barrier(len(reqs))

    def work(i):
        with batcher.worker():
            go.wait(timeout=30)
            out[i] = batcher.apply(surr._apply_hierarchical_bw, st.params, *reqs[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert batcher.n_requests == 4 and batcher.n_fused_applies < 4
    for got, want in zip(out, solo):
        np.testing.assert_allclose(got, want, rtol=BW_RTOL)
    # a predictor inside a worker block routes through the batcher
    pred = core.SurrogatePredictor(st.cl, st.tables, st.params)
    subsets = _multi_host_subsets(st.cl, rng, 6)
    with batcher.worker():
        fused = pred.predict(subsets)
    assert batcher.n_requests == 5
    np.testing.assert_allclose(fused, core.SurrogatePredictor(
        st.cl, st.tables, st.params).predict(subsets), rtol=BW_RTOL)


# ---------------------------------------------------------------------------
# The fused descent
# ---------------------------------------------------------------------------

def _audit_descent(predictor, res, parent, k):
    """Replay the host elimination loop round by round against a
    ScanResult: scores within SCAN_RTOL at every live slot, the same
    elimination every round."""
    parent = sorted(parent)
    s = list(parent)
    assert res.n_rounds == len(parent) - k
    for r in range(res.n_rounds):
        live = np.nonzero(res.sels[r])[0]
        assert [parent[i] for i in live] == s
        children = [s[:i] + s[i + 1:] for i in range(len(s))]
        host32 = np.float32(predictor.predict(children))
        np.testing.assert_allclose(res.scores[r][live], host32, rtol=SCAN_RTOL)
        j = int(np.argmax(host32))
        assert res.elims[r] == live[j]
        s.pop(j)
    assert res.subset == s and len(s) == k


def _host_descent(predictor, parent, k):
    """The host elimination loop of ``pts_search`` (the ``use_scan=False``
    path): one fused child round a step, first-wins argmax."""
    s = sorted(parent)
    while len(s) > k:
        j = int(np.argmax(predictor.predict_children(s)))
        s = s[:j] + s[j + 1:]
    return s


def _agrees_with_reference(res, ref):
    """The port's descent makes the reference's eliminations; where a round
    differs, the reference's own scores there are a near-tie (the port's
    pick within BW_RTOL of the reference's best), and the descents part
    ways from then on. Returns whether the subsets are equal."""
    assert res.n_rounds == ref.n_rounds
    for r in range(res.n_rounds):
        np.testing.assert_array_equal(res.sels[r], ref.sels[r])
        if res.elims[r] != ref.elims[r]:
            best = ref.scores[r][ref.elims[r]]
            assert ref.scores[r][res.elims[r]] >= best * (1 - BW_RTOL), (r, res.elims[r], ref.elims[r])
            return False
    assert res.subset == ref.subset
    return True


def test_descent_audit_isolated(stack):
    jpred = jcore.SurrogatePredictor(stack.jcl, stack.jtables, stack.jparams)
    pred = core.SurrogatePredictor(stack.cl, stack.tables, stack.params)
    rng = np.random.default_rng(10)
    same = 0
    for n0, k in ((12, 6), (20, 10), (9, 2), (32, 16)):
        parent = sorted(rng.choice(stack.cl.n_gpus, size=n0, replace=False).tolist())
        res = pred.eliminate_to(parent, k)
        assert res is not None and res.n_capped == 0
        _audit_descent(pred, res, parent, k)
        same += _agrees_with_reference(res, jpred.eliminate_to(parent, k))
        off = core.SurrogatePredictor(stack.cl, stack.tables, stack.params, use_scan=False)
        assert off.eliminate_to(parent, k) is None
        assert _host_descent(off, parent, k) == res.subset
    assert same >= 2  # near-ties are the exception
    assert pred.n_descents >= 3 and pred.n_graph_replays == 0  # eager on the CPU
    assert pred.warm_scan() == 0.0


def test_descent_audit_contended(stack):
    """Through the analytic contention wrapper: the cap table is gathered in
    every round and the scores match the host's min(iso, cap). The head's
    output bias is raised by 1.2 (about 400 GB/s at init, where the random
    init predicts about 2) so that the caps bind."""
    jled, led = stack.ledgers()
    jparams = jax.tree_util.tree_map(np.copy, stack.jparams)
    jparams["trunk"]["head"][2]["b"] += np.float32(1.2)
    params = surrogate_from_jax_params(jparams, device="cpu")
    jpred = jcore.SurrogatePredictor(stack.jcl, stack.jtables, jparams)
    jwrapped = jcore.ContentionAwarePredictor(stack.jcl, jpred, jled)
    pred = core.SurrogatePredictor(stack.cl, stack.tables, params)
    wrapped = core.ContentionAwarePredictor(stack.cl, pred, led)
    off = core.ContentionAwarePredictor(stack.cl, core.SurrogatePredictor(
        stack.cl, stack.tables, params, use_scan=False), led)
    rng = np.random.default_rng(11)
    capped = same = 0
    for n0, k in ((14, 7), (10, 4), (24, 8)):
        parent = sorted(rng.choice(sorted(set(range(stack.cl.n_gpus)) - led.busy()),
                                   size=n0, replace=False).tolist())
        before = wrapped.stats.n_capped
        res = wrapped.eliminate_to(parent, k)
        assert res is not None
        assert wrapped.stats.n_capped == before + res.n_capped
        capped += res.n_capped
        _audit_descent(wrapped, res, parent, k)
        same += _agrees_with_reference(res, jwrapped.eliminate_to(parent, k))
        assert _host_descent(off, parent, k) == res.subset
    assert capped > 0  # the cap table was gathered and it bound
    assert same >= 2  # near-ties are the exception


def test_descent_declines_out_of_envelope(stacks):
    st = _get(stacks, "H100")
    pred = core.SurrogatePredictor(st.cl, st.tables, st.params)
    h0 = list(st.cl.hosts[0].gpu_ids[:6])
    assert pred.eliminate_to(h0, 3) is None                       # single-host parent
    assert pred.eliminate_to([0, st.cl.hosts[1].gpu_ids[0]], 2) is None  # n0 <= k
    assert pred.eliminate_to(list(range(12)), 0) is None          # k < 1
    parent = list(range(4)) + list(range(8, 12))
    assert core.SurrogatePredictor(st.cl, st.tables, st.params,
                                   use_scan=False).eliminate_to(parent, 4) is None
    assert core.SurrogatePredictor(st.cl, st.tables, st.params,
                                   vectorized=False).eliminate_to(parent, 4) is None
    # 9 hosts of 8: a cap lattice of 9**9 points, past the table bound
    big = core.Cluster([("H100", 9)], name="H100x9")
    btables = core.IntraHostTables(big, core.BandwidthSimulator(big))
    bpred = core.SurrogatePredictor(big, btables, st.params)
    assert bpred._scan_envelope() is None
    assert bpred.eliminate_to(list(range(20)), 8) is None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _reference_curve(apply_fn, params, x, mask, y, cfg):
    """The reference's ``_fit`` loop, written out so that every step's loss
    can be read (``_fit`` returns only the last)."""
    n = int(x.shape[0])
    opt_init, opt_update = joptim.adamw(
        joptim.AdamWConfig(lr=cfg.lr, weight_decay=cfg.weight_decay, grad_clip_norm=1.0),
        joptim.cosine_schedule(cfg.steps, cfg.warmup_steps))
    state = opt_init(params)

    @jax.jit
    def step(params, state, idx):
        loss, grads = jax.value_and_grad(
            lambda p: jtraining._mse_loss(apply_fn, p, x[idx], mask[idx], y[idx]))(params)
        params, state, _ = opt_update(grads, state, params)
        return params, state, loss

    rng = np.random.default_rng(cfg.seed)
    losses = []
    for _ in range(cfg.steps):
        idx = jnp.asarray(rng.integers(0, n, size=min(cfg.batch_size, n)))
        params, state, loss = step(params, state, idx)
        losses.append(float(loss))
    return params, np.asarray(losses)


def test_fit_tracks_reference_loss_curve(stacks):
    st = _get(stacks, "Het-4Mix")
    train, _ = jcore.make_train_test_split(st.jsim, 96, seed=0)
    subsets = [list(s) for s, _ in train]
    x, m = jfeat.featurize_batch(st.jcl, st.jtables, subsets)
    y = np.asarray(jsurr.encode_bw(np.asarray([bw for _, bw in train], np.float32)))
    cfg = jtraining.TrainConfig(steps=25, batch_size=32, warmup_steps=5, seed=3)
    jx, jm, jy = jnp.asarray(x), jnp.asarray(m), jnp.asarray(y)
    mirror, curve = _reference_curve(jsurr.apply_hierarchical, st.jparams, jx, jm, jy, cfg)
    ref_params, ref_info = jtraining._fit(jsurr.apply_hierarchical, st.jparams, jx, jm, jy, cfg)
    assert ref_info["final_loss"] == curve[-1]  # the written-out loop is the reference's
    for a, b in zip(jax.tree_util.tree_leaves(mirror), jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    params, info = training._fit(surr.apply_hierarchical, st.params, _t(x), _t(m), _t(y), cfg)
    np.testing.assert_allclose(info["loss_curve"], curve, rtol=LOSS_RTOL)
    assert info["final_loss"] == pytest.approx(ref_info["final_loss"], rel=LOSS_RTOL)
    assert info["param_bytes"] == jsurr.param_bytes(ref_params)
    # the init it started from is unchanged: a trainer returns a new model
    for a, b in zip(st.params.state_dict().values(),
                    surrogate_from_jax_params(st.jparams, device="cpu").state_dict().values()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def trained(stacks):
    """The reference and the port trained from the same init on the same
    H100 samples for the same short schedule."""
    st = _get(stacks, "H100")
    train, test = jcore.make_train_test_split(st.jsim, 128, seed=0)
    cfg = jtraining.TrainConfig(steps=100, seed=0)
    jparams, _ = jcore.train_surrogate(st.jcl, st.jtables, train, cfg, init_params=st.jparams)
    params, info = core.train_surrogate(st.cl, st.tables, train, cfg,
                                        init_params=st.params, device="cpu")
    return st, test, _np_tree(jparams), params, info


def test_trained_mape_matches_reference(trained):
    st, test, jparams, params, info = trained
    ref = jcore.evaluate_surrogate(jcore.SurrogatePredictor(st.jcl, st.jtables, jparams), test)
    got = core.evaluate_surrogate(core.SurrogatePredictor(st.cl, st.tables, params), test)
    assert abs(got["mape"] - ref["mape"]) < MAPE_POINTS, (got, ref)
    assert abs(got["r2"] - ref["r2"]) < 0.01
    assert got["mape"] < 30.0 and info["final_loss"] < 0.01
    # the reference scores a model the port trained: the same predictions
    back = surrogate_to_jax_params(params)
    np.testing.assert_allclose(
        jcore.SurrogatePredictor(st.jcl, st.jtables, back).predict([s for s, _ in test]),
        core.SurrogatePredictor(st.cl, st.tables, params).predict([s for s, _ in test]),
        rtol=BW_RTOL)


def test_contended_training_and_finetunes_match_reference(stacks):
    st = _get(stacks, "H100")
    rng = np.random.default_rng(4)
    jled, led = st.ledgers()
    free = _multi_host_subsets(st.cl, rng, 48, exclude=led.busy())
    jtrip = [(s, jled if i % 2 else None, st.jsim.true_bandwidth(s, ledger=jled if i % 2 else None))
             for i, s in enumerate(free)]
    trip = [(s, led if i % 2 else None, bw) for (s, _, bw), i in zip(jtrip, range(len(jtrip)))]
    cfg = jtraining.TrainConfig(steps=30, batch_size=16, seed=2)
    jc, jinfo = jcore.train_contended_surrogate(st.jcl, st.jtables, jtrip, cfg,
                                                base_params=st.jparams)
    c, info = core.train_contended_surrogate(st.cl, st.tables, trip, cfg,
                                             base_params=st.params, device="cpu")
    assert info["final_loss"] == pytest.approx(jinfo["final_loss"], rel=LOSS_RTOL)
    ref = jcore.evaluate_contended_predictor(
        jcore.ContendedSurrogatePredictor(st.jcl, st.jtables, _np_tree(jc)), jtrip)
    got = core.evaluate_contended_predictor(
        core.ContendedSurrogatePredictor(st.cl, st.tables, c), trip)
    assert got["mape"] == pytest.approx(ref["mape"], abs=MAPE_POINTS)
    # the fine-tunes run where the params live and return new models
    tuned = core.online_finetune_contended(st.cl, st.tables, c, trip[:8], steps=3)
    assert tuned is not c and tuned.device.type == "cpu" and tuned.variant == "contended"
    assert not torch.equal(tuned.ctx_embed.w, c.ctx_embed.w)
    iso = core.online_finetune(st.cl, st.tables, st.params,
                               [(s, bw) for s, led, bw in trip[:8] if led is None], steps=3)
    assert iso is not st.params and iso.variant == "hierarchical"
    preds, acc = core.evaluate_analytic_cap(
        st.cl, core.SurrogatePredictor(st.cl, st.tables, st.params), trip)
    jpreds, jacc = jcore.evaluate_analytic_cap(
        st.jcl, jcore.SurrogatePredictor(st.jcl, st.jtables, st.jparams), jtrip)
    np.testing.assert_allclose(preds, jpreds, rtol=BW_RTOL)


def test_entry_points_want_the_card_unless_told(stacks):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    st = _get(stacks, "H100")
    train = [([0, 8], 100.0), ([1, 9, 17], 80.0)]
    with pytest.raises(RuntimeError, match="cuda"):
        core.train_surrogate(st.cl, st.tables, train, core.TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="cuda"):
        core.train_contended_surrogate(st.cl, st.tables, [([0, 8], None, 100.0)],
                                       core.TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="cuda"):
        surrogate_from_jax_params(st.jparams)
    with pytest.raises(RuntimeError, match="cuda"):
        surr.init_hierarchical_params(torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        launch_dispatch.main(["--quick"])


# ---------------------------------------------------------------------------
# End to end: Fig. 1, the pinned trace golden, the launcher
# ---------------------------------------------------------------------------

def test_fig1_scenario_matches_reference(trained):
    st, _, jparams, params, _ = trained
    avail = list(range(0, 6)) + list(range(8, 14))
    jbp = jcore.BandPilotDispatcher(st.jcl, st.jtables,
                                    jcore.SurrogatePredictor(st.jcl, st.jtables, jparams))
    ref_params = surrogate_from_jax_params(jparams, device="cpu")
    for p in (ref_params, params):
        bp = core.BandPilotDispatcher(st.cl, st.tables,
                                      core.SurrogatePredictor(st.cl, st.tables, p))
        s = bp.dispatch(avail, 8)
        assert s == jbp.dispatch(avail, 8)
        assert sorted(len(v) for v in st.cl.partition_by_host(s).values()) == [4, 4]
        topo = core.BaselineDispatcher(st.cl, "topo").dispatch(avail, 8)
        assert st.sim.true_bandwidth(s) > st.sim.true_bandwidth(topo)


def _dispatch_log(package, cl, sim, tables, pred, trace, **disp_kw):
    disp = package.BandPilotDispatcher(cl, tables, pred, **disp_kw)
    log = []
    orig = package.BandPilotDispatcher.dispatch

    def wrapped(self, avail, k, rng=None):
        s = orig(self, avail, k, rng=rng)
        log.append(tuple(s))
        return s

    disp.dispatch = wrapped.__get__(disp)
    recs = package.AdmissionScheduler(cl, sim, tables, disp).run(trace)
    return log, recs


@pytest.mark.parametrize("name", ["H100", "Het-4Mix"])
def test_trace_golden_matches_reference(stacks, name):
    """The pinned 14-job fifo trace (the reference's fast-path golden
    settings): the port's dispatch log and records equal the reference's."""
    st = _get(stacks, name)
    jtrace = jcore.poisson_trace(st.jcl, 14, np.random.default_rng(7), mean_interarrival=1.0,
                                 mean_duration=6.0, k_choices=range(4, st.cl.n_gpus // 2 + 1))
    trace = core.poisson_trace(st.cl, 14, np.random.default_rng(7), mean_interarrival=1.0,
                               mean_duration=6.0, k_choices=range(4, st.cl.n_gpus // 2 + 1))
    assert [(j.job_id, j.arrival, j.duration, j.k) for j in trace] == \
        [(j.job_id, j.arrival, j.duration, j.k) for j in jtrace]
    jlog, jrecs = _dispatch_log(jcore, st.jcl, st.jsim, st.jtables,
                                jcore.SurrogatePredictor(st.jcl, st.jtables, st.jparams), jtrace)
    pred = core.SurrogatePredictor(st.cl, st.tables, st.params)
    log, recs = _dispatch_log(core, st.cl, st.sim, st.tables, pred, trace)
    assert log == jlog
    assert [(r.job_id, r.t_admit, r.bw, r.gbe) for r in recs] == \
        [(r.job_id, r.t_admit, r.bw, r.gbe) for r in jrecs]
    assert pred.n_descents > 0  # the fused descent ran on the path
    # and the host loop (use_scan=False) chooses the same
    off = core.SurrogatePredictor(st.cl, st.tables, st.params, use_scan=False)
    assert _dispatch_log(core, st.cl, st.sim, st.tables, off, trace)[0] == log


def test_learned_mode_trace_matches_reference(stacks):
    """Learned contention on the hot path: the contended surrogate scores
    candidates under a contended ledger (the descent declines there)."""
    st = _get(stacks, "H100")
    jtrace = jcore.poisson_trace(st.jcl, 10, np.random.default_rng(9), mean_duration=6.0,
                                 k_choices=range(4, st.cl.n_gpus // 2 + 1))
    trace = core.poisson_trace(st.cl, 10, np.random.default_rng(9), mean_duration=6.0,
                               k_choices=range(4, st.cl.n_gpus // 2 + 1))
    jlog, _ = _dispatch_log(
        jcore, st.jcl, st.jsim, st.jtables,
        jcore.SurrogatePredictor(st.jcl, st.jtables, st.jparams), jtrace,
        contention_mode="learned",
        contended_predictor=jcore.ContendedSurrogatePredictor(st.jcl, st.jtables, st.jcparams))
    log, _ = _dispatch_log(
        core, st.cl, st.sim, st.tables,
        core.SurrogatePredictor(st.cl, st.tables, st.params), trace,
        contention_mode="learned",
        contended_predictor=core.ContendedSurrogatePredictor(st.cl, st.tables, st.cparams))
    assert log == jlog


def test_launch_dispatch_on_the_cpu():
    out = launch_dispatch.main(["--quick", "--device", "cpu", "--trace-jobs", "6"])
    assert out["device"] == "cpu"
    assert out["accuracy"]["mape"] < 50.0
    assert out["mean_gbe"]["BandPilot"] >= out["mean_gbe"]["Random"]
    assert set(out["trace"]) == {"BandPilot", "BandPilot-oblivious", "Topo", "Default", "Random"}


@pytest.mark.parametrize("policy", ["backfill", "batched"])
def test_policies_and_replay_decision_on_the_port(stacks, tmp_path, policy):
    """The scheduler-policies flow on the port's surrogate (joint batched
    placement with the inference batcher; the ledger journal): the same
    admissions as the reference's with the same weights, and every
    journaled admission replays to the same subset (forensics
    ``replay_decision``)."""
    st = _get(stacks, "H100")
    cfg = dict(policy=policy, batch_window=2.0 if policy == "batched" else 0.0,
               batch_applies=policy == "batched")
    jtrace = jcore.poisson_trace(st.jcl, 12, np.random.default_rng(0), mean_duration=8.0,
                                 k_choices=range(4, 17))
    trace = core.poisson_trace(st.cl, 12, np.random.default_rng(0), mean_duration=8.0,
                               k_choices=range(4, 17))
    jsched = jcore.compare_policies(
        st.jcl, st.jsim, st.jtables,
        lambda: jcore.BandPilotDispatcher(
            st.jcl, st.jtables, jcore.SurrogatePredictor(st.jcl, st.jtables, st.jparams)),
        jtrace, configs={policy: jcore.SchedulerConfig(**cfg)})[policy]
    path = tmp_path / "journal.jsonl"
    sched = core.compare_policies(
        st.cl, st.sim, st.tables,
        lambda: core.BandPilotDispatcher(
            st.cl, st.tables, core.SurrogatePredictor(st.cl, st.tables, st.params)),
        trace, configs={policy: core.SchedulerConfig(journal_path=str(path), **cfg)})[policy]
    assert [(r.job_id, r.t_admit, r.bw, r.gbe, r.batch_size) for r in sched.records] == \
        [(r.job_id, r.t_admit, r.bw, r.gbe, r.batch_size) for r in jsched.records]
    disp = core.BandPilotDispatcher(st.cl, st.tables,
                                    core.SurrogatePredictor(st.cl, st.tables, st.params))
    admits = [e for e in core.read_journal(path) if e.op == "admit"]
    assert len(admits) == len(trace)
    for e in admits:
        assert core.replay_decision(path, e.seq, disp).identical
