"""The port's training path vs the JAX reference, on the CPU at reduced sizes.

Every case feeds the same seeded numpy inputs (parameters drawn in the
reference's pytree layout and carried across with ``from_jax_params``)
through the reference and the port. Gradients come back from the reference
as a pytree of the same layout and are keyed by state-dict name with
``jax_params_to_state_dict``.

Tolerances, all fp32 unless said:
  * single ops (optimizer update, scan and attention VJPs, WKV gradients):
    1e-5 -- both sides compute in fp32, only the order of sums differs;
  * a whole model: the loss within 1e-5 of itself, and each parameter's
    gradient within 2e-5 of the largest magnitude of the reference's
    gradient for that parameter (fp32 error accumulated over every layer,
    forward and backward; about 1.3e-6 is seen);
  * bf16 compute: 1e-3 on the loss and 5e-2 per parameter, relative to its
    largest gradient -- the two frameworks round activations to bf16 at
    different places, one bf16 ulp (2^-8) each, over several layers (about
    2.4e-2 is seen);
  * bf16 scan outputs: one bf16 ulp, 2e-2 * (1 + |x|).
Remat policies must give gradients identical to no remat: the recompute
runs the same operations on the same inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.rglru import ops as jlru_ops
from repro.kernels.rglru.rglru import rglru_scan as jrglru_scan
from repro.kernels.rwkv6 import ref as jwkv_ref
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.models.model_zoo import build_model as jbuild_model
from repro.train import optimizer as joptim
from repro.train.train_loop import TrainRunConfig as JTrainRunConfig
from repro.train.train_loop import train_loop as jtrain_loop
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref
from repro_torch.launch import train_lm
from repro_torch.launch.perf import stray_knobs
from repro_torch.models import common
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import LM, lm_loss
from repro_torch.train import optimizer
from repro_torch.train import train_loop as train_loop_mod
from repro_torch.train.train_loop import TrainRunConfig, make_train_step, train_loop
from repro_torch.weights import from_jax_params, init_params, jax_params_to_state_dict

# a knob left set would change the plain reference the port is held to
assert not stray_knobs(), f"unset {stray_knobs()} to run these tests"

OP_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
BF16_LOSS_TOL = 1e-3
BF16_GRAD_TOL = 5e-2
PORTED = ["recurrentgemma-9b", "gemma2-9b", "rwkv6-7b"]
REMAT_POLICIES = ["nothing", "dots", "dots_with_no_batch_dims"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


def _numpy_params(jcfg, seed):
    """A parameter pytree in the reference's layout, drawn with numpy (the
    layout from ``eval_shape`` of the reference's init, nothing compiled)."""
    shapes = jax.eval_shape(lambda k: jtransformer.init_lm_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * (0.05 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(port config, jax model, numpy params) for a reduced arch."""
    jcfg = JARCHS[name].reduced()
    return ARCHS[name].reduced(), jbuild_model(jcfg), _numpy_params(jcfg, seed=1)


def _batch(cfg, B=2, S=48, seed=0, mask=False):
    """Tokens past the reduced window (32), so the local mask is exercised."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def _port_loss_and_grads(cfg, np_params, batch, **kw):
    lm = from_jax_params(cfg, np_params, device="cpu")
    lm.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = build_model(cfg, device="cpu").loss(lm, tb, **kw)
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in lm.named_parameters()])
    return loss.detach(), metrics, dict(zip(names, grads))


def _reference_loss_and_grads(cfg, jmodel, np_params, batch, compute_dtype=None,
                              remat_policy="nothing"):
    """(loss, gradients keyed by state-dict name, metrics as floats)."""
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, backend="reference", remat_policy=remat_policy,
                              compute_dtype=compute_dtype), has_aux=True)(jparams)
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)
    return (float(loss), jax_params_to_state_dict(cfg, grads),
            {k: float(v) for k, v in metrics.items()})


def _assert_grads_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        scale = float(g.abs().max())
        err = float((got[name].float() - g).abs().max())
        assert err <= tol * max(scale, 1e-12), (name, err, scale)


# ---------------------------------------------------------------------------
# Optimizer and schedules
# ---------------------------------------------------------------------------

def test_adamw_matches_reference():
    """Five updates with the clip active and weight decay on every leaf
    (matrix, norm vector, bias, and a leaf above ``SMALL_LEAF``, which takes
    the one-tensor-at-a-time path) against ``repro.train.optimizer.adamw``."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "norm": (5,), "bias": (3,), "big": (300, 256)}
    assert 300 * 256 > optimizer.SMALL_LEAF
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip_norm=1.0)
    jinit, jupdate = joptim.adamw(joptim.AdamWConfig(**cfg),
                                  joptim.cosine_schedule(8, 2, 0.1))
    init, update = optimizer.adamw(optimizer.AdamWConfig(**cfg),
                                   optimizer.cosine_schedule(8, 2, 0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jinit(jp)
    tp = {k: _t(v) for k, v in params.items()}
    state = init(tp)
    for g in grads:
        jp, jstate, jm = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        tp, state, m = update({k: _t(v) for k, v in g.items()}, state, tp)
        assert float(jm["grad_norm"]) > 1.0  # the clip is active
        _close(m["grad_norm"], jm["grad_norm"], OP_TOL)
        assert abs(m["lr"] - float(jm["lr"])) <= OP_TOL * float(jm["lr"])
        assert state.step == int(jstate.step)
        for k in shapes:
            _close(tp[k], jp[k], OP_TOL)
            _close(state.mu[k], jstate.mu[k], OP_TOL)
            _close(state.nu[k], jstate.nu[k], OP_TOL)


@pytest.mark.parametrize("total,warmup,final_frac", [(10, 0, 0.0), (20, 5, 0.1), (7, 7, 0.0)])
def test_cosine_schedule_matches_reference(total, warmup, final_frac):
    fn = optimizer.cosine_schedule(total, warmup, final_frac)
    jfn = joptim.cosine_schedule(total, warmup, final_frac)
    for step in range(total + 3):
        assert abs(fn(step) - float(jfn(jnp.asarray(step)))) < 1e-6, step
    assert optimizer.constant_schedule()(5) == float(joptim.constant_schedule()(jnp.asarray(5)))


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "big": rng.standard_normal((300, 256)).astype(np.float32)}
    jclipped, jnorm = joptim.clip_by_global_norm(tree, 0.5)
    clipped, norm = optimizer.clip_by_global_norm({k: _t(v) for k, v in tree.items()}, 0.5)
    _close(norm, jnorm, OP_TOL)
    _close(optimizer.global_norm(clipped), 0.5, OP_TOL)
    for k in tree:
        _close(clipped[k], jclipped[k], OP_TOL)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2)])
def test_synthetic_lm_batches_are_the_reference_bit_for_bit(host_id, n_hosts):
    cfg = dict(vocab_size=1000, seq_len=37, global_batch=4, seed=5)
    data, jdata = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
    for got, want in zip(data.batches(3, start=2, host_id=host_id, n_hosts=n_hosts),
                         jdata.batches(3, start=2, host_id=host_id, n_hosts=n_hosts)):
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Kernel ops' backward passes
# ---------------------------------------------------------------------------

SCAN_CASES = [
    # backend, a dtype, with h0
    ("reference", "float32", True),
    ("reference", "float32", False),
    ("interpret", "float32", True),
    ("reference", "bfloat16", True),
    ("interpret", "bfloat16", False),
]
_DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("backend,dt,with_h0", SCAN_CASES)
def test_scan_function_vjp_matches_reference(backend, dt, with_h0):
    """da, db, dh0 of ``linear_scan`` against the reference's custom VJP. In
    bf16 the backward's scan call has a bf16 decay and the fp32 upstream
    gradient, and rounds g to bf16, as the reference does."""
    tdt, jdt = _DT[dt]
    B, T, C = 2, 37, 24
    rng = np.random.default_rng(7)
    a = (0.7 + 0.299 * rng.random((B, T, C))).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, T, C))).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, C))).astype(np.float32)
    dh = rng.standard_normal((B, T, C)).astype(np.float32)
    dhn = rng.standard_normal((B, C)).astype(np.float32)

    ja, jb, jh0 = (jnp.asarray(x, jdt) for x in (a, b, h0))
    args = (ja, jb, jh0) if with_h0 else (ja, jb)
    (jh, jhn), vjp = jax.vjp(lambda *xs: jlru_ops.linear_scan(*xs, backend=backend), *args)
    jgrads = vjp((jnp.asarray(dh, jh.dtype), jnp.asarray(dhn, jhn.dtype)))

    ta, tb, th0 = (_t(x, tdt).requires_grad_() for x in (a, b, h0))
    targs = (ta, tb, th0) if with_h0 else (ta, tb)
    h, hn = lru_ops.linear_scan(*targs)
    assert type(h.grad_fn).__name__ == "_LinearScanBackward"
    # cotangents in the outputs' dtypes, as the reference's are
    tgrads = torch.autograd.grad((h, hn), targs, (_t(jnp.asarray(dh, jh.dtype), h.dtype),
                                                  _t(jnp.asarray(dhn, jhn.dtype), hn.dtype)))
    tol = OP_TOL if dt == "float32" else 2e-2
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == tdt
        w = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, atol=tol * (1 + np.abs(w)).max(),
                                   rtol=tol)


def test_scan_takes_bf16_a_with_fp32_b_as_the_pallas_kernel_does():
    """The backward's dtype pair: a bf16, b fp32 -> h in bf16, b never rounded."""
    rng = np.random.default_rng(8)
    a = (0.7 + 0.299 * rng.random((2, 33, 16))).astype(np.float32)
    b = (1e-3 * rng.standard_normal((2, 33, 16))).astype(np.float32)
    jh, jhn = jrglru_scan(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.float32),
                          interpret=True)
    h, hn = lru_ops.linear_scan(_t(a, torch.bfloat16), _t(b))
    assert h.dtype == torch.bfloat16
    _close(h, jh, 2e-2)
    _close(hn, jhn, 2e-2)
    # b kept in fp32: rounding it to bf16 first gives another h
    h_rounded, _ = lru_ops.linear_scan(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    assert not torch.equal(h, h_rounded)
    assert lru_ops.route_for(torch.bfloat16, 4096, torch.float32) == "ring"
    assert lru_ops.route_for(torch.bfloat16, 100, torch.float32) == "simple"
    with pytest.raises(ValueError):
        lru_ops.route_for(torch.float32, 4096, torch.bfloat16)


FLASH_GRAD_CASES = [
    # B, S, Hq, Hkv, D, causal, window, softcap
    (2, 19, 4, 2, 16, True, None, None),
    (1, 40, 4, 1, 16, True, 8, None),
    (2, 24, 2, 2, 32, True, None, 5.0),
    (1, 33, 4, 2, 16, False, None, None),
    (1, 48, 4, 4, 16, True, 16, 20.0),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,softcap", FLASH_GRAD_CASES)
def test_flash_function_vjp_matches_reference(B, S, Hq, Hkv, D, causal, window, softcap):
    """The attention Function's output and dq, dk, dv against ``jax.vjp`` of
    the reference's ``mha_reference``."""
    rng = np.random.default_rng(S + Hq)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jout, vjp = jax.vjp(lambda *x: jfa_ref.mha_reference(*x, **kw),
                        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = fa_ops.attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    _close(out, jout, OP_TOL)
    for got, want in zip(torch.autograd.grad(out, (tq, tk, tv), _t(g)), vjp(jnp.asarray(g))):
        _close(got, want, OP_TOL)


def test_ops_take_their_plain_route_without_grad():
    """Serving never builds the autograd Functions (no grad, or no input
    that requires it)."""
    x = torch.randn(1, 8, 2, 16)
    assert fa_ops.attention(x, x, x).grad_fn is None
    with torch.no_grad():
        assert fa_ops.attention(x.requires_grad_(), x, x).grad_fn is None
    a = torch.rand(1, 5, 4)
    assert lru_ops.linear_scan(a, a)[0].grad_fn is None


@pytest.mark.parametrize("T", [1, 130, 300])
def test_wkv_chunked_forward_equals_the_loop_twin(T):
    """Chunks of 128 steps, shrunk to a divisor of T (130 -> 65, 300 -> 100):
    the same operations, so y and the state are identical."""
    g = torch.Generator().manual_seed(T)
    r, k, v = (torch.randn(2, T, 3, 8, generator=g) for _ in range(3))
    w = torch.rand(2, T, 3, 8, generator=g) * 0.5 + 0.45
    u = torch.randn(3, 8, generator=g)
    s0 = torch.randn(2, 3, 8, 8, generator=g)
    y, s = wkv_ref.wkv6_chunked(r, k, v, w, u, s0)
    y_loop, s_loop = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
    assert torch.equal(y, y_loop) and torch.equal(s, s_loop)


def test_wkv_trains_through_the_chunked_twin_and_matches_reference_grads(monkeypatch):
    """``wkv_ops.wkv`` with an input that requires grad runs ``wkv6_chunked``;
    its gradients (through the checkpointed chunks) against ``jax.grad`` of
    the reference's oracle."""
    B, T, H, K = 2, 200, 2, 8
    rng = np.random.default_rng(11)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5 for _ in range(3))
    w = (0.5 + 0.49 * rng.random((B, T, H, K))).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    gy = rng.standard_normal((B, T, H, K)).astype(np.float32)
    gs = rng.standard_normal((B, H, K, K)).astype(np.float32)

    def jloss(*xs):
        y, s = jwkv_ref.wkv6_reference(*xs)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(x)
                                                         for x in (r, k, v, w, u, s0)))
    calls = []
    chunked = wkv_ref.wkv6_chunked
    monkeypatch.setattr(wkv_ref, "wkv6_chunked",
                        lambda *a, **kw: calls.append(1) or chunked(*a, **kw))
    ts = [_t(x).requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = wkv_ops.wkv(*ts)
    assert calls == [1]
    tgrads = torch.autograd.grad((y * _t(gy)).sum() + (s * _t(gs)).sum(), ts)
    for got, want in zip(tgrads, jgrads):
        w_ = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w_, atol=OP_TOL * np.abs(w_).max(),
                                   rtol=OP_TOL * 10)


# ---------------------------------------------------------------------------
# The loss and its gradients through whole models
# ---------------------------------------------------------------------------

def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        got = common.softmax_xent(_t(logits), torch.from_numpy(labels),
                                  None if m is None else _t(m))
        _close(got, want, OP_TOL)


@pytest.mark.parametrize("name", PORTED)
def test_lm_loss_and_every_gradient_match_reference(name):
    cfg, jmodel, np_params = _setup(name)
    batch = _batch(cfg, mask=(name == "gemma2-9b"))
    loss, metrics, grads = _port_loss_and_grads(cfg, np_params, batch)
    want_loss, want_grads, _ = _reference_loss_and_grads(cfg, jmodel, np_params, batch)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["moe_aux"]) == 0.0
    _assert_grads_close(grads, want_grads, GRAD_TOL)


@pytest.mark.parametrize("name", PORTED)
def test_lm_forward_logits_match_reference(name):
    cfg, _, np_params = _setup(name)
    jcfg = JARCHS[name].reduced()
    tokens = _batch(cfg)["tokens"]
    want, want_aux = jtransformer.lm_forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                                             jcfg, jnp.asarray(tokens), backend="reference")
    with torch.no_grad():
        got, aux = from_jax_params(cfg, np_params, device="cpu")(torch.from_numpy(tokens))
    _close(got, want, 2e-4)
    _close(aux, want_aux, OP_TOL)


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_gives_the_gradients_of_no_remat(name, policy):
    cfg, _, np_params = _setup(name)
    batch = _batch(cfg)
    loss0, _, g0 = _port_loss_and_grads(cfg, np_params, batch, remat_policy=None)
    loss, _, g = _port_loss_and_grads(cfg, np_params, batch, remat_policy=policy)
    assert torch.equal(loss, loss0)
    for n in g0:
        assert torch.equal(g[n], g0[n]), n


def test_unknown_remat_policy_raises():
    cfg, _, np_params = _setup("gemma2-9b")
    with pytest.raises(ValueError, match="remat policy"):
        _port_loss_and_grads(cfg, np_params, _batch(cfg), remat_policy="everything")


def test_lm_loss_bf16_compute_tracks_reference():
    """bf16 compute over fp32 masters: the cast is inside the differentiated
    function on both sides, so gradients reach the fp32 masters."""
    cfg, jmodel, np_params = _setup("recurrentgemma-9b")
    batch = _batch(cfg)
    loss, _, grads = _port_loss_and_grads(cfg, np_params, batch,
                                          compute_dtype=torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in grads.values())
    want_loss, want_grads, _ = _reference_loss_and_grads(cfg, jmodel, np_params, batch,
                                                         compute_dtype=jnp.bfloat16)
    assert abs(float(loss) - want_loss) <= BF16_LOSS_TOL * abs(want_loss)
    _assert_grads_close(grads, want_grads, BF16_GRAD_TOL)


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_loop_tracks_reference_losses(grad_accum):
    """Five steps from the same converted init on the same batches."""
    name = "recurrentgemma-9b"
    cfg, jmodel, np_params = _setup(name)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 40, 4, seed=3))
    opt = dict(lr=1e-2, weight_decay=0.1)
    jrun = JTrainRunConfig(optimizer=joptim.AdamWConfig(**opt), total_steps=5,
                           warmup_steps=2, compute_dtype=jnp.float32, grad_accum=grad_accum)
    run = TrainRunConfig(optimizer=optimizer.AdamWConfig(**opt), total_steps=5,
                         warmup_steps=2, compute_dtype=torch.float32, grad_accum=grad_accum)
    _, _, jhist = jtrain_loop(jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
                              ({k: jnp.asarray(v) for k, v in b.items()}
                               for b in data.batches(5)), jrun, log_every=1)
    lm = from_jax_params(cfg, np_params, device="cpu")
    lm, state, hist = train_loop(build_model(cfg, device="cpu"), lm, data.batches(5), run,
                                 log_every=1)
    assert state.step == 5
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2, 3, 4, 5]
    for h, jh in zip(hist, jhist):
        assert abs(h["loss"] - jh["loss"]) <= 1e-4 * abs(jh["loss"]), (h, jh)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_grad_accum_of_equal_slices_averages_the_gradients(monkeypatch):
    """grad_accum=2 hands the optimizer the mean of the two half-batch
    gradients, and reports the mean of their losses."""
    cfg = ARCHS["gemma2-9b"].reduced()
    batch = _batch(cfg, B=4, S=16)
    halves = []
    for sl in (slice(0, 2), slice(2, 4)):
        lm = init_params(cfg, seed=2, device="cpu").requires_grad_(True)
        loss, _ = lm_loss(lm, {k: torch.from_numpy(v[sl]) for k, v in batch.items()})
        names, params = zip(*lm.named_parameters())
        halves.append((loss, dict(zip(names, torch.autograd.grad(loss, params)))))
    seen = {}

    def update(grads, state, params):
        seen.update(grads)
        return params, state, {}

    real = train_loop_mod.adamw
    monkeypatch.setattr(train_loop_mod, "adamw", lambda *a, **kw: (real(*a, **kw)[0], update))
    step, opt_init = make_train_step(build_model(cfg, device="cpu"),
                                     TrainRunConfig(compute_dtype=None, grad_accum=2))
    lm = init_params(cfg, seed=2, device="cpu")
    _, _, metrics = step(lm, opt_init(lm), batch)
    _close(metrics["loss"], float(halves[0][0].detach() + halves[1][0].detach()) / 2, OP_TOL)
    assert sorted(seen) == sorted(halves[0][1])
    for n, g in seen.items():
        torch.testing.assert_close(g, (halves[0][1][n] + halves[1][1][n]) / 2,
                                   atol=OP_TOL, rtol=OP_TOL)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}, "n": 7}
    for step in [1, 2, 3]:
        ck.save(step, {"a": tree["a"] * step, "b": {"c": tree["b"]["c"] * step}, "n": step})
    assert ck.all_steps() == [2, 3]  # latest-k retention
    assert sorted(np.load(tmp_path / "step_0000000003" / "arrays.npz").files) == [
        "a", "b/c", "n"]
    template = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}, "n": 0}
    step, restored = ck.restore(template)
    assert step == 3 and restored["n"] == 3
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(6).reshape(2, 3) * 3)
    np.testing.assert_array_equal(restored["b"]["c"].numpy(), np.full(4, 3.0))


def test_checkpoint_async_and_shape_guard(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=True)
    w = torch.ones(3, 3)
    ck.save(10, {"w": w})
    w.add_(1.0)  # an update after save() returns does not reach the checkpoint
    ck.wait()
    assert ck.all_steps() == [10]
    _, restored = ck.restore({"w": torch.zeros(3, 3)})
    assert torch.equal(restored["w"], torch.ones(3, 3))
    with pytest.raises(ValueError, match="shape mismatch at w"):
        ck.restore({"w": torch.zeros(4, 4)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": w})


def test_checkpoint_restart_continues_training_exactly(tmp_path):
    """Crash after 6 steps, restore the latest checkpoint into a fresh model
    and optimizer state, continue 4 steps on the deterministic stream: the
    same parameters and moments as 10 uninterrupted steps."""
    cfg = ARCHS["gemma-7b"].reduced()
    model = build_model(cfg, device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=2))
    run = TrainRunConfig(optimizer=optimizer.AdamWConfig(lr=1e-3), total_steps=20,
                         compute_dtype=torch.float32)
    ref_lm, ref_state, _ = train_loop(model, model.init(0), data.batches(10), run,
                                      log_every=0)

    ck = Checkpointer(str(tmp_path), keep=1)
    lm, state, _ = train_loop(model, model.init(0), data.batches(6), run, log_every=0,
                              checkpointer=ck, checkpoint_every=3)
    assert ck.all_steps() == [6]
    fresh = model.init(1)
    fresh_state = make_train_step(model, run)[1](fresh)
    step, restored = ck.restore({"params": fresh, "opt": fresh_state})
    assert step == 6 and restored["opt"].step == 6 and restored["params"] is fresh
    lm2, state2, _ = train_loop(model, restored["params"], data.batches(4, start=6), run,
                                log_every=0, opt_state=restored["opt"], start_step=6)
    assert state2.step == ref_state.step == 10
    for (n, p), (_, q) in zip(lm2.named_parameters(), ref_lm.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state2.mu[n], ref_state.mu[n]), n
        assert torch.equal(state2.nu[n], ref_state.nu[n]), n


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_launch_train_lm_runs_on_cpu(tmp_path, capsys):
    res = train_lm.main(["--quick", "--steps", "12", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["opt_step"] == 12 and res["cfg"].name == "mistral-nemo-12b-smoke"
    assert [h["step"] for h in res["history"]] == [10]
    assert np.isfinite(res["history"][0]["loss"])
    assert "final loss" in out and ("LEARNED" in out or "(check)" in out)
    assert f"checkpoints: [] in {tmp_path}" in out
