"""Port kernels vs the JAX reference kernels, and the CUDA kernels vs their twins.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the reference's Pallas kernels in interpret mode and against
its jnp oracles (``backend="reference"``), on the same numpy inputs.

The CUDA kernels themselves are held against these twins on the card in
``test_torch_cuda.py``.

Tolerances: 1e-5 in fp32 (both sides compute in fp32; only the summation
order differs); 2e-2 in bf16 (one bf16 ulp at |x| < 4, where the two sides
round the same fp32 value on either side of a boundary).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro.kernels.rglru import ops as jlru_ops
from repro.kernels.rwkv6 import ops as jwkv_ops
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref
from repro_torch.launch.perf import stray_knobs

# a knob left set would change the plain reference the port is held to
assert not stray_knobs(), f"unset {stray_knobs()} to run these tests"

TOL = {np.float32: 1e-5, "bfloat16": 2e-2}
TORCH_DT = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arr, dt):
    """The same values as a torch CPU tensor and a jax array of dtype dt."""
    t = torch.from_numpy(np.array(arr, np.float32)).to(TORCH_DT[dt])
    return t, jnp.asarray(arr, JAX_DT[dt])


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset
    (2, 64, 64, 4, 2, 16, True, None, None, 0),     # GQA causal
    (1, 48, 48, 8, 1, 64, True, None, None, 0),     # MQA (recurrentgemma heads)
    (2, 32, 64, 4, 4, 16, False, None, None, 0),    # bidirectional
    (1, 64, 64, 2, 2, 256, True, 24, 50.0, 0),      # window+softcap, head_dim 256
    (1, 16, 64, 4, 2, 16, True, None, None, 48),    # decode tile at q_offset
    (1, 37, 37, 4, 2, 16, True, 8, None, 0),        # prime length
]


FLASH_PARAMS = [(c, np.float32) for c in FLASH_CASES] + [
    (FLASH_CASES[3], "bfloat16"),
    # bf16 at head_dim 128, GQA: what the card's tensor-core kernel takes
    ((1, 64, 64, 4, 2, 128, True, 32, None, 0), "bfloat16"),
]


def _jit_attention(backend, **kw):
    """The reference op, jitted: one compile per case instead of one per op."""
    return jax.jit(functools.partial(jfa_ops.attention, backend=backend, **kw))


@pytest.mark.parametrize("case,dt", FLASH_PARAMS)
@pytest.mark.parametrize("backend", ["interpret", "reference"])
def test_flash_plain_matches_reference(case, dt, backend):
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(Sq * 7 + D)
    q, jq = _pair(rng.standard_normal((B, Sq, Hq, D)), dt)
    k, jk = _pair(rng.standard_normal((B, Sk, Hkv, D)), dt)
    v, jv = _pair(rng.standard_normal((B, Sk, Hkv, D)), dt)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out = fa_ops.attention(q, k, v, **kw)
    want = _jit_attention(backend, **kw)(jq, jk, jv)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), _np(want),
                               atol=TOL[dt], rtol=TOL[dt])


def test_flash_fully_masked_rows():
    """Rows that see no key: the plain path averages v (as the jnp oracle
    does, softmax over equal NEG_INF scores); the Pallas kernel gives 0."""
    rng = np.random.default_rng(1)
    B, S, H, D = 1, 32, 2, 16
    q, jq = _pair(rng.standard_normal((B, S, H, D)), np.float32)
    k, jk = _pair(rng.standard_normal((B, S, H, D)), np.float32)
    v, jv = _pair(rng.standard_normal((B, S, H, D)), np.float32)
    # rows at positions 30..61 against keys 0..31: row p sees (p-8, 31]
    kw = dict(causal=False, window=8, q_offset=30)
    out = fa_ops.attention(q, k, v, **kw).numpy()
    ref = _np(_jit_attention("reference", **kw)(jq, jk, jv))
    pallas = _np(_jit_attention("interpret", **kw)(jq, jk, jv))
    dead = np.arange(S) + 30 - 8 >= S - 1
    assert dead.any() and not dead.all()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, ~dead], pallas[:, ~dead], atol=1e-5, rtol=1e-5)
    assert np.all(pallas[:, dead] == 0.0)
    np.testing.assert_allclose(out[:, dead],
                               np.broadcast_to(v.numpy().mean(1, keepdims=True),
                                               out[:, dead].shape), atol=1e-5)


@pytest.mark.parametrize("backend", ["interpret", "reference"])
def test_flash_kv_len_decode(backend):
    """One query per row against a cache with per-row valid lengths."""
    rng = np.random.default_rng(2)
    B, L, Hq, Hkv, D = 3, 40, 4, 1, 16
    q, jq = _pair(rng.standard_normal((B, 1, Hq, D)), np.float32)
    k, jk = _pair(rng.standard_normal((B, L, Hkv, D)), np.float32)
    v, jv = _pair(rng.standard_normal((B, L, Hkv, D)), np.float32)
    kv_len = np.array([1, 17, 40])
    out = fa_ops.attention(q, k, v, causal=False, softcap=50.0,
                           kv_len=torch.from_numpy(kv_len))
    want = _jit_attention(backend, causal=False, softcap=50.0)(
        jq, jk, jv, kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(out.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_flash_chunked_and_mask_match_reference():
    rng = np.random.default_rng(3)
    q, jq = _pair(rng.standard_normal((1, 48, 2, 16)), np.float32)
    k, jk = _pair(rng.standard_normal((1, 48, 1, 16)), np.float32)
    v, jv = _pair(rng.standard_normal((1, 48, 1, 16)), np.float32)
    kw = dict(causal=True, window=20, softcap=30.0, q_offset=0, chunk_q=20)
    out = fa_ref.mha_chunked(q, k, v, **kw)
    want = jax.jit(functools.partial(jfa_ref.mha_chunked, **kw))(jq, jk, jv)
    np.testing.assert_allclose(out.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    for args in [(5, 9, True, None, 2), (9, 5, False, 3, 0), (8, 8, True, 4, 0)]:
        np.testing.assert_array_equal(fa_ref.attention_mask(*args).numpy(),
                                      np.asarray(jfa_ref.attention_mask(*args)))


def test_cpu_tensors_never_reach_the_kernels():
    """On the CPU every wrapper takes the plain path without building anything."""
    kernels = (fa_ops.KERNEL, fa_ops.WGMMA_KERNEL, lru_ops.KERNEL, wkv_ops.KERNEL)
    before = [k.launches for k in kernels]
    x = torch.zeros(1, 8, 2, 16)
    fa_ops.attention(x, x, x)
    xb = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)   # the wgmma kernel's inputs
    assert fa_ops.attention(xb, xb, xb).dtype == torch.bfloat16
    a = torch.full((1, 8, 4), 0.5)
    lru_ops.linear_scan(a, a)
    y, s_final = wkv_ops.wkv(x, x, x, x + 0.5, torch.zeros(2, 16))
    assert y.shape == (1, 8, 2, 16) and s_final.shape == (1, 2, 16, 16)
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)   # nothing loaded, nothing built


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", fa_ops.HEAD_DIMS)
def test_flash_kernel_for_routes_by_dtype_and_head_dim(dt, head_dim):
    """bf16 at head_dim 64, 128 or 256 (every bf16 config, whisper-medium's
    64 too) goes to the tensor-core kernel; fp32 and head_dim 16 and 32 to
    the CUDA-core one."""
    want = "wgmma" if dt == torch.bfloat16 and head_dim in (64, 128, 256) else "simt"
    assert fa_ops.kernel_for(dt, head_dim) == want


@pytest.mark.parametrize("dt,C,want", [
    (torch.bfloat16, 4096, "ring"),     # recurrentgemma-9b's lru_width
    (torch.float32, 4096, "ring"),
    (torch.bfloat16, 4000, "ring"),
    (torch.bfloat16, 100, "simple"),    # a row of 200 bytes: TMA cannot map it
    (torch.float32, 100, "ring"),
    (torch.bfloat16, 8, "ring"),
])
def test_rglru_route_for_routes_by_row_bytes(dt, C, want):
    """A row that is a multiple of 16 bytes is fed by the TMA ring; any other
    C takes the simple path of the same kernel source, never the twin."""
    assert lru_ops.route_for(dt, C) == want


def test_rglru_route_for_serving_width_is_the_ring():
    cfg = get_config("recurrentgemma-9b")
    assert lru_ops.route_for(torch.bfloat16, cfg.rnn_width) == "ring"
    with pytest.raises(ValueError):
        lru_ops.route_for(torch.float16, 4096)


@pytest.mark.parametrize("launcher,dt,shape_q,shape_kv,match", [
    ("wgmma", torch.float32, (1, 8, 2, 256), (1, 8, 2, 256), "takes"),
    ("wgmma", torch.bfloat16, (1, 8, 2, 32), (1, 8, 2, 32), "head_dim"),
    ("wgmma", torch.bfloat16, (1, 8, 3, 128), (1, 8, 2, 128), "multiple"),
    ("wgmma", torch.bfloat16, (1, 8, 2, 256), (1, 8, 1, 256), "CUDA tensors"),
    ("simt", torch.float16, (1, 8, 2, 64), (1, 8, 2, 64), "takes"),
    ("simt", torch.float32, (1, 8, 2, 48), (1, 8, 2, 48), "head_dim"),
])
def test_flash_launchers_refuse_what_their_kernel_does_not_take(
        launcher, dt, shape_q, shape_kv, match):
    """Each launcher checks its inputs before any build or launch."""
    fn = {"wgmma": fa_ops.flash_attention_wgmma_cuda,
          "simt": fa_ops.flash_attention_cuda}[launcher]
    q = torch.zeros(shape_q, dtype=dt)
    kv = torch.zeros(shape_kv, dtype=dt)
    with pytest.raises(ValueError, match=match):
        fn(q, kv, kv)
    assert fa_ops.WGMMA_KERNEL.launches == 0 and fa_ops.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,C,with_h0,dt", [
    (2, 64, 128, False, np.float32),
    (2, 64, 128, True, np.float32),
    (1, 37, 64, True, np.float32),     # prime length
    (2, 64, 128, True, "bfloat16"),
])
@pytest.mark.parametrize("backend", ["interpret", "reference"])
def test_rglru_plain_matches_reference(B, T, C, with_h0, dt, backend):
    rng = np.random.default_rng(T + C)
    a, ja = _pair(rng.uniform(0.7, 0.999, (B, T, C)), dt)
    b, jb = _pair(rng.standard_normal((B, T, C)) * 0.1, dt)
    h0, jh0 = _pair(rng.standard_normal((B, C)) * 0.1, dt) if with_h0 else (None, None)
    h, h_final = lru_ops.linear_scan(a, b, h0)
    scan = jax.jit(functools.partial(jlru_ops.linear_scan, backend=backend))
    jh, jh_final = scan(ja, jb, jh0)
    assert h.dtype == a.dtype and h_final.dtype == torch.float32
    np.testing.assert_allclose(h.float().numpy(), _np(jh), atol=TOL[dt], rtol=TOL[dt])
    np.testing.assert_allclose(h_final.numpy(), _np(jh_final), atol=TOL[dt], rtol=TOL[dt])


# ---------------------------------------------------------------------------
# RWKV-6 WKV
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, T, H, K, dt, with_s0):
    """Same values for both sides; decays in (0.5, 1) as the time mix gives."""
    r, jr = _pair(rng.standard_normal((B, T, H, K)) * 0.5, dt)
    k, jk = _pair(rng.standard_normal((B, T, H, K)) * 0.5, dt)
    v, jv = _pair(rng.standard_normal((B, T, H, K)) * 0.5, dt)
    w, jw = _pair(rng.uniform(0.5, 0.999, (B, T, H, K)), dt)
    u, ju = _pair(rng.standard_normal((H, K)) * 0.5, dt)
    if with_s0:
        s0, js0 = _pair(rng.standard_normal((B, H, K, K)), np.float32)
    else:
        s0, js0 = None, None
    return (r, k, v, w, u, s0), (jr, jk, jv, jw, ju, js0)


@pytest.mark.parametrize("B,T,H,K,with_s0,dt", [
    (2, 32, 2, 16, False, np.float32),
    (2, 32, 2, 16, True, np.float32),
    (1, 13, 2, 16, True, np.float32),     # prime length: one Pallas grid step per t
    (1, 16, 2, 64, True, np.float32),     # the full-width head size
    (2, 32, 2, 16, True, "bfloat16"),
])
@pytest.mark.parametrize("backend", ["interpret", "reference"])
def test_wkv6_plain_matches_reference(B, T, H, K, with_s0, dt, backend):
    """y in r's dtype, s_final in fp32; in bf16 y rounds the same fp32 sums
    (one ulp) and the state sees the same bf16 inputs (1e-5)."""
    ins, jins = _wkv_inputs(np.random.default_rng(T + K), B, T, H, K, dt, with_s0)
    y, s_final = wkv_ops.wkv(*ins)
    wkv = jax.jit(functools.partial(jwkv_ops.wkv, backend=backend))
    jy, js = wkv(*jins)
    assert y.dtype == ins[0].dtype and s_final.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), _np(jy), atol=TOL[dt], rtol=TOL[dt])
    np.testing.assert_allclose(s_final.numpy(), _np(js), atol=1e-5, rtol=1e-5)


def test_wkv6_state_chaining():
    """Two halves with the state carried give the whole, bit for bit, and the
    reference's chained halves agree with both."""
    ins, jins = _wkv_inputs(np.random.default_rng(9), 2, 30, 2, 16, np.float32, True)
    r, k, v, w, u, s0 = ins
    y, s = wkv_ref.wkv6_reference(*ins)
    y1, s1 = wkv_ref.wkv6_reference(r[:, :11], k[:, :11], v[:, :11], w[:, :11], u, s0)
    y2, s2 = wkv_ref.wkv6_reference(r[:, 11:], k[:, 11:], v[:, 11:], w[:, 11:], u, s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, s)
    jr, jk, jv, jw, ju, js0 = jins
    wkv = jax.jit(functools.partial(jwkv_ops.wkv, backend="reference"))
    _, js1 = wkv(jr[:, :11], jk[:, :11], jv[:, :11], jw[:, :11], ju, js0)
    jy2, js2 = wkv(jr[:, 11:], jk[:, 11:], jv[:, 11:], jw[:, 11:], ju, js1)
    np.testing.assert_allclose(y2.numpy(), _np(jy2), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), _np(js2), atol=1e-5, rtol=1e-5)


def test_wkv6_writes_its_state_in_place():
    """``out`` may be s0 itself, as decode passes its cached state."""
    ins, _ = _wkv_inputs(np.random.default_rng(11), 2, 5, 2, 16, np.float32, True)
    y, s = wkv_ops.wkv(*ins)
    state = ins[5].clone()
    y_in, s_in = wkv_ops.wkv(*ins[:5], state, out=state)
    assert s_in is state
    assert torch.equal(y_in, y) and torch.equal(state, s)


def test_wkv6_zero_state_is_no_state():
    ins, _ = _wkv_inputs(np.random.default_rng(10), 1, 9, 2, 16, np.float32, False)
    y, s = wkv_ops.wkv(*ins[:5])
    y0, s0 = wkv_ops.wkv(*ins[:5], torch.zeros(1, 2, 16, 16))
    assert torch.equal(y, y0) and torch.equal(s, s0)
