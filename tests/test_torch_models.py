"""Port models vs the JAX reference on reduced configs, through from_jax_params.

Parameters are drawn with numpy in the reference's pytree layout and carried
across, so every module sees the same weights and the same numpy inputs. Both sides
run in fp32 on the CPU. Tolerances: 1e-5 for single ops (fp32, summation
order only); 2e-4 for logits after a whole model (fp32 error accumulated
over every layer; the logits are O(1)).

Full-width configs are only ever built on the meta device here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro.models.model_zoo import build_model as jbuild_model
from repro_torch.configs import ARCHS
from repro_torch.launch.perf import stray_knobs
from repro_torch.models import common
from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.mlp import MLP
from repro_torch.models.model_zoo import build_model
from repro_torch.models.rglru import RGLRU, init_rglru_state
from repro_torch.models.rwkv6 import ChannelMix, TimeMix, _group_norm, init_rwkv_state
from repro_torch.models.transformer import LM
from repro_torch.weights import from_jax_params, init_params

# a knob left set would change the plain reference the port is held to
assert not stray_knobs(), f"unset {stray_knobs()} to run these tests"

OP_TOL = 1e-5
LOGIT_TOL = 2e-4
PORTED = ["recurrentgemma-9b", "gemma2-9b", "rwkv6-7b"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _numpy_params(jcfg, seed):
    """A parameter pytree in the reference's layout, drawn with numpy.

    The layout comes from tracing the reference's init (``eval_shape``, no
    compile); the values are seeded normals, nonzero everywhere so that every
    leaf (norm scales and biases too) is exercised."""
    shapes = jax.eval_shape(lambda k: jtransformer.init_lm_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * (0.05 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(jax config, jax model, jax params, numpy params, port LM) for a reduced arch."""
    jcfg = JARCHS[name].reduced()
    np_params = _numpy_params(jcfg, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    lm = from_jax_params(ARCHS[name].reduced(), np_params, device="cpu")
    return jcfg, jbuild_model(jcfg), jparams, np_params, lm


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# Plain data and parameter plumbing
# ---------------------------------------------------------------------------

def test_configs_are_copies_of_the_reference():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(JARCHS[name])
        assert ARCHS[name].param_count() == JARCHS[name].param_count()
        assert (dataclasses.asdict(ARCHS[name].reduced())
                == dataclasses.asdict(JARCHS[name].reduced()))


@pytest.mark.parametrize("name", PORTED)
def test_from_jax_params_round_trip(name):
    """Pytree -> modules -> re-stacked pytree gives back every leaf exactly."""
    jcfg, _, _, np_params, lm = _reference(name)
    n_groups, _ = jcfg.n_groups_and_tail()
    p = len(jcfg.mixer_pattern)
    sd = {k: v.numpy() for k, v in lm.state_dict().items()}

    def restack(prefixes, tree, path=""):
        if isinstance(tree, dict):
            return {k: restack(prefixes, v, f"{path}.{k}") for k, v in tree.items()}
        return np.stack([sd[f"{pre}{path}"] for pre in prefixes])

    back = {k: jax.tree_util.tree_map(lambda a: a[0], restack([""], np_params[k], k))
            for k in ("embed", "final_norm", "unembed") if k in np_params}
    back["blocks"] = [restack([f"layers.{g * p + i}" for g in range(n_groups)], blk)
                      for i, blk in enumerate(np_params["blocks"])]
    back["tail"] = [jax.tree_util.tree_map(lambda a: a[0], restack(
        [f"layers.{n_groups * p + j}"], t)) for j, t in enumerate(np_params["tail"])]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_params)
    assert len(sd) == len(jax.tree_util.tree_leaves(np_params)) + (
        (n_groups - 1) * sum(len(jax.tree_util.tree_leaves(b)) for b in np_params["blocks"]))


@pytest.mark.parametrize("name", PORTED)
def test_full_width_shapes_on_meta_device(name):
    """Full width without allocating: every port parameter has the shape of the
    reference leaf it loads from, and the totals agree."""
    cfg, jcfg = ARCHS[name], JARCHS[name]
    lm = LM(cfg, torch.device("meta"), torch.bfloat16)
    shapes = jax.eval_shape(
        lambda k: jtransformer.init_lm_params(jcfg, k, jnp.bfloat16),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    n_groups, _ = cfg.n_groups_and_tail()
    p = len(cfg.mixer_pattern)
    got = {k: tuple(v.shape) for k, v in lm.named_parameters()}
    want = {}
    for k in ("embed", "final_norm", "unembed"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes.get(k, {})):
            want[".".join([k] + [str(e.key) for e in path])] = tuple(leaf.shape)
    for i, blk in enumerate(shapes["blocks"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(blk):
            key = ".".join(str(e.key) for e in path)
            for g in range(n_groups):
                want[f"layers.{g * p + i}.{key}"] = tuple(leaf.shape[1:])
    for j, blk in enumerate(shapes["tail"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(blk):
            key = ".".join(str(e.key) for e in path)
            want[f"layers.{n_groups * p + j}.{key}"] = tuple(leaf.shape)
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    # the analytic count leaves out the RG-LRU gate matrices (2 * w * w / n_heads)
    # and the RWKV-6 decay LoRA, bonus and per-channel vectors
    assert abs(n - cfg.param_count()) / n < 0.01
    if name == "recurrentgemma-9b":
        kinds = [layer.mixer for layer in lm.layers]
        assert (len(kinds), kinds.count("rglru"), kinds.count("attn_local")) == (38, 26, 12)
        assert 8.5e9 < n < 8.8e9
    if name == "rwkv6-7b":
        assert [layer.mixer for layer in lm.layers] == ["rwkv"] * 32
        assert 7.5e9 < n < 7.6e9  # 15.1 GB in bf16: one card holds it whole


def test_init_params_statistics():
    """Seeded init on the CPU: reference statistics, reproducible bits."""
    cfg = dataclasses.replace(ARCHS["recurrentgemma-9b"].reduced(), d_model=256,
                              d_ff=512, rnn_width=256)
    lm = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    for (k, a), (_, b) in zip(lm.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    assert abs(float(lm.embed.std()) - 0.02) < 0.002
    # truncated (+-2) standard normal has std 0.8796; scaled by 1/sqrt(fan_in)
    w = lm.layers[0].mlp.w_up
    assert abs(float(w.std()) * np.sqrt(256) - 0.8796) < 0.02
    assert float(w.abs().max()) <= 2.0 / np.sqrt(256) + 1e-6
    rg = lm.layers[0].rglru
    np.testing.assert_allclose(rg.lam.numpy(), np.linspace(-2, 1, 256), atol=1e-6)
    assert not rg.conv_b.any() and not lm.final_norm.any() and not lm.layers[0].norm1.any()


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_common_ops_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(common.rms_norm(_t(scale), _t(x)), jcommon.rms_norm(scale, x), OP_TOL)
    g, b = 1 + scale, rng.standard_normal(16).astype(np.float32) * 0.1
    x_off = 3.0 + 2.0 * x  # a mean and a spread for the layernorm to remove
    _close(common.layer_norm(_t(g), _t(b), _t(x_off)),
           jcommon.layer_norm({"g": g, "b": b}, x_off), OP_TOL)
    for norm_type in ("rmsnorm", "layernorm"):
        p = common.norm_init(norm_type, 16, "cpu", torch.float32)
        common.reset_norm_(p)
        _close(common.apply_norm(p, _t(x_off)),
               jcommon.apply_norm(norm_type, jcommon.norm_init(norm_type, 16, jnp.float32),
                                  x_off), OP_TOL)
    y = x.reshape(2, 7, 64) * 4.0 + 1.0
    scale64 = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(_group_norm(_t(scale64), _t(y), 4), jrwkv6._group_norm(scale64, y, 4), OP_TOL)
    pos = np.arange(7)
    sin, cos = common.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    jsin, jcos = jcommon.rope_angles(jnp.asarray(pos), 16, 10000.0)
    _close(sin, jsin, OP_TOL)
    _close(cos, jcos, OP_TOL)
    _close(common.apply_rope(_t(x), sin, cos), jcommon.apply_rope(x, jsin, jcos), OP_TOL)


@pytest.mark.parametrize("mlp_type", ["geglu", "swiglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    cfg = dataclasses.replace(ARCHS["gemma2-9b"].reduced(), mlp_type=mlp_type)
    jp = jmlp.init_mlp(jcommon.KeyGen(jax.random.PRNGKey(1)), cfg, jnp.float32)
    mod = MLP(cfg, "cpu", torch.float32)
    mod.load_state_dict({k: _t(v) for k, v in jp.items()})
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(mod(_t(x)), jmlp.mlp_block(jp, cfg, jnp.asarray(x)), OP_TOL)


@pytest.mark.parametrize("local", [False, True])
def test_attention_prefill_and_ring_decode_match_reference(local):
    """Prefill attention (plain flash twin) and decode far past the window."""
    cfg = ARCHS["gemma2-9b"].reduced()  # softcap 50, GQA 4q / 2kv, window 32
    jp = jattention.init_attention(jcommon.KeyGen(jax.random.PRNGKey(2)), cfg, jnp.float32)
    mod = Attention(cfg, "cpu", torch.float32, local=local)
    mod.load_state_dict({k: _t(v) for k, v in jp.items()})
    rng = np.random.default_rng(2)
    S = 40
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(jattention.attention_block, jp, cfg, local=local))(
        jnp.asarray(x), jnp.arange(S))
    cache = init_kv_cache(cfg, 2, 48, torch.float32, "cpu", local=local)
    _close(mod.prefill(_t(x), torch.arange(S), cache), want, OP_TOL)

    jcache = jattention.init_kv_cache(cfg, 2, 48, jnp.float32, local=local)
    jstep = jax.jit(functools.partial(jattention.decode_attention_block, jp, cfg, local=local))
    cache = init_kv_cache(cfg, 2, 48, torch.float32, "cpu", local=local)
    for pos in range(0, 80, 3):  # 2.5x the window: the ring wraps twice
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jstep(jnp.asarray(xt), jnp.asarray(pos, jnp.int32), jcache)
        _close(mod.decode(_t(xt), pos, cache), jout, OP_TOL)
    _close(cache["k"], jcache["k"], OP_TOL)


def test_rglru_block_prefill_and_decode_match_reference():
    cfg = ARCHS["recurrentgemma-9b"].reduced()
    jp = jrglru.init_rglru(jcommon.KeyGen(jax.random.PRNGKey(3)), cfg, jnp.float32)
    mod = RGLRU(cfg, "cpu", torch.float32)
    mod.load_state_dict({k: _t(v) for k, v in jp.items()})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    state = init_rglru_state(cfg, 2, torch.float32, "cpu")
    out = mod.prefill(_t(x), state)
    _close(out, jax.jit(lambda v: jrglru.rglru_block(jp, cfg, v))(x), OP_TOL)
    jstate = jrglru.init_rglru_state(cfg, 2, jnp.float32)
    jstep = jax.jit(functools.partial(jrglru.decode_rglru_block, jp, cfg))
    for t in range(23):  # token-by-token decode reproduces the prefill
        jout, jstate = jstep(jnp.asarray(x[:, t:t + 1]), jstate)
    _close(state["h"], jstate["h"], OP_TOL)
    _close(state["conv"], jstate["conv"], OP_TOL)
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jstate = jstep(jnp.asarray(xt), jstate)
    _close(mod.decode(_t(xt), state), jout, OP_TOL)
    _close(state["h"], jstate["h"], OP_TOL)


def test_rwkv_time_and_channel_mix_match_reference():
    """Prefill from zero state, then token-by-token decode with the carried
    shift and WKV states, against the reference's time_mix and channel_mix,
    with modules loaded from the reference's init pytree."""
    cfg = ARCHS["rwkv6-7b"].reduced()
    kg = jcommon.KeyGen(jax.random.PRNGKey(5))
    jtm = jrwkv6.init_rwkv_time_mix(kg, cfg, jnp.float32)
    jcm = jrwkv6.init_rwkv_channel_mix(kg, cfg, jnp.float32)
    tm, cm = TimeMix(cfg, "cpu", torch.float32), ChannelMix(cfg, "cpu", torch.float32)
    tm.load_state_dict({k: _t(v) for k, v in jtm.items()})
    cm.load_state_dict({k: _t(v) for k, v in jcm.items()})
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        out, tm_shift, wkv = tm(_t(x))
        cout, cm_shift = cm(_t(x))
    jout, jtm_shift, jwkv = jax.jit(lambda v: jrwkv6.time_mix(jtm, cfg, v))(x)
    jcout, jcm_shift = jax.jit(lambda v: jrwkv6.channel_mix(jcm, cfg, v))(x)
    for got, want in [(out, jout), (tm_shift, jtm_shift), (wkv, jwkv), (cout, jcout),
                      (cm_shift, jcm_shift)]:
        _close(got, want, OP_TOL)

    state = init_rwkv_state(cfg, 2, torch.float32, "cpu")
    jstate = jrwkv6.init_rwkv_state(cfg, 2, jnp.float32)
    for name in state:
        assert tuple(state[name].shape) == jstate[name].shape
    jtm_step = jax.jit(lambda v, s, w: jrwkv6.time_mix(jtm, cfg, v, s, w))
    jcm_step = jax.jit(lambda v, s: jrwkv6.channel_mix(jcm, cfg, v, s))
    tm_s, wkv_s, cm_s = (state[k] for k in ("tm_shift", "wkv", "cm_shift"))
    jtm_s, jwkv_s, jcm_s = (jstate[k] for k in ("tm_shift", "wkv", "cm_shift"))
    with torch.inference_mode():
        for t in range(19):  # decoding token by token reproduces the prefill
            xt = x[:, t:t + 1]
            o, tm_s, wkv_s = tm(_t(xt), tm_s, wkv_s)
            co, cm_s = cm(_t(xt), cm_s)
            jo, jtm_s, jwkv_s = jtm_step(xt, jtm_s, jwkv_s)
            jco, jcm_s = jcm_step(xt, jcm_s)
            _close(o, jo, OP_TOL)
            _close(o[:, 0], out[:, t], OP_TOL)
            _close(co, jco, OP_TOL)
        _close(wkv_s, wkv, OP_TOL)
        _close(tm_s, tm_shift, 0.0)
        _close(cm_s, cm_shift, 0.0)
        # a carried shift state in a multi-token call replaces the zero pad
        o2, _, _ = tm(_t(x[:, 5:9]), _t(x[:, 4]), None)
        jo2, _, _ = jrwkv6.time_mix(jtm, cfg, x[:, 5:9], x[:, 4], None)
        _close(o2, jo2, OP_TOL)


def test_rwkv_init_statistics():
    """Seeded init: the reference's fixed values and scales for the new leaves."""
    cfg = dataclasses.replace(ARCHS["rwkv6-7b"].reduced(), d_model=256, d_ff=512,
                              rwkv_head_dim=64)
    lm = init_params(cfg, seed=4, device="cpu")
    tm, cm = lm.layers[0].tm, lm.layers[0].cm
    for p in (tm.mu_r, tm.mu_k, tm.mu_v, tm.mu_w, tm.mu_g, cm.mu_k, cm.mu_r):
        assert torch.all(p == 0.5)
    np.testing.assert_allclose(tm.decay_base.numpy(), np.linspace(-6, -0.5, 256), atol=1e-6)
    assert tuple(tm.decay_a.shape) == (256, 64) and tuple(tm.bonus.shape) == (4, 64)
    assert not tm.out_norm.any()
    # decay_b is a 1/sqrt(64) fan-in draw times 0.1; bonus has fan-in n_heads
    assert abs(float(tm.decay_b.std()) * 8 * 10 - 0.8796) < 0.05
    assert abs(float(tm.bonus.std()) * 2 - 0.8796) < 0.1
    ln = lm.layers[0].norm1
    assert torch.all(ln["g"] == 1) and not ln["b"].any()
    assert torch.all(lm.final_norm["g"] == 1) and not lm.final_norm["b"].any()
    assert "layers.0.norm1.g" in lm.state_dict() and "final_norm.b" in lm.state_dict()


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_model_prefill_and_decode_match_reference(name):
    """Prefill 40 tokens (longer than the window of 32, so the prefill rolls
    the ring), then decode to 80 (past 2x the window, so every local cache
    wraps again): logits track the reference's prefill and decode and its
    teacher-forced forward."""
    jcfg, jmodel, jparams, _, lm = _reference(name)
    model = build_model(ARCHS[name].reduced(), device="cpu")
    rng = np.random.default_rng(4)
    B, S, P = 2, 80, 40
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    logits_tf, _ = jax.jit(lambda p, t: jtransformer.lm_forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    jcache = jmodel.init_cache(B, max_len=96, dtype=jnp.float32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :P])},
                                             jcache)
    jdecode = jax.jit(jmodel.decode_step)
    cache = model.init_cache(B, 96, torch.float32)
    with torch.inference_mode():
        logits, cache = model.prefill(lm, {"tokens": torch.from_numpy(toks[:, :P])}, cache)
        assert logits.shape == (B, 1, jcfg.vocab_size)
        _close(logits, jlogits, LOGIT_TOL)
        for t in range(P, S):
            tok = toks[:, t:t + 1]
            jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
            logits, cache = model.decode_step(lm, cache, torch.from_numpy(tok))
            _close(logits, jlogits, LOGIT_TOL)
            _close(logits[:, 0], logits_tf[:, t], LOGIT_TOL)
    assert cache["pos"] == S
