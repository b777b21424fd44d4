"""Tensor-parallel serving on the ``model`` axis (``repro_torch.parallel``)
against the unsplit layer and the JAX reference, on the CPU.

Part (i), one process: for a ``model`` axis of W = 2 and 4, each rank's
share of a reduced layer goes through the functions the ranks call
(``Attention.prefill`` / ``decode``, ``MLP``, ``LM._embed`` / ``_logits`` on
the rank's weight blocks, ``tensor_parallel.share``), and the shares summed
over the ranks (or, for the head, laid side by side) equal the unsplit
layer in fp32 to 1e-5: query heads with the KV heads they read (MHA, GQA
with and without ``n_kv_heads`` dividing W, MQA), the QKV bias, QK-norm, a
local window with the score softcap, the three MLPs and a ``d_ff`` W does
not divide (no sum), the vocab-parallel embedding and head, tied and
untied, with the final softcap, and a vocabulary W does not divide.

The RG-LRU layer of reduced recurrentgemma-9b (4 gate blocks) the same
way at W 2, 4 and 8: each rank's prefill and decode step on its channels
(``RGLRU.prefill`` / ``decode`` on its weight blocks and its block of the
state), the terms summed against the unsplit layer, each rank's state
block equal to that block of the unsplit state; at W 8, which does not
divide the 4 blocks, the layer is whole on every rank (no sum).

The RWKV-6 layer of reduced rwkv6-7b (d 64, 4 heads of 16, ``d_ff`` 128)
at W 2, 4 and 8: each rank's prefill and 3 decode steps from the carried
state (``tensor_parallel.rwkv_shares`` over ``share``: the time mix on its
heads and its block of the WKV state, the channel mix on its ``d_ff``
block), the time mix's terms summed and the channel mix's blocks laid side
by side, against the unsplit layer; each rank's WKV block equal to that
block of the unsplit state; at W 8, which does not divide the 4 heads, the
time mix is whole on every rank (no sum) and the channel mix splits.

Part (ii), gloo ranks (``tests/_torch_ranks.py``, one run a mesh and
strategy, five models each): ``ShardedModel.prefill`` and 12 greedy
``decode_step`` calls on a (data 2, model 2) mesh under ``fsdp_tp`` and
``serve_2d`` and on (model 4) under ``tp_only`` and ``serve_2d``, for
reduced gemma2-9b, internvl2-76b with its prefix, recurrentgemma-9b
(attention, the MLP and the RG-LRU's channels split), qwen3-moe and
phi3.5-moe (attention split, each rank computing its block of the 8
experts, their term summed over ``model``), rwkv6-7b (the time mix on the
rank's heads, the channel mix on its ``d_ff`` block),
against ``repro.models``' single-process prefill and decode: logits to 2e-4
in fp32 (``test_torch_models.LOGIT_TOL``), greedy tokens equal; the
RG-LRU weight a rank computes with holds its w/M channels (under
``serve_2d`` on (data 2, model 2): ``w_in_rec`` its block at rest, ``w_out``
the rows of the rank's (data, model) chunk, as at rest), the time
mix's ``w_v`` its heads' d/M columns, though it lies on its rows at rest,
and under ``serve_2d`` on (data 2, model 2) internvl2-76b's attention,
MLP, embedding and head weights their ``embed`` block on ``data``, as at
rest (``tests/test_torch_serve_2d.py`` plays that grid in threads).

Part (iii), the dry run's trace: a decode step's collectives do not grow
with the cache (no cache entry moves), the counter files the new
collectives, and under ``fsdp_tp`` a decode step moves no RG-LRU or WKV
state over ``model`` and sums each RG-LRU layer's term over it once, each
RWKV-6 time mix's once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, shapes as shp, steps
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import common
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

from _torch_ranks import run_ranks
from test_torch_launch import _mesh
from test_torch_models import LOGIT_TOL, _reference, _two_threads  # noqa: F401

SHARE_TOL = 1e-5
STEPS = 12
CACHE_LEN = 64

# ---------------------------------------------------------------------------
# Part (i): each rank's share, one process
# ---------------------------------------------------------------------------

_BASE = dataclasses.replace(ARCHS["internvl2-76b"].reduced(), n_layers=1, frontend=None,
                            frontend_seq_len=0)

SHARE_CASES = {
    "mha": dict(n_heads=4, n_kv_heads=4),
    "gqa_kv_divides": dict(n_heads=8, n_kv_heads=4),
    # 2 KV heads: they divide W 2, not W 4 (each rank's query head reads KV head r // 2)
    "gqa_kv_does_not_divide": dict(n_heads=4, n_kv_heads=2),
    # 6 KV heads on W 4: a rank's 3 query heads read KV heads (0, 0, 1), (1, 2, 2), ...
    "gqa_uneven_groups": dict(n_heads=12, n_kv_heads=6),
    "mqa": dict(n_heads=4, n_kv_heads=1),
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True),
    "local_window_softcap": dict(mixer_pattern=("attn_local",), window=8, attn_softcap=5.0,
                                 mlp_type="geglu", final_softcap=3.0, tie_embeddings=True,
                                 embed_scale=True, norm_type="rmsnorm"),
    "gelu_mlp": dict(mlp_type="gelu", norm_type="layernorm"),
    # 130: divides W 2, not W 4 (whole on every rank, no sum)
    "d_ff_does_not_divide": dict(d_ff=130),
    # 510: divides W 2, not W 4 (the lookup and the head whole)
    "vocab_does_not_divide": dict(vocab_size=510),
    "tied_head_final_softcap": dict(tie_embeddings=True, final_softcap=3.0),
}


def _seeded_lm(cfg, seed=0):
    """The LM with every leaf a seeded normal (norm scales, biases and QK-norm
    too, which the init leaves at zero)."""
    lm = build_model(cfg, device="cpu").init(seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lm.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.2 if p.ndim > 1 else 0.1))
    return lm


def _shares(lm, cache, W, run):
    """``run(rank_lm, axis, rank_cache)`` for each rank, on its weight blocks."""
    out = []
    for r in range(W):
        axis, params, rank_cache = tp.share(lm, cache, r, W)
        with _reparametrize_module(lm, params):
            out.append(run(lm, axis, rank_cache))
    return out


def _close(got, want, tol=SHARE_TOL):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", sorted(SHARE_CASES))
def test_summed_shares_equal_the_unsplit_layer(case, W):
    cfg = dataclasses.replace(_BASE, **SHARE_CASES[case])
    lm = _seeded_lm(cfg)
    block = lm.layers[0]
    B, S, L = 2, 12, 16
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    x_new = torch.randn(B, 1, cfg.d_model, generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    positions = torch.arange(S)
    model = build_model(cfg, device="cpu")

    def attention(lm, axis, cache):
        """The layer's attention over the prompt, then one decode step."""
        attn, layer = lm.layers[0].attn, None if axis is None else axis.layer(0)
        h = common.apply_norm(lm.layers[0].norm1, x)
        c = cache["layers"][0]
        out = attn.prefill(h, positions, c, layer)
        step = attn.decode(common.apply_norm(lm.layers[0].norm1, x_new), S, c, layer)
        return out, step, c, layer

    with torch.no_grad():
        full_cache = model.init_cache(B, L, torch.float32)
        want, want_step, want_c, _ = attention(lm, None, full_cache)
        got = _shares(lm, model.init_cache(B, L, torch.float32), W, attention)
        layer = got[0][3]
        n_heads_split = cfg.n_heads % W == 0
        assert layer.attn_sum == n_heads_split
        assert (layer.kv is not None) == (cfg.n_kv_heads % W == 0)
        for i, (out, step) in enumerate(((o, s) for o, s, _, _ in got)):
            heads = got[i][3].q
            assert heads == (shd.Split(1, ("model",), i * cfg.n_heads // W,
                                       (i + 1) * cfg.n_heads // W) if n_heads_split else None)
            # each rank's cache block holds its KV heads (or all) as filled and stepped
            c, kv = got[i][2], got[i][3].kv
            sel = slice(None) if kv is None else slice(kv.lo, kv.hi)
            _close(c["k"], want_c["k"][:, :, sel])
            _close(c["v"], want_c["v"][:, :, sel])
        _close(sum(o for o, _, _, _ in got), want)
        _close(sum(s for _, s, _, _ in got), want_step)

        h = common.apply_norm(block.norm2, x)
        want_mlp = block.mlp(h)
        mlp = _shares(lm, full_cache, W, lambda lm, axis, _: (lm.layers[0].mlp(h),
                                                              axis.layer(0).mlp_sum))
        if cfg.d_ff % W == 0:
            assert all(summed for _, summed in mlp)
            _close(sum(out for out, _ in mlp), want_mlp)
        else:  # whole on every rank: no sum
            for out, summed in mlp:
                assert not summed
                _close(out, want_mlp)

        want_embed, want_logits = lm._embed(tokens), lm._logits(x)
        head = _shares(lm, full_cache, W, lambda lm, axis, _: (
            lm._embed(tokens, model_axis=axis), lm._logits(x), axis.split("embed")))
        if cfg.vocab_size % W == 0:
            assert all(split is not None for _, _, split in head)
            _close(sum(e for e, _, _ in head), want_embed)
            _close(torch.cat([lo for _, lo, _ in head], dim=-1), want_logits)
        else:
            for e, lo, split in head:
                assert split is None
                _close(e, want_embed)
                _close(lo, want_logits)


_RGLRU = dataclasses.replace(ARCHS["recurrentgemma-9b"].reduced(), n_layers=1)


@pytest.mark.parametrize("W", [2, 4, 8])
def test_rglru_shares_equal_the_unsplit_layer(W):
    """Each rank's RG-LRU prefill and decode step on its channels: 4 gate
    blocks split at W 2 and 4, and run whole at W 8."""
    cfg = _RGLRU
    lm = _seeded_lm(cfg)
    rglru = lm.layers[0].rglru
    model = build_model(cfg, device="cpu")
    B, S = 2, 12
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    x_new = torch.randn(B, 1, cfg.d_model, generator=g)

    def run(lm, axis, cache):
        c = cache["layers"][0]
        out = lm.layers[0].rglru.prefill(x, c)
        step = lm.layers[0].rglru.decode(x_new, c)
        return out, step, c, None if axis is None else axis.layer(0)

    with torch.no_grad():
        want, want_step, want_c, _ = run(lm, None, model.init_cache(B, S, torch.float32))
        got = _shares(lm, model.init_cache(B, S, torch.float32), W, run)
    split = rglru.gate_a.shape[0] % W == 0
    width = cfg.rnn_width // W
    for i, (out, step, c, layer) in enumerate(got):
        assert layer.rglru_sum == split
        assert layer.rnn == (shd.Split(0, ("model",), i * width, (i + 1) * width) if split
                             else None)
        sel = slice(i * width, (i + 1) * width) if split else slice(None)
        _close(c["h"], want_c["h"][:, sel])
        _close(c["conv"], want_c["conv"][..., sel])
        if not split:  # whole on every rank: no sum
            _close(out, want)
            _close(step, want_step)
    if split:
        _close(sum(o for o, _, _, _ in got), want)
        _close(sum(s for _, s, _, _ in got), want_step)


_RWKV = dataclasses.replace(ARCHS["rwkv6-7b"].reduced(), n_layers=1)


def _rel_close(got, want, tol=SHARE_TOL):
    """Within ``tol`` of the largest value of ``want``."""
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.parametrize("W", [2, 4, 8])
def test_rwkv_shares_equal_the_unsplit_layer(W):
    """Each rank's RWKV-6 prefill and 3 decode steps from the carried state:
    the time mix on its heads (split at W 2 and 4, whole at W 8, which does
    not divide 4 heads), the channel mix on its ``d_ff`` block (split at W
    2, 4 and 8)."""
    cfg = _RWKV
    lm = _seeded_lm(cfg)
    block = lm.layers[0]
    model = build_model(cfg, device="cpu")
    B, S = 2, 12
    H = cfg.d_model // cfg.rwkv_head_dim
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    steps_in = [torch.randn(B, 1, cfg.d_model, generator=g) for _ in range(3)]
    with torch.no_grad():
        want_c = model.init_cache(B, S, torch.float32)["layers"][0]
        want = [block.prefill(x, torch.arange(S), want_c)]
        want += [block.decode(xi, S + i, want_c) for i, xi in enumerate(steps_in)]
        shares = [tp.share(lm, model.init_cache(B, S, torch.float32), r, W) for r in range(W)]
        got = [tp.rwkv_shares(lm, 0, shares, x, carried=False)]
        got += [tp.rwkv_shares(lm, 0, shares, xi, carried=True) for xi in steps_in]
    heads, ff = H // W, cfg.d_ff // W
    assert (H % W == 0) == (W != 8) and cfg.d_ff % W == 0
    for i, (axis, _, cache) in enumerate(shares):
        layer = axis.layer(0)
        assert layer.tm_sum == (H % W == 0) and layer.cm_sum
        assert layer.tm == (shd.Split(0, ("model",), i * heads, (i + 1) * heads)
                            if layer.tm_sum else None)
        assert layer.cm == shd.Split(0, ("model",), i * ff, (i + 1) * ff)
        c = cache["layers"][0]
        sel = slice(layer.tm.lo, layer.tm.hi) if layer.tm_sum else slice(None)
        assert c["wkv"].shape == (B, len(range(H)[sel]), cfg.rwkv_head_dim, cfg.rwkv_head_dim)
        _rel_close(c["wkv"], want_c["wkv"][:, sel])
        for key in ("tm_shift", "cm_shift"):
            _rel_close(c[key], want_c[key])
    for out, w in zip(got, want):
        _rel_close(out, w)


def test_kv_heads_pair_each_query_head_with_its_group():
    """Query head i reads KV head i // (Hq / Hkv): a slice where a rank's heads
    group evenly, else one KV head per query head."""
    assert tp.kv_heads(0, 4, 64, 8) == slice(0, 1)      # internvl2 at W 16
    assert tp.kv_heads(60, 64, 64, 8) == slice(7, 8)
    assert tp.kv_heads(8, 16, 64, 8) == slice(1, 2)     # W 8
    assert tp.kv_heads(3, 4, 16, 8) == slice(1, 2)      # gemma2 at W 16
    assert tp.kv_heads(0, 3, 12, 6) == [0, 0, 1]
    assert tp.kv_heads(0, 8, 8, 2) == slice(0, 2)


def test_model_split_reads_the_resolved_spec():
    """The helper reports a dim the axis does not divide as unsplit, and a
    dim split over (data, model) by its row-major block."""
    mesh = {"data": 2, "model": 4}
    rules = shd.STRATEGIES["fsdp_tp"]()
    wq = shd.resolve_spec(mesh, rules, ("embed", "heads", "head_dim"), (64, 8, 16))
    assert shd.model_split(mesh, wq, (64, 8, 16), {"data": 1, "model": 3}) == shd.Split(
        1, ("model",), 6, 8)
    wk = shd.resolve_spec(mesh, rules, ("embed", "kv_heads", "head_dim"), (64, 2, 16))
    assert shd.model_split(mesh, wk, (64, 2, 16), {"data": 0, "model": 1}) is None
    rules = shd.STRATEGIES["serve_2d"]()
    k = shd.resolve_spec(mesh, rules, shd.CACHE_LOGICAL["k"], (4, 64, 2, 16))
    assert shd.model_split(mesh, k, (4, 64, 2, 16), {"data": 1, "model": 2}) == shd.Split(
        1, ("data", "model"), 48, 56)


# ---------------------------------------------------------------------------
# Part (ii): gloo ranks against the JAX reference
# ---------------------------------------------------------------------------

MODELS = ["gemma2-9b", "internvl2-76b", "recurrentgemma-9b", "qwen3-moe-235b-a22b",
          "phi3.5-moe-42b-a6.6b", "rwkv6-7b"]
# name -> (strategy, mesh shape, axes)
MESHES = {"fsdp_tp": ("fsdp_tp", (2, 2), ("data", "model")),
          "tp_only": ("tp_only", (4,), ("model",)),
          "serve_2d": ("serve_2d", (4,), ("model",)),
          # the RG-LRU's leaves and state over (data, model), its w_in_rec over model
          "serve_2d_data_model": ("serve_2d", (2, 2), ("data", "model"))}
# the models whose weights' blocks the ranks record, and each leaf's embed
# dim: attention's, the MLP's, the embedding's and the head's, the MoE's, or
# the RWKV-6 mixers'
_DENSE_BLOCKS = {"embed": 1, "unembed": 0, "layers.0.attn.wq": 0, "layers.0.attn.wk": 0,
                 "layers.0.attn.wv": 0, "layers.0.attn.wo": 2, "layers.0.mlp.w_gate": 0,
                 "layers.0.mlp.w_up": 0, "layers.0.mlp.w_down": 1}
_MOE_BLOCKS = {"layers.0.moe.router": 0, "layers.0.moe.w_gate": 1, "layers.0.moe.w_up": 1,
               "layers.0.moe.w_down": 2}
_RWKV_BLOCKS = {"layers.0.tm.w_r": 0, "layers.0.tm.w_k": 0, "layers.0.tm.w_g": 0,
                "layers.0.tm.decay_a": 0, "layers.0.tm.w_v": 1, "layers.0.cm.w_k": 0,
                "layers.0.cm.w_r": 0, "layers.0.cm.w_v": 1}
STATIONARY_BLOCKS = {"internvl2-76b": _DENSE_BLOCKS, "qwen3-moe-235b-a22b": _MOE_BLOCKS,
                     "phi3.5-moe-42b-a6.6b": _MOE_BLOCKS, "rwkv6-7b": _RWKV_BLOCKS}

_RANKS = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.weights import from_jax_params

strategy, shape, axes, cases, cache_len, steps, STATIONARY = inputs
mesh = make_mesh_from_devices(range(world), shape, axes, "cpu")
result = {}
for name, cfg, np_params, batch in cases:
    model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES[strategy]())
    lm = model.shard(from_jax_params(cfg, np_params, device="cpu"))
    cache = model.init_cache(batch["tokens"].shape[0], cache_len, torch.float32)
    with torch.no_grad():
        logits, cache = model.prefill(lm, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      cache)
        out = [logits.full_tensor().numpy()]
        for _ in range(steps):
            logits, cache = model.decode_step(lm, cache, logits.full_tensor().argmax(-1))
            out.append(logits.full_tensor().numpy())
    result[name] = {"logits": out, "pos": cache["pos"],
                    "placements": [(type(p).__name__, getattr(p, "dim", None))
                                   for p in logits.placements]}
    if name in STATIONARY:  # the weights' blocks at rest and computed with, as served
        axis = model.model_axis(lm, cache, model._row_axes((4, 1)), 4, stationary=True)
        with torch.no_grad():
            result[name]["computed_with"] = {
                n: (tuple(p.to_local().shape), tuple(model._weights(axis, ())(n, p).shape))
                for n, p in lm.named_parameters() if n in STATIONARY[name]}
    if cfg.mixer_pattern[0] == "rglru":  # layer 0's w_in_rec and w_out at rest and as served
        axis = model.model_axis(lm, cache, model._row_axes((4, 1)), 4, stationary=True)
        for leaf in ("w_in_rec", "w_out"):
            w = lm.layers[0].rglru.get_parameter(leaf)
            split = axis.split("layers.0.rglru." + leaf)
            with torch.no_grad():
                used = model._weights(axis, ())("layers.0.rglru." + leaf, w)
                whole = w.full_tensor()  # the same block of the whole weight
                for sp in (split, axis.stationary("layers.0.rglru." + leaf)):
                    if sp is not None:
                        whole = whole.narrow(sp.dim, sp.lo, sp.hi - sp.lo)
            result[name][leaf] = (tuple(w.to_local().shape), tuple(used.shape),
                                  (split.dim, split.axes, split.lo, split.hi),
                                  bool(torch.equal(used, whole)),
                                  used.shape == w.to_local().shape
                                  and bool(torch.equal(used, w.to_local())))
    if cfg.mixer_pattern[0] == "rwkv":  # layer 0's time-mix w_v at rest and computed with
        w = lm.layers[0].tm.w_v
        axis = model.model_axis(lm, cache, (), 4)
        split = axis.split("layers.0.tm.w_v")
        with torch.no_grad():
            used = model._weights(axis, ())("layers.0.tm.w_v", w)
            whole = w.full_tensor()
        result[name]["tm.w_v"] = (tuple(w.to_local().shape), tuple(used.shape),
                                  (split.dim, split.lo, split.hi),
                                  bool(torch.equal(used, whole[:, split.lo:split.hi])))
"""


def _batch(cfg, seed=3):
    """B 4 x S 40 tokens (past the reduced window of 32), and internvl2's prefix."""
    rng = np.random.default_rng(seed)
    B, S = 4, 40 - cfg.frontend_seq_len
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_seq_len, cfg.d_model)).astype(np.float32)
    return batch


_JAX = {}


def _jax_run(name):
    """The reference's single-process prefill and 12 greedy decode steps:
    (logits of each call, greedy tokens)."""
    if name not in _JAX:
        jcfg, jmodel, jparams, _, _ = _reference(name)
        batch = _batch(jcfg)
        jcache = jmodel.init_cache(batch["tokens"].shape[0], max_len=CACHE_LEN,
                                   dtype=jnp.float32)
        logits, jcache = jmodel.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jcache)
        decode = jax.jit(jmodel.decode_step)
        out, toks = [np.asarray(logits)], []
        for _ in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, jcache = decode(jparams, jcache, tok)
            out.append(np.asarray(logits))
        _JAX[name] = (out, toks)
    return _JAX[name]


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, tmp_path_factory):
    strategy, shape, axes = MESHES[request.param]
    cases = []
    for name in MODELS:
        _, _, _, np_params, _ = _reference(name)
        cfg = ARCHS[name].reduced()
        cases.append((name, cfg, np_params, _batch(cfg)))
    return request.param, run_ranks(_RANKS, 4, tmp_path_factory.mktemp(request.param),
                                    inputs=(strategy, shape, axes, cases, CACHE_LEN, STEPS,
                                            {m: tuple(b) for m, b in STATIONARY_BLOCKS.items()}),
                                    timeout=180)


@pytest.mark.parametrize("name", MODELS)
def test_sharded_prefill_and_greedy_decode_equal_the_reference(ranks, name):
    strategy, results = ranks
    want, want_tokens = _jax_run(name)
    cfg = ARCHS[name].reduced()
    for res in results:
        got = res[name]
        assert got["pos"] == 40 + STEPS and len(got["logits"]) == STEPS + 1
        # the vocabulary splits over model (512 divides 2 and 4), the last mesh axis
        assert got["placements"][-1] == ("Shard", 2)
        for i, (lo, w) in enumerate(zip(got["logits"], want)):
            assert lo.shape == (4, 1, cfg.vocab_size)
            np.testing.assert_allclose(lo, w, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"{strategy} {name} call {i}")
        tokens = [lo.argmax(-1) for lo in got["logits"][:-1]]
        for t, w in zip(tokens, want_tokens):
            np.testing.assert_array_equal(t, w)
    for res in results[1:]:  # every rank sees the same global logits
        for a, b in zip(res[name]["logits"], results[0][name]["logits"]):
            np.testing.assert_array_equal(a, b)


def test_a_ranks_rglru_weight_holds_its_channels(ranks):
    """recurrentgemma-9b's 4 gate blocks split over model 2 and 4, as each
    rank serves: the w_in_rec it computes with is its ``model`` block of
    columns of the whole [d, w/M], gathered over ``data`` where ``embed``
    takes it at rest (``fsdp_tp``; without a ``data`` axis it lies so), but
    under ``serve_2d`` on (data 2, model 2) its block at rest [d/2, w/2],
    the ``embed`` dim on ``data``;
    ``w_out``'s rows are its ``model`` block [w/M, d], but there its chunk
    ``d M + m`` of the (data, model) chunks [w/4, d], as at rest (no weight
    of the layer moves)."""
    mesh, results = ranks
    strategy, shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    D, M = sizes.get("data", 1), sizes["model"]
    chunked = strategy == "serve_2d" and D > 1
    cfg = ARCHS["recurrentgemma-9b"].reduced()
    d, w = cfg.d_model, cfg.rnn_width
    for rank, res in enumerate(results):
        at_rest, used, split, whole_block, as_at_rest = res["recurrentgemma-9b"]["w_in_rec"]
        m = rank % M  # model is the last mesh axis
        assert used == (d // D if chunked else d, w // M) and whole_block
        assert split == (1, ("model",), m * w // M, (m + 1) * w // M)
        assert at_rest == (d // D, w // M)
        assert as_at_rest == (chunked or strategy != "fsdp_tp")
        at_rest, used, split, whole_block, as_at_rest = res["recurrentgemma-9b"]["w_out"]
        n, c = (D * M, rank) if chunked else (M, m)  # rank = d M + m
        assert used == (w // n, d) and whole_block
        assert split == (0, ("data", "model") if chunked else ("model",),
                         c * w // n, (c + 1) * w // n)
        assert as_at_rest == (chunked or strategy != "fsdp_tp")


@pytest.mark.parametrize("model", sorted(STATIONARY_BLOCKS))
def test_a_ranks_weights_keep_their_embed_block_under_serve_2d(ranks, model):
    """internvl2-76b's attention, MLP, embedding and head weights,
    qwen3-moe's and phi3.5-moe's MoE router and expert leaves, and
    rwkv6-7b's time mix and channel mix leaves (but ``decay_b``), as a rank
    computes with them: under ``serve_2d`` on (data 2, model 2) each is its
    block at rest, the ``embed`` dim on ``data`` (nothing moves over
    ``data``; the time mix's ``w_v`` stays on its rows, no all-to-all); on
    the other meshes the ``embed`` dim is whole (gathered over ``data``
    under ``fsdp_tp``, whole at rest without a ``data`` axis), but the time
    mix's ``w_v``'s, which is there its heads' d/M columns (moved to them
    from its rows over ``model``)."""
    mesh, results = ranks
    strategy, shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    stays = strategy == "serve_2d" and sizes.get("data", 1) > 1
    cfg = ARCHS[model].reduced()
    d = cfg.d_model
    for res in results:
        blocks = res[model]["computed_with"]
        assert set(blocks) == set(STATIONARY_BLOCKS[model])
        for name, (at_rest, used) in blocks.items():
            dim = STATIONARY_BLOCKS[model][name]
            whole = d // sizes["model"] if name == "layers.0.tm.w_v" else d
            assert used[dim] == (d // 2 if stays else whole), (name, used)
            assert at_rest[dim] == d // sizes.get("data", 1)
            if stays:
                assert used == at_rest, name


def test_a_ranks_rwkv_value_weight_holds_its_heads_columns(ranks):
    """rwkv6-7b's time mix splits its 4 heads over model 2 and 4: the ``w_v``
    a rank computes with is [d, d/M], its heads' columns of the whole
    weight, while at rest it lies on its ``model`` block of rows (the
    channel mix's ``w_v`` rule, by leaf name; over ``data`` too where
    ``embed`` takes its columns)."""
    mesh, results = ranks
    _, shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    d, M = ARCHS["rwkv6-7b"].reduced().d_model, sizes["model"]
    for rank, res in enumerate(results):
        at_rest, used, split, equal = res["rwkv6-7b"]["tm.w_v"]
        m = rank % M  # model is the last mesh axis
        assert used == (d, d // M) and split == (1, m * d // M, (m + 1) * d // M) and equal
        assert at_rest == (d // M, d // sizes.get("data", 1))


# ---------------------------------------------------------------------------
# Part (iii): what the dry run's trace sees
# ---------------------------------------------------------------------------

def _decode_costs(cfg, strategy, cache_len, mesh_shape=(2, 2)):
    cell = shp.ShapeCell("tiny", cache_len, 4, "decode")
    with _mesh(mesh_shape) as mesh:
        step = steps.build_serve_step(cfg, cell, mesh, strategy)
        return dryrun.trace(step)


@pytest.mark.parametrize("strategy", ["fsdp_tp", "serve_2d"])
def test_a_decode_step_moves_no_cache_entry(strategy):
    """Collective bytes do not depend on the cache's length: a step moves the
    new token's K/V row at most, never a cache entry."""
    cfg = ARCHS["internvl2-76b"].reduced()
    short, long = (_decode_costs(cfg, strategy, n) for n in (64, 256))
    assert short["by_kind"] == long["by_kind"] and short["n_collectives"] > 0
    assert set(short["by_kind"]) == {"all-gather", "all-reduce"}


def test_a_decode_step_moves_no_rglru_state_over_model():
    """Reduced recurrentgemma-9b (8 layers: 6 RG-LRU, 2 local attention) on a
    (data 2, model 2) mesh under ``fsdp_tp``: over ``model`` a decode step
    sums the stream once for the lookup, once a layer for the MLP and once
    for each attention and each RG-LRU layer's row-parallel term (1 + 8 + 2
    + 6 = 17), merges each attention layer's partial softmax (a max and a
    sum) and gathers its query heads; the RG-LRU state lies at rest as the
    rank computes it, so no other collective runs over ``model``."""
    cfg = ARCHS["recurrentgemma-9b"].reduced()
    kinds = [cfg.mixer_pattern[i % 3] for i in range(cfg.n_layers)]
    n_rglru, n_attn = kinds.count("rglru"), kinds.count("attn_local")
    assert (n_rglru, n_attn) == (6, 2)
    cell = shp.ShapeCell("tiny", 64, 4, "decode")
    with _mesh((2, 2)) as mesh:
        step = steps.build_serve_step(cfg, cell, mesh, "fsdp_tp")
        counter = OpCounter()
        with counter:
            step()
    ops = [op for op in counter.collectives if op.ranks == (0, 1)]
    stream = 2 * 1 * cfg.d_model * 2  # a rank's 2 rows of one token, bf16
    sums = [op for op in ops if op.kind == "all-reduce" and op.bytes == stream]
    assert len(sums) == 1 + cfg.n_layers + n_attn + n_rglru
    others = sorted(op.kind for op in ops if op not in sums)
    assert others == ["all-gather"] * n_attn + ["all-reduce"] * 2 * n_attn


def test_prefill_counts_the_all_to_all_and_the_sums():
    """With KV heads split over model and the cache over the sequence, each
    attention layer's prefill is one all-to-all of K and one of V over model;
    each layer sums attention and the MLP, and the lookup is summed once."""
    cfg = ARCHS["internvl2-76b"].reduced()  # 2 KV heads on a model axis of 2
    cell = shp.ShapeCell("tiny", 32, 4, "prefill")
    with _mesh((2, 2)) as mesh:
        step = steps.build_prefill_step(cfg, cell, mesh)
        counter = OpCounter()
        with counter:
            step()
    kinds = [op.kind for op in counter.collectives]
    assert kinds.count("all-to-all") == 2 * cfg.n_layers
    assert kinds.count("all-reduce") == 2 * cfg.n_layers + 1


def test_a_decode_step_moves_no_wkv_state_over_model():
    """rwkv6-7b reduced with the kernel's head size (d 128: 2 heads of 64, so
    the dry run's fake kernel takes it; 2 layers) on a (data 2, model 2)
    mesh under ``fsdp_tp``: over ``model`` a decode step sums the stream
    once for the lookup; each layer sums its time mix's term once (one
    all-reduce), reduce-scatters and all-gathers its channel mix's (the
    bytes of one all-reduce each), gathers its two shift states (the next
    token's mixes read them whole) and moves its time mix's ``w_v`` block
    from rows to columns (one all-to-all of the rank's [d, d/M] block). The
    WKV state lies at rest on the rank's heads, as it computes them: no
    other collective runs over ``model``."""
    cfg = dataclasses.replace(ARCHS["rwkv6-7b"].reduced(), d_model=128, rwkv_head_dim=64)
    assert cfg.n_layers == 2 and cfg.d_model // cfg.rwkv_head_dim == 2
    cell = shp.ShapeCell("tiny", 64, 4, "decode")
    with _mesh((2, 2)) as mesh:
        step = steps.build_serve_step(cfg, cell, mesh, "fsdp_tp")
        counter = OpCounter()
        with counter:
            step()
    ops = [(op.kind, op.bytes) for op in counter.collectives if op.ranks == (0, 1)]
    d, L = cfg.d_model, cfg.n_layers
    stream = 2 * 1 * d * 2  # a rank's 2 rows of one token, bf16; a shift state's too
    w_v = d * (d // 2) * 2  # the rank's [d, d/2] block of w_v, bf16
    per_layer = ([("all-gather", stream)] * 2 + [("all-to-all", w_v), ("all-reduce", stream),
                 ("reduce-scatter", stream), ("all-gather", stream)])
    assert sorted(ops) == sorted([("all-reduce", stream)] + per_layer * L)
    wkv = 2 * 1 * 64 * 64 * 4  # a rank's [2, 1, 64, 64] fp32 block of the state
    assert all(b != wkv for _, b in ops)
