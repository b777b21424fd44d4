"""``serve_2d``'s weight-stationary serving (``repro_torch.parallel``) on the
CPU: each weight of attention, the dense MLP, the MoE (router and
experts), the RWKV-6 time mix and channel mix (all but ``tm.decay_b``),
whisper's encoder and decoder blocks (all but the cross-attention's ``wk``
and ``wv``), the embedding and the head keeps its ``embed`` block on ``data``
(``ModelAxis.stationary``), and the products it enters are summed or
gathered over ``data`` instead.

Part (i), the grid in threads: on a ``ThreadRanks`` grid of (data 2 x model
2) and (data 2 x model 4), every rank at once computes a reduced one-layer
LM from its blocks (``tensor_parallel.thread_shares`` over ``share`` with
a grid coordinate): the lookup, the layer's prefill and 3 decode steps over
its block of the K/V cache, split by positions over (data, model), and the
head. Each rank's stream (after the lookup and after the layer) equals the
unsplit one, its logits block equals that block of the unsplit logits, and
its cache block those positions of the unsplit cache, in fp32 within 1e-5
of the largest value (``SHARE_TOL``):
MHA, GQA with and without ``n_kv_heads`` dividing ``model``, MQA, the QKV
bias, QK-norm, a local window with the score softcap, the three MLPs, a
tied and an untied head with the final softcap, and the scaled
embedding; and a reduced one-layer qwen3-moe and phi3.5-moe (8 experts,
d 64), each rank computing with its (experts x embed block) of every
expert leaf and its embed block of the router, also with 6 experts,
which model 4 does not divide (the ff form: every expert's ff block x
embed block), every rank's routing (``top_idx``, ``keep``, ``slot``) equal
to the unsplit one's; and a reduced one-layer rwkv6-7b (d 64, 4 heads of
16, ``d_ff`` 128), each rank computing with its (embed block x model
block) of the mixers' weights (``w_v``: its model block of rows x embed
block of columns), its WKV state block on its heads and its shifts equal
to the unsplit ones; and a reduced one-layer recurrentgemma-9b RG-LRU
layer (d 64, width 64 in 4 gate blocks of 16; also 8 of 8 and 2 of 32),
each rank computing on its (data, model) chunk of the channels
(``conv_w``, ``conv_b``, ``lam``, ``w_out``'s rows and its state ``h`` and
``conv`` there, as at rest; ``w_in_rec`` and ``w_in_gate`` on their (embed
block x model block)): a chunk a block, half a block, two blocks, or, on a
third grid (data 4 x model 2), a quarter of a block that spans two model
groups; a width the D M chunks do not divide, a chunk straddling a block's
edge and ``fsdp_tp`` on the gathered ``model`` block; its state chunk
equal to that chunk of the unsplit state; and a reduced whisper-medium (one
encoder and one decoder block, d 64, 4 heads, ``d_ff`` 128, 20 frames):
each rank's encode (an encode share, no cache), its lookup, 3 decode steps
over its block of a seeded self cache and its tied head's logits block,
at vocab 512 and 510 (which model 4 does not divide), with and without the
QKV bias. Where ``data`` does not divide
``d_model``, and under ``fsdp_tp`` (the rows lie on ``data``), the
weights are gathered as in
training: no block stays, and the rank computes with whole ``embed`` dims.

Part (ii), the dry run's trace: a decode step of reduced internvl2-76b
under ``serve_2d`` on a (data 2, model 2) mesh moves only activations of
the rank's rows over ``data``: the stream's gathers after the lookup and
each row product, one all-reduce of each column product's output, the
attention's partial-softmax merge over the cache's positions (the
parent's too) and the head's logits block, byte for byte as the shapes
give them; none as large as the smallest weight block the weights' gather
moved before. The same step of reduced qwen3-moe moves no expert or router
block over ``data``: beside the attention's activations, the router's
logits and the experts' stacked partial pre-activations are summed, and
the MoE's block of columns is gathered. A reduced rwkv6-7b step moves no
mixer weight over ``data`` but ``tm.decay_b`` and takes no all-to-all. A
reduced recurrentgemma-9b step moves no RG-LRU weight or state entry: its
input products are summed over ``data`` and taken to the rank's chunk by
one all-to-all over ``model``, its output summed over both axes. A reduced
whisper-medium step moves no weight block over ``data`` but the
cross-attention's ``wk`` and ``wv``, and no part of the tied embedding.

The gloo ranks against the JAX reference are
``tests/test_torch_tp_serve.py``'s ``serve_2d_data_model`` mesh.
"""

import contextlib
import copy
import dataclasses
import os
import sys
import threading
import types

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import cuda_build
from repro_torch.launch import shapes as shp, steps
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.model_zoo import build_model
from repro_torch.models.moe import capacity
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

from test_torch_launch import _mesh
from test_torch_models import _two_threads  # noqa: F401
from test_torch_tp_serve import _rel_close, _seeded_lm

# ---------------------------------------------------------------------------
# Part (i): the grid in threads
# ---------------------------------------------------------------------------

_BASE = dataclasses.replace(ARCHS["internvl2-76b"].reduced(), n_layers=1, frontend=None,
                            frontend_seq_len=0)
# the weights whose embed block stays under serve_2d, and the dim of that
# block (None: one with an embed dim that is gathered all the same)
STATIONARY = {"embed": 1, "unembed": 0, "layers.0.attn.wq": 0, "layers.0.attn.wk": 0,
              "layers.0.attn.wv": 0, "layers.0.attn.wo": 2, "layers.0.mlp.w_gate": 0,
              "layers.0.mlp.w_up": 0, "layers.0.mlp.w_down": 1,
              "layers.0.moe.router": 0, "layers.0.moe.w_up": 1, "layers.0.moe.w_gate": 1,
              "layers.0.moe.w_down": 2,
              "layers.0.tm.w_r": 0, "layers.0.tm.w_k": 0, "layers.0.tm.w_g": 0,
              "layers.0.tm.decay_a": 0, "layers.0.tm.w_v": 1, "layers.0.tm.decay_b": None,
              "layers.0.cm.w_k": 0, "layers.0.cm.w_r": 0, "layers.0.cm.w_v": 1,
              "layers.0.rglru.w_in_rec": 0, "layers.0.rglru.w_in_gate": 0,
              "layers.0.rglru.w_out": None,
              "enc_blocks.0.attn.wq": 0, "enc_blocks.0.attn.wk": 0, "enc_blocks.0.attn.wv": 0,
              "enc_blocks.0.attn.wo": 2, "enc_blocks.0.mlp.w_up": 0,
              "enc_blocks.0.mlp.w_down": 1,
              "dec_blocks.0.attn.wq": 0, "dec_blocks.0.attn.wk": 0, "dec_blocks.0.attn.wv": 0,
              "dec_blocks.0.attn.wo": 2, "dec_blocks.0.xattn.wq": 0,
              "dec_blocks.0.xattn.wk": None, "dec_blocks.0.xattn.wv": None,
              "dec_blocks.0.xattn.wo": 2, "dec_blocks.0.mlp.w_up": 0,
              "dec_blocks.0.mlp.w_down": 1}
QWEN, PHI, RWKV = "qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b"
RG = "recurrentgemma-9b"

GRID_CASES = {
    "mha": dict(n_heads=4, n_kv_heads=4),
    "gqa_kv_divides": dict(n_heads=8, n_kv_heads=4),
    # 2 KV heads: they divide model 2, not model 4 (K/V replicated over model)
    "gqa_kv_does_not_divide": dict(n_heads=4, n_kv_heads=2),
    "mqa": dict(n_heads=4, n_kv_heads=1),
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True),
    "local_window_softcap": dict(mixer_pattern=("attn_local",), window=8, attn_softcap=5.0,
                                 mlp_type="geglu", final_softcap=3.0, tie_embeddings=True,
                                 embed_scale=True, norm_type="rmsnorm"),
    "gelu_mlp": dict(mlp_type="gelu", norm_type="layernorm"),
    "untied_head_final_softcap": dict(final_softcap=3.0),
    "tied_head": dict(tie_embeddings=True),
    # 63: data does not divide it (the embed dim resolves to whole: gathered)
    "d_model_does_not_divide": dict(d_model=63),
    # the rows lie on data: the weights are gathered, as in training
    "fsdp_tp": dict(strategy="fsdp_tp"),
    # the MoE (8 experts, top-2, d 64, ff 128): the experts split over model
    "moe_qwen3": dict(arch=QWEN),
    "moe_phi35": dict(arch=PHI),
    # 6 experts: model 2 splits them, model 4 every expert's ff (the ff form)
    "moe_6_experts": dict(arch=PHI, n_experts=6),
    "moe_d_model_does_not_divide": dict(arch=QWEN, d_model=63),
    "moe_fsdp_tp": dict(arch=QWEN, strategy="fsdp_tp"),
    # RWKV-6 (d 64, 4 heads of 16, d_ff 128): the time mix on the rank's
    # heads, the channel mix on its d_ff block, each with its embed block
    "rwkv6": dict(arch=RWKV),
    # 2 heads: model 4 does not divide them, so the time mix runs whole and
    # its weights are gathered over data; the channel mix's blocks stay
    "rwkv6_2_heads": dict(arch=RWKV, rwkv_head_dim=32),
    "rwkv6_fsdp_tp": dict(arch=RWKV, strategy="fsdp_tp"),
    # the RG-LRU (d 64, width 64, 4 gate blocks of 16) on the rank's (data,
    # model) chunk of the channels: a block at data2_model2, half a block at
    # data2_model4
    "rglru": dict(arch=RG),
    # 8 gate blocks of 8: a chunk spans two at data2_model2, one at data2_model4
    "rglru_8_blocks": dict(arch=RG, n_heads=8),
    # width 36 (4 blocks of 9): data2_model4's 8 chunks do not divide it (the
    # model block, gathered, as before); at data2_model2 a chunk is a block
    "rglru_width_does_not_divide": dict(arch=RG, rnn_width=36),
    # width 48, 6 blocks of 8: a chunk of 12 straddles a block's edge at
    # data2_model2 (gathered); model 4 does not divide 6 blocks (the layer whole)
    "rglru_chunk_straddles": dict(arch=RG, rnn_width=48, n_heads=6),
    "rglru_fsdp_tp": dict(arch=RG, strategy="fsdp_tp"),
    # 2 gate blocks of 32: on data4_model2 a block holds 4 chunks of 8, two
    # model groups' (the chunks gathered over model, then over data)
    "rglru_2_blocks": dict(arch=RG, n_heads=2),
}
GRIDS = {"data2_model2": {"data": 2, "model": 2}, "data2_model4": {"data": 2, "model": 4}}
# a grid for the one case that needs it
EXTRA_GRIDS = {"rglru_2_blocks": {"data4_model2": {"data": 4, "model": 2}}}
B, S, L, DECODE_STEPS = 4, 12, 16, 3


def _rows(axis, batch=B):
    """The rank's rows of the global batch: a block over the row axes."""
    index, n = 0, 1
    for a in axis.row_axes:
        index, n = index * axis.sizes[a] + axis.coord[a], n * axis.sizes[a]
    return slice(index * batch // n, (index + 1) * batch // n)


@pytest.mark.parametrize("case, grid", [(c, g) for c in sorted(GRID_CASES) for g in sorted(GRIDS)]
                         + [(c, g) for c, grids in EXTRA_GRIDS.items() for g in grids])
def test_grid_ranks_equal_the_unsplit_lm(case, grid):
    kw = dict(GRID_CASES[case])
    strategy = kw.pop("strategy", "serve_2d")
    arch = kw.pop("arch", None)
    base = _BASE if arch is None else dataclasses.replace(ARCHS[arch].reduced(), n_layers=1)
    cfg = dataclasses.replace(base, **kw)
    sizes = {**GRIDS, **EXTRA_GRIDS.get(case, {})}[grid]
    D, M = sizes["data"], sizes["model"]
    lm = _seeded_lm(cfg)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    fed = [torch.randint(0, cfg.vocab_size, (B, 1), generator=g) for _ in range(DECODE_STEPS)]
    positions = torch.arange(S)

    def run(m, axis, cache):
        """(stream after the lookup, after the layer, logits) of the prefill
        and each decode step, the layer's cache, and each call's MoE route."""
        rows = slice(None) if axis is None else _rows(axis)
        layer = None if axis is None else axis.layer(0)
        c = cache["layers"][0]
        routes = _record_routes(m.layers[0])
        x = m._embed(tokens[rows], model_axis=axis)
        h = m.layers[0].prefill(x, positions, c, layer)
        outs = [(x, h, m._logits(h[:, -1:], axis))]
        for t, tok in enumerate(fed):
            x = m._embed(tok[rows], model_axis=axis)
            h = m.layers[0].decode(x, S + t, c, layer)
            outs.append((x, h, m._logits(h, axis)))
        if hasattr(m.layers[0], "moe"):
            del m.layers[0].moe._route, m.layers[0].moe._logits
        return outs, axis, c, routes

    rules = shd.STRATEGIES[strategy]()
    with torch.no_grad():
        want, _, want_c, want_routes = run(lm, None, model.init_cache(B, L, torch.float32))
        got, _ = tp.thread_shares(lm, None, 0, sizes, model.init_cache(B, L, torch.float32),
                                  run, rules)
    stays = strategy == "serve_2d" and cfg.d_model % D == 0
    width = cfg.d_model // D if stays else cfg.d_model
    assert len(want_routes) == (1 + DECODE_STEPS if cfg.is_moe else 0)
    rwkv, rglru = (cfg.mixer_pattern[0] == k for k in ("rwkv", "rglru"))
    # the time mix keeps its blocks only on the rank's heads
    tm_splits = rwkv and (cfg.d_model // cfg.rwkv_head_dim) % M == 0
    # the RG-LRU serves on its (data, model) chunk where D M divides the width,
    # M the gate blocks, and a chunk and a block do not straddle
    w, nb, n = cfg.rnn_width, cfg.n_heads, D * M
    chunked = (rglru and strategy == "serve_2d" and w % n == 0 and nb % M == 0
               and (n % nb == 0 or nb % n == 0))
    for r, (outs, axis, c, routes) in enumerate(got):
        d, m = r // M, r % M
        assert axis.coord == {"data": d, "model": m}
        assert axis.row_axes == (() if strategy == "serve_2d" else ("data",))
        for name, dim in STATIONARY.items():
            block = axis.stationary(name)
            keeps = (stays and dim is not None and name in axis.shapes
                     and (tm_splits or ".tm." not in name)
                     and (chunked or ".rglru." not in name))
            assert block == (shd.Split(dim, ("data",), d * width, (d + 1) * width)
                             if keeps else None), name
        rows = _rows(axis)
        vocab = axis.head
        for (x, h, logits), (wx, wh, wl) in zip(outs, want):
            _rel_close(x, wx[rows])
            _rel_close(h, wh[rows])
            _rel_close(logits, wl[rows][..., vocab.lo:vocab.hi])
        if rwkv:  # the WKV state's block on the rank's heads, the shifts whole
            heads, H = axis.layer(0).tm, cfg.d_model // cfg.rwkv_head_dim
            assert axis.layer(0).cm is not None
            if tm_splits:
                assert heads.hi - heads.lo == H // M
                assert axis.split("layers.0.tm.w_v").dim == (0 if stays else 1)
            else:
                assert heads is None and axis.split("layers.0.tm.w_v") is None
                heads = shd.Split(1, (), 0, H)
            _rel_close(c["wkv"], want_c["wkv"][rows, heads.lo:heads.hi])
            for k in ("tm_shift", "cm_shift"):
                _rel_close(c[k], want_c[k][rows])
            continue
        if rglru:  # the state's (data, model) chunk, else its model block, or whole
            layer, c_index = axis.layer(0), d * M + m
            chunk = shd.Split(0, ("data", "model"), c_index * w // n, (c_index + 1) * w // n)
            block = shd.Split(0, ("model",), m * w // M, (m + 1) * w // M)
            assert layer.rnn == (chunk if chunked else block if nb % M == 0 else None)
            assert layer.rglru_block == (chunk if chunked else None)
            if chunked:  # w_out's rows and the conv's taps lie on the chunk; the gates whole
                assert axis.split("layers.0.rglru.w_out") == chunk
                assert axis.split("layers.0.rglru.conv_w") == chunk._replace(dim=1)
                assert axis.split("layers.0.rglru.gate_a") is None
                assert axis.split("layers.0.rglru.w_in_rec") == block._replace(dim=1)
            sel = slice(None) if layer.rnn is None else slice(layer.rnn.lo, layer.rnn.hi)
            _rel_close(c["h"], want_c["h"][rows, sel])
            _rel_close(c["conv"], want_c["conv"][rows][..., sel])
            continue
        heads = axis.layer(0).q  # the rank's query heads (all split at M 2 and 4 here)
        assert heads is not None and heads.hi - heads.lo == cfg.n_heads // M
        # the rank's block of the cache: its rows and positions (seq over
        # (data, model) under serve_2d, over model under fsdp_tp)
        seq, length = axis.layer(0).seq, want_c["k"].shape[1]  # a window's ring: 8
        assert seq.hi - seq.lo == length // (D * M if strategy == "serve_2d" else M)
        for k in ("k", "v"):
            _rel_close(c[k], want_c[k][rows, seq.lo:seq.hi])
        if cfg.is_moe:  # every rank routes the global batch as one process
            experts = axis.layer(0).experts
            assert experts.dim == (0 if cfg.n_experts % M == 0 else 2)
            assert len(routes) == len(want_routes)
            for (route, z), (want_route, want_z) in zip(routes, want_routes):
                k = cfg.experts_per_token
                assert torch.equal(_choices(z, k), _choices(want_z, k))
                assert torch.equal(route.keep, want_route.keep)
                assert torch.equal(route.slot, want_route.slot)


def _record_routes(block):
    """Each call's (route, router logits) of ``block``'s MoE (none without
    one), kept as the calls make them."""
    calls = []
    moe = getattr(block, "moe", None)
    if moe is not None:
        route, logits = type(moe)._route, type(moe)._logits

        def recorded(*a, **k):  # the logits are recorded inside, into the new entry
            calls.append([])
            calls[-1].insert(0, route(moe, *a, **k))
            return calls[-1][0]

        moe._route = recorded
        moe._logits = lambda *a, **k: calls[-1].append(logits(moe, *a, **k)) or calls[-1][-1]
    return calls


def _choices(logits, k):
    """The k experts each token chooses, in order, as ``MoE._route`` sorts
    its probabilities (``top_idx``)."""
    probs = torch.softmax(logits, dim=-1)
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]


WHISPER = "whisper-medium"
# reduced whisper-medium at one encoder and one decoder block (d 64, 4/2 self
# heads and 4 cross heads of 16, d_ff 128, the QKV bias, a tied head)
_WHISPER = dataclasses.replace(ARCHS[WHISPER].reduced(), n_layers=1, n_encoder_layers=1)
WHISPER_CASES = {
    "vocab_512": {},
    # model 4 does not divide 510: the lookup and the head whole along model
    "vocab_510": dict(vocab_size=510),
    "no_qkv_bias": dict(qkv_bias=False),
    "d_model_does_not_divide": dict(d_model=63),
    "fsdp_tp": dict(strategy="fsdp_tp"),
}
# B 4 x 20 frames (past the reduced 16-row enc_pos: the positions tile); a
# seeded 16-slot self cache, 3 decode steps from position 3, which cross a
# block of positions at data2_model2 (4 a rank) and at data2_model4 (2)
WHISPER_B, WHISPER_T, WHISPER_L, WHISPER_START = 4, 20, 16, 3


@pytest.mark.parametrize("case, grid", [(c, g) for c in sorted(WHISPER_CASES)
                                        for g in sorted(GRIDS)])
def test_whisper_grid_ranks_equal_the_unsplit_model(case, grid):
    """Reduced whisper-medium on a (data x model) grid in threads: every rank
    encodes its rows (``thread_shares`` with no cache and ``rows``: an
    encode share asks for the stationary blocks), then, fed its own memory,
    looks up 3 tokens, decodes them over its block of the seeded self cache
    and takes the tied head. Its memory, its stream after the lookup and
    after the decoder block, its logits block and its cache block equal
    the unsplit model's within 1e-5 of the largest (fp32). Under
    ``serve_2d`` each block's weights and the embedding keep their ``embed``
    block (``STATIONARY``; the cross-attention's ``wk`` and ``wv`` do not),
    also in the encode share; where ``data`` does not divide ``d_model``,
    and under ``fsdp_tp``, none does. The QKV bias (whisper's, seeded
    non-zero) is added once after the sum over ``data``: once a ``data``
    rank would move every q, k and v."""
    kw = dict(WHISPER_CASES[case])
    strategy = kw.pop("strategy", "serve_2d")
    cfg = dataclasses.replace(_WHISPER, **kw)
    sizes = GRIDS[grid]
    D, M = sizes["data"], sizes["model"]
    model = _seeded_lm(cfg)
    if cfg.qkv_bias:
        assert model.dec_blocks[0].xattn.bq.abs().min() > 0
    api = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    frames = torch.randn(WHISPER_B, WHISPER_T, cfg.d_model, generator=g)
    fed = [torch.randint(0, cfg.vocab_size, (WHISPER_B, 1), generator=g)
           for _ in range(DECODE_STEPS)]
    cache = api.init_cache(WHISPER_B, WHISPER_L, torch.float32)
    for leaf in cache["self"][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    want_cache = copy.deepcopy(cache)
    rules = shd.STRATEGIES[strategy]()

    def encode(m, axis, _):
        rows = slice(None) if axis is None else _rows(axis, WHISPER_B)
        return m.encode(frames[rows], model_axis=axis), axis

    def decode(m, axis, c, memory):
        """(stream after the lookup, after the block, logits) of each step."""
        rows = slice(None) if axis is None else _rows(axis, WHISPER_B)
        layer = None if axis is None else axis.layer(0, "dec_blocks")
        memory = memory if axis is None else axis.memory_in(memory)
        outs = []
        for t, tok in enumerate(fed):
            pos = WHISPER_START + t
            x = m._embed(tok[rows], axis) + m.dec_pos[pos]
            h = m.dec_blocks[0].decode(x, pos, c["self"][0], memory, layer)
            outs.append((x, h, m._logits(h, axis)))
        return outs, axis

    with torch.no_grad():
        want_memory = encode(model, None, None)[0]
        want = decode(model, None, want_cache, want_memory)[0]
        encoded, _ = tp.thread_shares(model, None, 0, sizes, None, encode, rules,
                                      rows=WHISPER_B)
        memories = [mem for mem, _ in encoded]
        got, caches = tp.thread_shares(
            model, None, 0, sizes, cache,
            lambda m, axis, c: decode(m, axis, c, memories[axis.coord["data"] * M
                                                           + axis.coord["model"]]),
            rules)
    stays = strategy == "serve_2d" and cfg.d_model % D == 0
    width = cfg.d_model // D if stays else cfg.d_model
    for r, ((outs, axis), (_, enc_axis), memory, c) in enumerate(
            zip(got, encoded, memories, caches)):
        d, m = r // M, r % M
        assert axis.coord == enc_axis.coord == {"data": d, "model": m}
        assert axis.row_axes == enc_axis.row_axes == (
            () if strategy == "serve_2d" else ("data",))
        for view in (axis, enc_axis, enc_axis.on("enc_blocks")):
            for name, dim in STATIONARY.items():
                keeps = stays and dim is not None and name in view.shapes
                assert view.stationary(name) == (
                    shd.Split(dim, ("data",), d * width, (d + 1) * width) if keeps else None), name
        rows = _rows(axis, WHISPER_B)
        _rel_close(memory, want_memory[rows])
        vocab = axis.head
        assert (vocab is None) == (cfg.vocab_size % M != 0)
        cols = slice(None) if vocab is None else slice(vocab.lo, vocab.hi)
        for (x, h, logits), (wx, wh, wl) in zip(outs, want):
            _rel_close(x, wx[rows])
            _rel_close(h, wh[rows])
            _rel_close(logits, wl[rows][..., cols])
        layer = axis.layer(0, "dec_blocks")
        assert layer.attn_sum and layer.xattn_sum and layer.mlp_sum
        seq = layer.seq  # positions over (data, model) under serve_2d, model under fsdp_tp
        assert seq.hi - seq.lo == WHISPER_L // (D * M if strategy == "serve_2d" else M)
        for k in ("k", "v"):
            _rel_close(c["self"][0][k], want_cache["self"][0][k][rows, seq.lo:seq.hi])
    # the steps wrote positions 3..5 of the unsplit cache
    assert not torch.equal(want_cache["self"][0]["k"], cache["self"][0]["k"])


def test_a_share_holds_its_embed_and_model_block():
    """A grid coordinate's share: each stationary weight is a view of its
    (embed block x model block); the norms are whole along d, the QKV bias
    the rank's heads."""
    cfg = dataclasses.replace(_BASE, qkv_bias=True)
    lm = _seeded_lm(cfg)
    cache = build_model(cfg, device="cpu").init_cache(B, L, torch.float32)
    d, H, hd, ff, V = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    axis, params, rank_cache = tp.share(lm, cache, {"data": 1, "model": 1},
                                        {"data": 2, "model": 2}, shd.STRATEGIES["serve_2d"]())
    assert tuple(params["layers.0.attn.wq"].shape) == (d // 2, H // 2, hd)
    assert tuple(params["layers.0.attn.wo"].shape) == (H // 2, hd, d // 2)
    assert tuple(params["layers.0.mlp.w_down"].shape) == (ff // 2, d // 2)
    assert tuple(params["embed"].shape) == (V // 2, d // 2)
    assert tuple(params["unembed"].shape) == (d // 2, V // 2)
    assert tuple(params["layers.0.attn.bq"].shape) == (H // 2, hd)
    assert tuple(params["layers.0.norm1"].shape) == (d,)
    assert torch.equal(params["layers.0.attn.wq"], lm.layers[0].attn.wq[d // 2:, H // 2:])
    assert torch.equal(params["embed"], lm.embed[V // 2:, d // 2:])
    # alone, the cache's sequence is whole: it splits its KV heads as the weights
    assert tuple(rank_cache["layers"][0]["k"].shape) == (B, L, cfg.n_kv_heads // 2, hd)
    # in threads, its positions: chunk d * M + m of (data, model), row-major
    axis = tp.share(lm, cache, 3, {"data": 2, "model": 2}, shd.STRATEGIES["serve_2d"](),
                    comm=tp.ThreadRanks({"data": 2, "model": 2}).rank(3))[0]
    assert axis.layer(0).seq == shd.Split(1, ("data", "model"), 3 * L // 4, L)


def test_thread_ranks_play_each_axis_of_a_grid():
    """Rank r of a (data 2 x model 3) grid is (r // 3, r % 3); a collective
    over an axis meets the ranks of r's group along it, in its order."""
    ranks = tp.ThreadRanks({"data": 2, "model": 3})
    assert ranks.size == 6 and ranks.coordinate(4) == {"data": 1, "model": 1}
    assert ranks.group(4, "model") == [3, 4, 5] and ranks.group(4, "data") == [1, 4]

    def collectives(r):
        comm = ranks.rank(r)
        x = torch.full((3, 1), float(r))
        return (comm.all_reduce(x, "data"), comm.all_gather(x, 1, "model"),
                comm.all_to_all(torch.arange(3.0)[:, None] + 10 * r, "model"))

    out = ranks.run(collectives)
    summed, gathered, moved = out[4]
    assert torch.equal(summed, torch.full((3, 1), 5.0))  # ranks 1 and 4
    assert torch.equal(gathered, torch.tensor([[3.0, 4.0, 5.0]] * 3))
    # block 1 (the rank's model index) of each of ranks 3, 4, 5
    assert torch.equal(moved, torch.tensor([[31.0], [41.0], [51.0]]))


# ---------------------------------------------------------------------------
# Part (ii): what the dry run's trace sees
# ---------------------------------------------------------------------------

def _decode_ops(cfg, strategy, rows):
    cell = shp.ShapeCell("tiny", 64, rows, "decode")
    with _mesh((2, 2)) as mesh:
        step = steps.build_serve_step(cfg, cell, mesh, strategy)
        counter = OpCounter()
        with counter:
            step()
    return counter.collectives


def test_a_decode_step_moves_only_activations_over_data():
    """Reduced internvl2-76b (2 layers: d 64, 4/2 heads of 16, d_ff 128,
    vocab 512, untied, swiglu) under ``serve_2d`` on (data 2, model 2), 2
    rows (whole on every rank: the batch lies on ``pod``), bf16. Over
    ``data`` (rank 0's group, ranks 0 and 2): the lookup's and each row
    product's (``wo``, ``w_down``) gather of the stream [2, 1, d], the sum
    of each column product's output (``wq`` [2, 1, 2 x 16], ``wk`` and
    ``wv`` [2, 1, 1 x 16], ``w_gate`` and ``w_up`` [2, 1, 64]) and of the
    head's logits block [2, 1, 256], and each attention layer's fp32
    partial-softmax merge over the positions (a max and a sum, as before):
    no weight moves over ``data``."""
    cfg = ARCHS["internvl2-76b"].reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (2, 64, 4, 2, 16, 128, 512, False)
    rows, d, bf16, fp32 = 2, cfg.d_model, 2, 4
    ops = [(op.kind, op.bytes) for op in _decode_ops(cfg, "serve_2d", rows)
           if op.ranks == (0, 2)]
    stream = rows * d * bf16
    merge = [("all-reduce", rows * cfg.n_heads * fp32),                        # the row max
             ("all-reduce", rows * cfg.n_heads * (cfg.head_dim + 1) * fp32)]  # sum, weighted V
    per_layer = ([("all-gather", stream)] * 2 + merge
                 + [("all-reduce", rows * n * bf16)
                    for n in (2 * 16, 16, 16, cfg.d_ff // 2, cfg.d_ff // 2)])
    want = [("all-gather", stream), ("all-reduce", rows * cfg.vocab_size // 2 * bf16)]
    assert sorted(ops) == sorted(want + per_layer * cfg.n_layers)
    # the parent gathered each weight's model block whole over data; the
    # smallest, wk's [d, 1, 16], outweighs every collective over data now
    assert max(b for _, b in ops) < d * 16 * bf16
    assert all(b <= stream for k, b in ops if k == "all-gather")


def test_a_moe_decode_step_moves_no_expert_block_over_data():
    """Reduced qwen3-moe (2 layers: d 64, 4/2 heads of 16, 8 experts top-2
    of d_ff 128, vocab 512) under ``serve_2d`` on (data 2, model 2), 2 rows,
    bf16. Over ``data`` (ranks 0 and 2), as the attention's layers above:
    the lookup's, ``wo``'s and now the MoE's gather of the stream [2, 1, d],
    the QKV sums, the partial-softmax merge and the head's logits block;
    the MoE's own: the router's logits [2, 8] summed, and the stacked
    partial pre-activations of ``w_gate`` and ``w_up`` on the rank's 4
    experts' one slot each [2, 4, 1, 128], one sum. The parent gathered the
    router's [d, 8] and each expert leaf's [4, d, 128] block over ``data``
    in every step: no collective over ``data`` comes near one rank's block
    of one expert leaf now."""
    cfg = ARCHS[QWEN].reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.n_experts, cfg.experts_per_token, cfg.vocab_size) == (
                2, 64, 4, 2, 16, 128, 8, 2, 512)
    rows, d, bf16, fp32 = 2, cfg.d_model, 2, 4
    ops = [(op.kind, op.bytes) for op in _decode_ops(cfg, "serve_2d", rows)
           if op.ranks == (0, 2)]
    stream = rows * d * bf16
    slots = capacity(rows, cfg.experts_per_token, cfg.n_experts, cfg.moe_capacity_factor)
    assert slots == 1
    merge = [("all-reduce", rows * cfg.n_heads * fp32),
             ("all-reduce", rows * cfg.n_heads * (cfg.head_dim + 1) * fp32)]
    per_layer = ([("all-gather", stream)] * 2 + merge
                 + [("all-reduce", rows * n * bf16) for n in (2 * 16, 16, 16)]
                 + [("all-reduce", rows * cfg.n_experts * bf16),  # the router's logits
                    ("all-reduce", 2 * (cfg.n_experts // 2) * slots * cfg.d_ff * bf16)])
    want = [("all-gather", stream), ("all-reduce", rows * cfg.vocab_size // 2 * bf16)]
    assert sorted(ops) == sorted(want + per_layer * cfg.n_layers)
    expert_block = (cfg.n_experts // 2) * (d // 2) * cfg.d_ff * bf16
    assert max(b for _, b in ops) < expert_block // 8
    assert all(b == stream for k, b in ops if k == "all-gather")


def test_a_rwkv_decode_step_moves_no_weight_block_over_data():
    """Reduced rwkv6-7b at the fake WKV kernel's head size (2 layers: d 128,
    2 heads of 64, d_ff 128, lora 64, vocab 512) under ``serve_2d`` on (data
    2, model 2), 2 rows, bf16: every collective of a decode step, byte for
    byte. Over ``data`` (ranks 0 and 2): the lookup's gather of the stream,
    and a layer's two shift states' gathers (the next token's mixes read
    them whole), ``decay_b``'s [64, d] gather (the one weight that still
    moves: its embed dim is its heads' dim), the sums of ``w_r``'s,
    ``w_k``'s, ``w_g``'s and ``decay_a``'s partial products, of the time
    mix's value and the channel mix's value on the rank's heads' columns
    (masked: d/M columns) and of the channel mix's ``w_k`` and ``w_r``
    products; the head's logits block. Over ``model`` (ranks 0 and 1): the
    lookup's sum, the shifts' gathers, each ``w_v``'s partial product (the
    embed block's d/2 columns) summed, the time mix's ``w_o`` term summed,
    the channel mix's product gathered. The parent gathered each mixer
    weight's model block over ``data`` (16 KiB each here) and moved
    ``tm.w_v`` from rows to columns by an all-to-all over ``model``."""
    cfg = dataclasses.replace(ARCHS[RWKV].reduced(), d_model=128, rwkv_head_dim=64)
    assert (cfg.n_layers, cfg.d_model // cfg.rwkv_head_dim, cfg.d_ff, cfg.vocab_size) == (
        2, 2, 128, 512)
    rows, d, bf16, lora, D, M = 2, cfg.d_model, 2, 64, 2, 2
    ops = _decode_ops(cfg, "serve_2d", rows)
    over_data = [(op.kind, op.bytes) for op in ops if op.ranks == (0, 2)]
    over_model = [(op.kind, op.bytes) for op in ops if op.ranks == (0, 1)]
    assert {op.ranks for op in ops} == {(0, 1), (0, 2)}
    stream, block = rows * d * bf16, rows * d // D * bf16
    per_layer = ([("all-gather", stream)] * 2 + [("all-gather", lora * d * bf16)]
                 + [("all-reduce", rows * n * bf16)  # r, k, g, decay_a, tm's v; cm's k, r, v
                    for n in (d // M, d // M, d // M, lora, d // M, cfg.d_ff // M, d // M,
                              d // M)])
    want = [("all-gather", stream), ("all-reduce", rows * cfg.vocab_size // M * bf16)]
    assert sorted(over_data) == sorted(want + per_layer * cfg.n_layers)
    per_layer = ([("all-gather", block)] * 2  # the shifts' [2, d/4] blocks to [2, d/2]
                 + [("all-reduce", block), ("all-reduce", stream), ("all-reduce", block),
                    ("all-gather", stream)])
    assert sorted(over_model) == sorted([("all-reduce", block)] + per_layer * cfg.n_layers)
    weight_block = d * (d // M) * bf16  # the smallest the parent gathered: [d, d/2]
    assert sorted(b for _, b in over_data if b >= weight_block) == [lora * d * bf16] * 2


def test_a_rglru_decode_step_moves_no_weight_or_state_over_data():
    """Reduced recurrentgemma-9b (8 layers: 6 RG-LRU of width 64 in 4 gate
    blocks of 16, 2 local attention with 4/1 heads of 16; d 64, d_ff 128,
    vocab 512, tied) under ``serve_2d`` on (data 2, model 2), 2 rows, bf16:
    every collective of a decode step, byte for byte. An RG-LRU layer
    serves on the rank's chunk of 16 channels (one gate block): over
    ``data`` (ranks 0 and 2) the sum of ``w_in_gate``'s and ``w_in_rec``'s
    stacked partial products on the rank's ``model`` block [2, 2, 1, 32]
    and of ``w_out``'s term [2, 1, d]; over ``model`` (ranks 0 and 1) the
    all-to-all that takes the ``model`` block to each rank's chunk [M, 2, 2,
    1, 16] and the sum of ``w_out``'s term. The rest is the attention's,
    the MLP's, the lookup's and the head's, as for internvl2-76b above. The
    parent gathered ``w_in_rec``'s and ``w_in_gate``'s ``model`` blocks
    [d, 32], ``w_out`` whole and the state's chunks over ``data`` each
    step; byte for byte, none of them moves now, and no collective is as
    large as a rank's block of ``w_in_rec`` [d/2, 32] or ``w_out``'s rows
    [16, d] (the 1-D leaves' and the state's chunks at 2 rows are smaller
    than the stream, so the pin above is what rules them out)."""
    cfg = ARCHS[RG].reduced()
    kinds = [cfg.mixer_pattern[i % 3] for i in range(cfg.n_layers)]
    assert (kinds.count("rglru"), kinds.count("attn_local")) == (6, 2)
    assert (cfg.d_model, cfg.rnn_width, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (64, 64, 4, 1, 16, 128, 512, True)
    rows, d, w, bf16, fp32, D, M = 2, cfg.d_model, cfg.rnn_width, 2, 4, 2, 2
    ops = _decode_ops(cfg, "serve_2d", rows)
    assert {op.ranks for op in ops} == {(0, 1), (0, 2)}
    over_data = [(op.kind, op.bytes) for op in ops if op.ranks == (0, 2)]
    over_model = [(op.kind, op.bytes) for op in ops if op.ranks == (0, 1)]
    stream, block = rows * d * bf16, rows * d // D * bf16
    mlp = [("all-reduce", rows * cfg.d_ff // M * bf16)] * 2 + [("all-gather", stream)]
    attn = [("all-reduce", rows * n * bf16) for n in (cfg.n_heads // M * 16, 16, 16)]
    attn += [("all-gather", stream), ("all-reduce", rows * cfg.n_heads * fp32),
             ("all-reduce", rows * cfg.n_heads * (cfg.head_dim + 1) * fp32)]
    rglru = [("all-reduce", 2 * rows * w // M * bf16), ("all-reduce", stream)]
    want = [("all-gather", stream), ("all-reduce", rows * cfg.vocab_size // M * bf16)]
    want += (mlp + rglru) * 6 + (mlp + attn) * 2
    assert sorted(over_data) == sorted(want)
    rglru = [("all-to-all", M * 2 * rows * w // (D * M) * bf16), ("all-reduce", stream)]
    attn = [("all-gather", rows * cfg.n_heads * cfg.head_dim * bf16),
            ("all-reduce", rows * cfg.n_heads * fp32),
            ("all-reduce", rows * cfg.n_heads * (cfg.head_dim + 1) * fp32)]
    want = [("all-reduce", block)] * (1 + cfg.n_layers + 2) + rglru * 6 + attn * 2
    assert sorted(over_model) == sorted(want)
    w_in_block, w_out_rows = d // D * w // M * bf16, w // (D * M) * d * bf16
    assert max(b for _, b in over_data + over_model) < min(w_in_block, w_out_rows)


def test_a_whisper_decode_step_moves_no_weight_block_over_data_but_the_cross_kv():
    """Reduced whisper-medium (2 decoder blocks: d 64, 4/2 self heads and 4
    cross heads of 16, d_ff 128, vocab 512, tied) under ``serve_2d`` on
    (data 2, model 2), 2 rows, bf16: every collective of a decode step, byte
    for byte. Over ``data`` (ranks 0 and 2): the lookup's gather of the
    stream [2, 1, d] (the embedding's [V/2, d/2] block stays), and in each
    block the gathers of the stream after the self-attention's ``wo``, the
    cross-attention's ``wo`` and ``w_down``; the sums of the self-attention's
    ``wq`` [2, 1, 2 x 16], ``wk`` and ``wv`` [2, 1, 1 x 16] products, of the
    cross-attention's ``wq`` product [2, 1, 2 x 16] and of ``w_up``'s [2, 1,
    64]; the partial-softmax merge (fp32); the cross-attention's ``wk`` and
    ``wv`` blocks gathered to [d, 2, 16], the one weight that moves; and the
    tied head's partial logits block [2, 1, 256] summed. Over ``model``
    (ranks 0 and 1): the sums of the rank's block of columns [2, 1, d/2]
    (the lookup's and each part's), the queries' and new K/V rows' gathers
    and the merge. The parent gathered the embedding's block [V/2, d] and
    every block weight's over ``data`` each step."""
    cfg = ARCHS[WHISPER].reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (2, 64, 4, 2, 16, 128, 512, True)
    rows, d, hd, bf16, fp32, D, M = 2, cfg.d_model, cfg.head_dim, 2, 4, 2, 2
    ops = _decode_ops(cfg, "serve_2d", rows)
    assert {op.ranks for op in ops} == {(0, 1), (0, 2)}
    over_data = [(op.kind, op.bytes) for op in ops if op.ranks == (0, 2)]
    over_model = [(op.kind, op.bytes) for op in ops if op.ranks == (0, 1)]
    stream, block, heads = rows * d * bf16, rows * d // D * bf16, cfg.n_heads // M
    merge = [("all-reduce", rows * cfg.n_heads * fp32),
             ("all-reduce", rows * cfg.n_heads * (hd + 1) * fp32)]
    cross_kv = ("all-gather", d * heads * hd * bf16)  # a [d/2, 2, 16] block, gathered
    per_block = ([("all-gather", stream)] * 3 + merge + [cross_kv] * 2
                 + [("all-reduce", rows * n * bf16)  # wq, wk, wv; xattn.wq; w_up
                    for n in (heads * hd, hd, hd, heads * hd, cfg.d_ff // M)])
    want = [("all-gather", stream), ("all-reduce", rows * cfg.vocab_size // M * bf16)]
    assert sorted(over_data) == sorted(want + per_block * cfg.n_layers)
    per_block = ([("all-reduce", block)] * 3 + merge
                 + [("all-gather", rows * cfg.n_heads * hd * bf16)] * 2)  # q; the K/V rows
    assert sorted(over_model) == sorted([("all-reduce", block)] + per_block * cfg.n_layers)
    # the embedding's block [V/2, d/2] stays (the parent gathered it to [V/2,
    # d]): no collective is as large, and the only weights that move are the
    # cross-attention's wk and wv
    embed_block = cfg.vocab_size // M * d // D * bf16
    assert max(b for _, b in over_data + over_model) < embed_block
    weight_block = d // D * heads * hd * bf16  # the smallest block a weight's gather moved
    assert [k for k, b in over_data if b >= weight_block] == ["all-gather"] * 2 * cfg.n_layers


def test_fsdp_tp_gathers_the_weights_over_data():
    """The same step under ``fsdp_tp`` (the rows on ``data``): the weights'
    gathers over ``data`` stay, no stream is gathered over it, and no
    column product is summed over it."""
    cfg = ARCHS["internvl2-76b"].reduced()
    ops = [(op.kind, op.bytes) for op in _decode_ops(cfg, "fsdp_tp", 4) if op.ranks == (0, 2)]
    assert {k for k, _ in ops} == {"all-gather"}
    assert min(b for _, b in ops) >= cfg.d_model * 16 * 2  # wk's model block, the smallest


def test_launch_counts_from_ranks_in_threads_add_up(monkeypatch):
    """The grid's ranks launch kernels from their own threads at once: a
    wrapper's launch count loses no launch (its increment under a lock). A
    fake entry point and stream stand in for the card; the interpreter
    switches threads as often as it can."""
    kern = cuda_build.CudaKernel("fake", cuda_build.Path(__file__), "fake", [])
    kern._fn = lambda *args: 0
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=None))
    n_threads, n_launches = 3 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kern.launch("cpu")
                                                    for _ in range(n_launches)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kern.launches == n_threads * n_launches
