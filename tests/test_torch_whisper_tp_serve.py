"""Sharded whisper-medium serving on the ``model`` axis (``ShardedModel``
over the encoder-decoder) against the unsplit block and the JAX reference,
on the CPU.

Part (i), one process: for a ``model`` axis of W = 2 and 4, each rank's
share of a reduced whisper decoder block (4 query heads over 2 KV heads in
self-attention, 4 in cross-attention, ``d_ff`` 128) decodes 8 steps from an
empty cache (``DecBlock.decode`` through ``tensor_parallel.share`` and
``block_shares``): its heads' block of the self cache (the 2 KV heads split
at W 2; whole on every rank at W 4, which they do not divide), its
cross-attention heads over a seeded memory, its ``d_ff`` block. The terms
summed in fp32 equal the unsplit block's output to 1e-5 of its largest, and
each rank's cache block equals that block of the unsplit cache. Then the
sequence form, every rank at once (``tensor_parallel.thread_shares``, one
thread a rank) under ``fsdp_tp``'s cache layout: the self cache split by
positions over ``model``, each rank's partial softmax merged over the
threads' all-reduces, for the decoder block and for gemma2-9b's local
attention layer (softcap 50).

Part (ii), gloo ranks (``tests/_torch_ranks.py``, one run a mesh of
``test_torch_tp_serve.MESHES``): ``ShardedModel.prefill`` (the encode of
B 4 x 24 frames, past the reduced 16-row ``enc_pos``), then 13
``decode_step`` calls, the first from seeded tokens and 12 greedy ones, for
reduced whisper-medium at vocab 512 (the tied head splits) and 510 (it does
not on ``model`` 4), against the reference's ``encode`` and jitted
``encdec_decode_step`` from the same numpy weights (``from_jax_params``):
the memory and every call's logits to 2e-4 in fp32
(``test_torch_models.LOGIT_TOL``), greedy tokens equal, every rank the same
global memory and logits.

Part (iii), the dry run's trace on ``meta``: a whisper decode step's
collectives do not grow with the cache nor with the memory (no cache entry
and no memory frame moves), and over ``model`` each decoder block sums its
self-attention, cross-attention and MLP once each; the encode sums each
encoder block's attention and MLP once each.
"""

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.model_zoo import build_model as jbuild_model
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, shapes as shp, steps
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.weights import from_jax_params, init_params

from _torch_ranks import run_ranks
from test_torch_encdec import _numpy_params
from test_torch_launch import _mesh
from test_torch_models import LOGIT_TOL, _two_threads  # noqa: F401
from test_torch_tp_serve import MESHES

NAME = "whisper-medium"
SHARE_TOL = 1e-5
SHARE_STEPS = 8
STEPS = 12      # greedy decode steps after the first call
FRAMES = 24     # past the reduced 16-row enc_pos: the positions tile
CACHE_LEN = 64
VOCABS = (512, 510)


def _cfgs(vocab=512):
    """(the port's reduced whisper-medium, the reference's) at ``vocab``."""
    return (dataclasses.replace(ARCHS[NAME].reduced(), vocab_size=vocab),
            dataclasses.replace(JARCHS[NAME].reduced(), vocab_size=vocab))


# ---------------------------------------------------------------------------
# Part (i): each rank's share of a decoder block's decode, one process
# ---------------------------------------------------------------------------

def _rel_close(got, want, tol=SHARE_TOL, what=""):
    """Within ``tol`` of the largest value of ``want``."""
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (what, err, float(want.abs().max()))


@pytest.mark.parametrize("W", [2, 4])
def test_decoder_block_decode_shares_equal_the_unsplit_block(W):
    cfg, jcfg = _cfgs()
    model = from_jax_params(cfg, _numpy_params(jcfg, seed=2), device="cpu")
    api = build_model(cfg, device="cpu")
    B, L, T = 2, 12, 20
    rng = np.random.default_rng(3)
    memory = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)).astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32))
          for _ in range(SHARE_STEPS)]
    block = model.dec_blocks[0]
    with torch.no_grad():
        want_cache = api.init_cache(B, L, torch.float32)
        want = [block.decode(x, t, want_cache["self"][0], memory) for t, x in enumerate(xs)]
        shares = [tp.share(model, api.init_cache(B, L, torch.float32), r, W) for r in range(W)]
        got = [tp.block_shares(model, "dec_blocks", 0, shares, x, None, memory, pos=t)
               for t, x in enumerate(xs)]
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, 1, cfg.d_model)
        _rel_close(g, w, what=f"step {t}")
    heads, ff = cfg.n_heads // W, cfg.d_ff // W
    kv_split = cfg.n_kv_heads % W == 0
    assert kv_split == (W == 2)
    for r, (axis, _, cache) in enumerate(shares):
        layer = axis.layer(0, "dec_blocks")
        assert layer.attn_sum and layer.xattn_sum and layer.mlp_sum
        assert layer.q == shd.Split(1, ("model",), r * heads, (r + 1) * heads)
        assert layer.kv == (shd.Split(1, ("model",), r, r + 1) if kv_split else None)
        assert layer.cross.q == layer.cross.kv == layer.q  # as many KV heads as query heads
        assert layer.length == L and layer.seq is None
        assert axis.split("dec_blocks.0.mlp.w_up") == shd.Split(1, ("model",), r * ff,
                                                                 (r + 1) * ff)
        sel = slice(r, r + 1) if kv_split else slice(None)
        for key in ("k", "v"):  # its block of the self cache, as written by 8 steps
            assert cache["self"][0][key].shape == (B, L, len(range(cfg.n_kv_heads)[sel]),
                                                   cfg.head_dim)
            _rel_close(cache["self"][0][key], want_cache["self"][0][key][:, :, sel])
        # the other decoder block's cache block is untouched
        assert not cache["self"][1]["k"].any()
    assert want_cache["self"][0]["k"][:, SHARE_STEPS - 1].abs().max() > 0


SEQ_CASES = [("whisper-medium", "dec_blocks", 2), ("whisper-medium", "dec_blocks", 4),
             ("gemma2-9b", "layers", 2), ("gemma2-9b", "layers", 4)]


@pytest.mark.parametrize("arch,stack,W", SEQ_CASES)
def test_decode_over_a_sequence_split_cache_equals_the_unsplit_block(arch, stack, W):
    """Block 0 of ``stack`` on every rank at once, one thread a rank
    (``tensor_parallel.thread_shares``), under ``fsdp_tp``, whose cache
    layout is kept: the 12-slot self cache split by positions over
    ``model`` (W blocks, every KV head in each), seeded whole, then 8 decode
    steps from position 2, so the steps cross the blocks and a block holds
    no valid position at first. Each rank writes the new K/V row where its
    slot lies and merges the ranks' partial softmaxes: every rank's output
    equals the unsplit block's to 1e-5 of its largest, and each rank's cache
    block equals those positions of the unsplit cache."""
    cfg = ARCHS[arch].reduced()
    model = init_params(cfg, seed=4, device="cpu")
    api = build_model(cfg, device="cpu")
    B, L, start = 2, 12, 2
    rng = np.random.default_rng(5)

    def seeded(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    cache = api.init_cache(B, L, torch.float32)
    key = tp.cache_key(cache)
    for c in cache[key]:
        for leaf in c.values():
            leaf.copy_(seeded(*leaf.shape))
    memory = (seeded(B, 20, cfg.d_model),) if stack == "dec_blocks" else ()
    xs = [seeded(B, 1, cfg.d_model) for _ in range(SHARE_STEPS)]

    def decode(block, layer, c):
        return torch.stack([block.decode(x, start + t, c[key][0], *memory, axis=layer)
                            for t, x in enumerate(xs)])

    with torch.no_grad():
        want_cache = copy.deepcopy(cache)
        want = decode(getattr(model, stack)[0], None, want_cache)
        got, caches = tp.thread_shares(model, stack, 0, W, cache, decode)
    n = L // W
    for r, (out, rank_cache) in enumerate(zip(got, caches)):
        assert torch.equal(out, got[0]), r  # every rank's stream is the whole one
        layer = tp.share(model, cache, r, W, comm=tp.ThreadRanks(W).rank(r))[0].layer(0, stack)
        assert layer.seq == shd.Split(1, ("model",), r * n, (r + 1) * n) and layer.heads is None
        for leaf in ("k", "v"):
            assert rank_cache[key][0][leaf].shape == (B, n, cfg.n_kv_heads, cfg.head_dim)
            _rel_close(rank_cache[key][0][leaf], want_cache[key][0][leaf][:, r * n:(r + 1) * n])
    for t in range(SHARE_STEPS):
        _rel_close(got[0][t], want[t], what=f"step {t}")
    # the steps wrote the rows the blocks hold: positions 2..9
    assert not torch.equal(want_cache[key][0]["k"], cache[key][0]["k"])


# ---------------------------------------------------------------------------
# Part (ii): gloo ranks against the JAX reference
# ---------------------------------------------------------------------------

_RANKS = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.weights import from_jax_params, init_params

strategy, shape, axes, cases, cache_len, steps = inputs
mesh = make_mesh_from_devices(range(world), shape, axes, "cpu")
result = {}
for vocab, cfg, np_params, frames, first in cases:
    model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES[strategy]())
    lm = model.shard(from_jax_params(cfg, np_params, device="cpu"))
    cache = model.init_cache(frames.shape[0], cache_len, torch.float32)
    with torch.no_grad():
        memory, cache = model.prefill(lm, {"frames": torch.from_numpy(frames)}, cache)
        tok, out = torch.from_numpy(first), []
        for _ in range(steps + 1):
            logits, cache = model.decode_step(lm, cache, tok, memory)
            out.append(logits.full_tensor().numpy())
            tok = logits.full_tensor().argmax(-1)
    place = lambda t: [(type(p).__name__, getattr(p, "dim", None)) for p in t.placements]
    result[vocab] = {"memory": memory.full_tensor().numpy(), "logits": out,
                     "pos": cache["pos"], "memory_placements": place(memory),
                     "logits_placements": place(logits),
                     "cache_placements": place(cache["self"][0]["k"]),
                     "cache_local": tuple(cache["self"][0]["k"].to_local().shape)}
"""


def _inputs(cfg, seed=4):
    """B 4 x ``FRAMES`` frames and the first call's tokens."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, FRAMES, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32))


def _case(vocab):
    cfg, jcfg = _cfgs(vocab)
    return (vocab, cfg, _numpy_params(jcfg, seed=1), *_inputs(cfg))


def _reference(vocab):
    """The reference's encode (``Model.prefill``) and 13 decode calls of
    ``jax.jit(decode_step)``, the first from the seeded tokens, then greedy:
    (memory, logits of each call, the greedy tokens fed)."""
    _, _, np_params, frames, first = _case(vocab)
    jcfg = _cfgs(vocab)[1]
    jmodel = jbuild_model(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jcache = jmodel.init_cache(frames.shape[0], CACHE_LEN, jnp.float32)
    memory, jcache = jmodel.prefill(jparams, {"frames": jnp.asarray(frames)}, jcache)
    step = jax.jit(jmodel.decode_step)
    tok, out, toks = jnp.asarray(first), [], []
    for _ in range(STEPS + 1):
        logits, jcache = step(jparams, jcache, tok, memory=memory)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.asarray(memory), out, toks[:-1]


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """Every mesh's rank run, two at a time; the reference is computed while
    they run."""
    cases = [_case(v) for v in VOCABS]
    with ThreadPoolExecutor(2) as pool:
        runs = {mesh: pool.submit(run_ranks, _RANKS, 4, tmp_path_factory.mktemp(mesh),
                                  inputs=(*MESHES[mesh], cases, CACHE_LEN, STEPS),
                                  timeout=120)
                for mesh in sorted(MESHES)}
        want = {v: _reference(v) for v in VOCABS}
        return want, {mesh: run.result() for mesh, run in runs.items()}


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_encode_and_decode_equal_the_reference(_runs, mesh, vocab):
    want, runs = _runs
    want_memory, want_logits, want_tokens = want[vocab]
    _, shape, axes = MESHES[mesh]
    M = dict(zip(axes, shape))["model"]
    results = runs[mesh]
    for res in results:
        got = res[vocab]
        np.testing.assert_allclose(got["memory"], want_memory, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"{mesh} vocab {vocab}: memory")
        assert got["pos"] == STEPS + 1 and len(got["logits"]) == STEPS + 1
        for i, (lo, w) in enumerate(zip(got["logits"], want_logits)):
            assert lo.shape == (4, 1, vocab)
            np.testing.assert_allclose(lo, w, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"{mesh} vocab {vocab}: call {i}")
        for t, w in zip([lo.argmax(-1) for lo in got["logits"][:-1]], want_tokens):
            np.testing.assert_array_equal(t, w)
        # the memory: rows on the batch axes (data under fsdp_tp), whole on model
        assert got["memory_placements"][-1] == ("Replicate", None)
        assert got["memory_placements"][0] == (("Shard", 0) if mesh == "fsdp_tp"
                                               else ("Replicate", None))
        # the vocabulary splits over model (the last mesh axis) where it divides it
        assert got["logits_placements"][-1] == (("Shard", 2) if vocab % M == 0
                                                else ("Replicate", None))
        # the self cache's sequence lies over model (and data under serve_2d)
        n_seq = M * (2 if mesh == "serve_2d_data_model" else 1)
        rows = 2 if mesh == "fsdp_tp" else 4
        assert got["cache_local"] == (rows, CACHE_LEN // n_seq, 2, 16)
    for res in results[1:]:  # every rank sees the same global memory and logits
        np.testing.assert_array_equal(res[vocab]["memory"], results[0][vocab]["memory"])
        for a, b in zip(res[vocab]["logits"], results[0][vocab]["logits"]):
            np.testing.assert_array_equal(a, b)


_ONE_RANK = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.weights import from_jax_params, init_params

cfg, np_params, frames, first, steps = inputs
frames, tok = torch.from_numpy(frames), torch.from_numpy(first)
mesh = make_mesh_from_devices(range(world), (1, 1), ("data", "model"), "cpu")
one = build_model(cfg, device="cpu")
lm = from_jax_params(cfg, np_params, device="cpu")
with torch.no_grad():
    cache = one.init_cache(frames.shape[0], 64, torch.float32)
    memory, cache = one.prefill(lm, {"frames": frames}, cache)
    want, fed = [], [tok]
    for _ in range(steps + 1):
        logits, cache = one.decode_step(lm, cache, fed[-1], memory)
        want.append(logits)
        fed.append(logits.argmax(-1))
    model = ShardedModel(one, mesh, shd.STRATEGIES["fsdp_tp"]())
    model.shard(lm)
    cache = model.init_cache(frames.shape[0], 64, torch.float32)
    seq = model.model_axis(lm, cache, (), frames.shape[0]).layer(0, "dec_blocks").seq
    got_memory, cache = model.prefill(lm, {"frames": frames}, cache)
    got = []
    for t in fed[:-1]:  # fed the one process's tokens
        logits, cache = model.decode_step(lm, cache, t, got_memory)
        got.append(logits.full_tensor())
result = {"seq": seq, "memory": bool(torch.equal(got_memory.full_tensor(), memory)),
          "logits": [bool(torch.equal(a, b)) for a, b in zip(got, want)]}
"""


def test_a_one_rank_mesh_serves_whisper_as_one_process(tmp_path):
    """On a (data 1, model 1) mesh every split is one block and the self
    cache's sequence lies over the one rank: its one shard holds every
    position, and decode takes the plain path over it, as one process does.
    The memory and all 13 calls' logits (fed the one process's greedy
    tokens) are the one process's bit for bit."""
    _, cfg, np_params, frames, first = _case(512)
    (res,) = run_ranks(_ONE_RANK, 1, tmp_path, inputs=(cfg, np_params, frames, first, STEPS),
                       timeout=120)
    assert res["seq"] == shd.Split(1, ("model",), 0, 64)
    assert res["memory"] and res["logits"] == [True] * (STEPS + 1)


# ---------------------------------------------------------------------------
# Part (iii): what the dry run's trace sees
# ---------------------------------------------------------------------------

def _collectives(cfg, kind, seq_len, strategy="fsdp_tp"):
    """Rank 0's collectives in a reduced whisper step of ``kind`` (B 4) on a
    (data 2, model 2) mesh: (over ``model``, group {0, 1}; the others)."""
    cell = shp.ShapeCell("tiny", seq_len, 4, kind)
    with _mesh((2, 2)) as mesh:
        build = steps.build_serve_step if kind == "decode" else steps.build_prefill_step
        step = build(cfg, cell, mesh, strategy)
        counter = OpCounter()
        with counter:
            step()
    over_model = [op for op in counter.collectives if op.ranks == (0, 1)]
    return over_model, [op for op in counter.collectives if op.ranks != (0, 1)]


@pytest.mark.parametrize("strategy", ["fsdp_tp", "serve_2d"])
def test_a_whisper_decode_step_moves_no_cache_entry_and_no_memory(strategy):
    """Collective bytes do not depend on the self cache's length (64 or 256
    slots) nor on the memory's (16 or 48 frames): a step moves the new
    token's K/V row at most, never a cache entry, and never a frame."""
    cfg = ARCHS[NAME].reduced()
    costs = {}
    for cache_len, frames in ((64, 16), (256, 16), (64, 48)):
        c = dataclasses.replace(cfg, frontend_seq_len=frames)
        cell = shp.ShapeCell("tiny", cache_len, 4, "decode")
        with _mesh((2, 2)) as mesh:
            costs[cache_len, frames] = dryrun.trace(
                steps.build_serve_step(c, cell, mesh, strategy))
    base = costs[64, 16]
    assert base["n_collectives"] > 0
    for other in costs.values():
        assert other["by_kind"] == base["by_kind"]


def test_each_decoder_block_sums_its_three_parts_over_model_once():
    """Reduced whisper-medium (2 decoder blocks, 4/2 heads, 4 cross heads,
    ``d_ff`` 128, vocab 512: all split on a model axis of 2) on a (data 2,
    model 2) mesh under ``fsdp_tp``, a 64-slot self cache over ``model``.
    Over ``model`` a decode step sums the stream once for the lookup and, in
    each block, once each for the self-attention, the cross-attention and
    the MLP (1 + 3 * 2 = 7); each block's self-attention also gathers the
    new token's K/V row and its query heads and merges the partial
    softmaxes (a max and a sum): nothing else runs over ``model``. The
    encode sums each encoder block's attention and MLP once each (4)."""
    cfg = ARCHS[NAME].reduced()
    L = cfg.n_layers
    stream = 2 * 1 * cfg.d_model * 2  # a rank's 2 rows of one token, bf16
    ops, others = _collectives(cfg, "decode", 64)
    sums = [op for op in ops if op.kind == "all-reduce" and op.bytes == stream]
    assert len(sums) == 1 + 3 * L
    rest = sorted(op.kind for op in ops if op not in sums)
    assert rest == ["all-gather"] * 2 * L + ["all-reduce"] * 2 * L
    assert {op.kind for op in others} == {"all-gather"}  # over data: the weights' gathers

    ops, _ = _collectives(cfg, "prefill", 24)
    frames = 2 * 24 * cfg.d_model * 2  # a rank's 2 rows of 24 frames, bf16
    assert [(op.kind, op.bytes) for op in ops] == [("all-reduce", frames)] * 2 * cfg.n_encoder_layers
