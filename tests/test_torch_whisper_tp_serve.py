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
not on ``model`` 4), and at vocab 512 over 26 frames (which ``model`` 4
does not divide), against the reference's ``encode`` and jitted
``encdec_decode_step`` from the same numpy weights (``from_jax_params``):
the memory and every call's logits to 2e-4 in fp32
(``test_torch_models.LOGIT_TOL``), greedy tokens equal, every rank the same
global memory and logits. The memory comes back as the reference's serve
step lays it out, ``("batch", "seq", None)``: its frames split along
``model`` under ``fsdp_tp`` and ``tp_only`` where the axis divides them,
whole under ``serve_2d``; the encode's stream split with them. Under
``serve_2d`` on (data 2, model 2) the encode and each decode step compute
with each block weight's and the tied embedding's block at rest, the
``embed`` dim on ``data``, but the cross-attention's ``wk`` and ``wv``,
gathered over ``data``.

Part (iii), the dry run's trace on ``meta``: a whisper decode step's
collectives do not grow with the cache (no cache entry moves); under
``fsdp_tp`` it gathers the split memory once along ``model``, and under
``serve_2d`` moves no frame. Over ``model`` each decoder block sums its
self-attention, cross-attention and MLP once each; the encode gathers each
encoder block's two normed inputs along the sequence and reduce-scatters
its attention's and MLP's sums.
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
D = 64          # reduced whisper-medium's d_model
# "<vocab>" over FRAMES frames, "<vocab>/F<n>" over n: 26 frames split over
# fsdp_tp's model 2 and stay whole over a model axis of 4
CASES = ("512", "510", "512/F26")


def _vocab_and_frames(case):
    vocab, _, frames = case.partition("/F")
    return int(vocab), int(frames or FRAMES)


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
for name, cfg, np_params, frames, first in cases:
    model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES[strategy]())
    lm = model.shard(from_jax_params(cfg, np_params, device="cpu"))
    cache = model.init_cache(frames.shape[0], cache_len, torch.float32)
    # block 0's and the embedding's weights at rest and as served: the encoder's
    # by the encode, the decoder's and the embedding by the last decode step
    seen, materialize = {}, model._weights

    def recording(axis, rows, materialize=materialize, seen=seen):
        weight = materialize(axis, rows)

        def record(n, p):
            out = weight(n, p)
            if n == "embed" or ".0." in n:
                seen[n] = (tuple(p.to_local().shape), tuple(out.shape))
            return out
        return record

    model._weights = recording
    with torch.no_grad():
        memory, cache = model.prefill(lm, {"frames": torch.from_numpy(frames)}, cache)
        tok, out = torch.from_numpy(first), []
        for _ in range(steps + 1):
            logits, cache = model.decode_step(lm, cache, tok, memory)
            out.append(logits.full_tensor().numpy())
            tok = logits.full_tensor().argmax(-1)
    place = lambda t: [(type(p).__name__, getattr(p, "dim", None)) for p in t.placements]
    result[name] = {"memory": memory.full_tensor().numpy(), "logits": out,
                    "pos": cache["pos"], "memory_placements": place(memory),
                    "memory_local": memory.to_local().numpy(),
                    "logits_placements": place(logits),
                    "cache_placements": place(cache["self"][0]["k"]),
                    "cache_local": tuple(cache["self"][0]["k"].to_local().shape),
                    "computed_with": seen}
"""


def _inputs(cfg, seed=4, frames=FRAMES):
    """B 4 x ``frames`` frames and the first call's tokens."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, frames, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32))


def _case(case):
    vocab, frames = _vocab_and_frames(case)
    cfg, jcfg = _cfgs(vocab)
    return (case, cfg, _numpy_params(jcfg, seed=1), *_inputs(cfg, frames=frames))


def _reference(case):
    """The reference's encode (``Model.prefill``) and 13 decode calls of
    ``jax.jit(decode_step)``, the first from the seeded tokens, then greedy:
    (memory, logits of each call, the greedy tokens fed)."""
    _, _, np_params, frames, first = _case(case)
    jcfg = _cfgs(_vocab_and_frames(case)[0])[1]
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
    cases = [_case(c) for c in CASES]
    with ThreadPoolExecutor(2) as pool:
        runs = {mesh: pool.submit(run_ranks, _RANKS, 4, tmp_path_factory.mktemp(mesh),
                                  inputs=(*MESHES[mesh], cases, CACHE_LEN, STEPS),
                                  timeout=120)
                for mesh in sorted(MESHES)}
        want = {c: _reference(c) for c in CASES}
        return want, {mesh: run.result() for mesh, run in runs.items()}


def _frames_split(mesh, case):
    """The model axis's size and whether it splits the case's frames: the
    reference's ``seq`` is ``model`` under ``fsdp_tp`` and ``tp_only`` (None
    under ``serve_2d``), where the axis divides the frames."""
    strategy, shape, axes = MESHES[mesh]
    M = dict(zip(axes, shape))["model"]
    return M, strategy != "serve_2d" and _vocab_and_frames(case)[1] % M == 0


@pytest.mark.parametrize("vocab", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_encode_and_decode_equal_the_reference(_runs, mesh, vocab):
    want, runs = _runs
    want_memory, want_logits, want_tokens = want[vocab]
    V, T = _vocab_and_frames(vocab)
    M, split = _frames_split(mesh, vocab)
    results = runs[mesh]
    for res in results:
        got = res[vocab]
        np.testing.assert_allclose(got["memory"], want_memory, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"{mesh} {vocab}: memory")
        assert got["pos"] == STEPS + 1 and len(got["logits"]) == STEPS + 1
        for i, (lo, w) in enumerate(zip(got["logits"], want_logits)):
            assert lo.shape == (4, 1, V)
            np.testing.assert_allclose(lo, w, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"{mesh} {vocab}: call {i}")
        for t, w in zip([lo.argmax(-1) for lo in got["logits"][:-1]], want_tokens):
            np.testing.assert_array_equal(t, w)
        # the memory as the reference lays it out, ("batch", "seq", None):
        # rows on the batch axes (data under fsdp_tp), the frames on model
        # where the reference's seq is model and the axis divides them
        on_data = {"fsdp_tp": [("Shard", 0)], "serve_2d_data_model": [("Replicate", None)]}
        assert got["memory_placements"] == on_data.get(mesh, []) + [
            ("Shard", 1) if split else ("Replicate", None)]
        rows = 2 if mesh == "fsdp_tp" else 4
        assert got["memory_local"].shape == (rows, T // M if split else T, D)
        # the vocabulary splits over model (the last mesh axis) where it divides it
        assert got["logits_placements"][-1] == (("Shard", 2) if V % M == 0
                                                else ("Replicate", None))
        # the self cache's sequence lies over model (and data under serve_2d)
        n_seq = M * (2 if mesh == "serve_2d_data_model" else 1)
        assert got["cache_local"] == (rows, CACHE_LEN // n_seq, 2, 16)
    for res in results[1:]:  # every rank sees the same global memory and logits
        np.testing.assert_array_equal(res[vocab]["memory"], results[0][vocab]["memory"])
        for a, b in zip(res[vocab]["logits"], results[0][vocab]["logits"]):
            np.testing.assert_array_equal(a, b)


# block 0's weights with an embed dim, and that dim
_EMBED_DIMS = {f"{stack}.0.{module}.{leaf}": dim
               for stack, modules in (("enc_blocks", ("attn",)), ("dec_blocks", ("attn", "xattn")))
               for module in modules + ("mlp",)
               for leaf, dim in ((("wq", 0), ("wk", 0), ("wv", 0), ("wo", 2)) if module != "mlp"
                                 else (("w_up", 0), ("w_down", 1)))}
_EMBED_DIMS["embed"] = 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_a_ranks_whisper_weights_keep_their_embed_block_under_serve_2d(_runs, mesh):
    """Encoder and decoder block 0's attention, cross-attention and MLP
    weights and the tied embedding as the served encode and decode step
    compute with them (``ShardedModel._weights`` recorded): under ``serve_2d`` on (data 2, model 2) each is its block at rest,
    the ``embed`` dim on ``data`` (nothing moves over ``data``), but the
    cross-attention's ``wk`` and ``wv``, whose blocks are gathered over
    ``data`` to the whole ``embed`` dim; on the other meshes that dim is
    whole (gathered under ``fsdp_tp``, whole at rest without a ``data``
    axis)."""
    strategy, shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    stays = strategy == "serve_2d" and sizes.get("data", 1) > 1
    for res in _runs[1][mesh]:
        blocks = res["512"]["computed_with"]
        for name, dim in _EMBED_DIMS.items():
            at_rest, used = blocks[name]
            moves = ".xattn.wk" in name or ".xattn.wv" in name
            assert at_rest[dim] == D // sizes.get("data", 1), name
            assert used[dim] == (D // 2 if stays and not moves else D), (name, used)
            if stays and not moves:
                assert used == at_rest, name


@pytest.mark.parametrize("case", ["512", "512/F26"])
def test_a_four_rank_fsdp_tp_encode_keeps_half_the_frames_a_rank(_runs, case):
    """On (data 2, model 2) under ``fsdp_tp`` the memory at rest shrinks by
    the ``model`` axis: each rank holds its 2 rows of its half of the frames
    (24 or 26), [2, T_f/2, d], and its two ``model`` neighbours hold the two
    halves of the same rows."""
    T = _vocab_and_frames(case)[1]
    want_memory = _runs[0][case][0]
    for r, res in enumerate(_runs[1]["fsdp_tp"]):  # rank r = 2 * data + model
        got = res[case]
        assert got["memory_local"].shape == (2, T // 2, D)
        assert got["memory_placements"] == [("Shard", 0), ("Shard", 1)]
        data, model = divmod(r, 2)
        np.testing.assert_allclose(
            got["memory_local"], want_memory[2 * data:2 * data + 2, model * T // 2:(model + 1) * T // 2],
            atol=LOGIT_TOL, rtol=LOGIT_TOL, err_msg=f"rank {r}")


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
    _, cfg, np_params, frames, first = _case("512")
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
def test_a_whisper_decode_step_moves_no_cache_entry_and_gathers_a_split_memory_once(strategy):
    """No self-cache entry moves: a step's collectives are the same at a
    64- and a 256-slot self cache (the new token's K/V row at most). The
    memory lies as the reference's serve step lays it out. Under ``fsdp_tp``
    its frames split over ``model`` (16 and 48 frames, both even), and the
    step gathers them once along ``model``, right after the lookup's sum and
    before the first decoder block: one all-gather of the rank's 2 rows of
    every frame, in bf16, whose bytes grow with the frames; nothing else
    changes with them. Under ``serve_2d`` the memory is whole along
    ``model``, and no frame moves."""
    cfg = ARCHS[NAME].reduced()
    ops = {}
    for cache_len, frames in ((64, 16), (256, 16), (64, 48)):
        c = dataclasses.replace(cfg, frontend_seq_len=frames)
        ops[cache_len, frames] = [[(op.kind, op.bytes) for op in side]
                                  for side in _collectives(c, "decode", cache_len, strategy)]
    base = ops[64, 16]
    assert base[0] and ops[256, 16] == base
    if strategy == "serve_2d":
        assert ops[64, 48] == base
        return
    for frames in (16, 48):
        over_model, others = ops[64, frames]
        gather = ("all-gather", 2 * frames * cfg.d_model * 2)
        assert over_model[1] == gather and over_model.count(gather) == 1
        assert over_model[:1] + over_model[2:] == base[0][:1] + base[0][2:]
        assert others == base[1]


def test_each_decoder_block_sums_its_three_parts_over_model_once():
    """Reduced whisper-medium (2 decoder blocks, 4/2 heads, 4 cross heads,
    ``d_ff`` 128, vocab 512: all split on a model axis of 2) on a (data 2,
    model 2) mesh under ``fsdp_tp``, a 64-slot self cache over ``model``.
    Over ``model`` a decode step sums the stream once for the lookup and, in
    each block, once each for the self-attention, the cross-attention and
    the MLP (1 + 3 * 2 = 7); it gathers the memory's 16 frames once, split
    over ``model`` as the reference lays them out; each block's
    self-attention also gathers the new token's K/V row and its query heads
    and merges the partial softmaxes (a max and a sum): nothing else runs
    over ``model``. The encode's stream splits along its 24 frames as
    training's does: each encoder block gathers its two normed inputs along
    the sequence and reduce-scatters its attention's and its MLP's sums,
    each a rank's 2 rows of all 24 frames in bf16 (8), and sums nothing
    whole."""
    cfg = ARCHS[NAME].reduced()
    L = cfg.n_layers
    stream = 2 * 1 * cfg.d_model * 2  # a rank's 2 rows of one token, bf16
    ops, others = _collectives(cfg, "decode", 64)
    sums = [op for op in ops if op.kind == "all-reduce" and op.bytes == stream]
    assert len(sums) == 1 + 3 * L
    memory = [op for op in ops if op.bytes == 2 * cfg.frontend_seq_len * cfg.d_model * 2]
    assert [op.kind for op in memory] == ["all-gather"]
    rest = sorted(op.kind for op in ops if op not in sums + memory)
    assert rest == ["all-gather"] * 2 * L + ["all-reduce"] * 2 * L
    assert {op.kind for op in others} == {"all-gather"}  # over data: the weights' gathers

    ops, _ = _collectives(cfg, "prefill", 24)
    frames = 2 * 24 * cfg.d_model * 2  # a rank's 2 rows of 24 frames, bf16
    assert [(op.kind, op.bytes) for op in ops] == (
        [("all-gather", frames), ("reduce-scatter", frames)] * 2 * cfg.n_encoder_layers)
