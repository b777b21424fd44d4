"""Sequence parallelism in sharded training (``repro_torch.parallel``): the
residual stream splits its sequence over ``model`` (the reference's
``"seq": "model"`` rule), against the unsplit layer and the JAX reference,
on the CPU.

Part (i), one process: for a ``model`` axis of W = 2 and 4, each rank's
share of one reduced layer in the sequence form (``tensor_parallel.share``
with ``seq_len``, driven by ``tensor_parallel.seq_shares``: each rank
normalizes its block of positions, the gathers and reduce-scatters played
by ``seq_shares``): the ranks' output blocks concatenated, the input's and every
leaf's gradient (the norms' and the unsplit mixers' summed over the ranks)
against the unsplit ``Block.forward``, within 1e-5 of the largest value
(the MoE's gradients within ``MOE_GRAD_TOL``). Layers: attention and a
dense MLP, attention whose heads and an MLP whose ``d_ff`` W 4 does not
divide (computed whole, each rank's positions kept), RG-LRU (the rank's
channels of the gathered stream, the term reduce-scattered; with 2 gate
blocks, which W 4 does not divide, whole, each rank's positions kept),
RWKV-6 (the time mix on the rank's heads of the gathered stream, its term
reduce-scattered; the channel mix on its ``d_ff`` block, its value terms
summed and sliced by ``d``, each rank's receptance block multiplied in, the
blocks laid side by side and each rank's positions kept, as the all-to-all
takes them), and the MoE (qwen3-moe: the rows
gathered, the experts split, the combine reduce-scattered; with 6 experts
and a ``d_ff`` of 130 at W 4, whole, its aux term's gradient at 1/W a
rank). For RWKV-6 and
RG-LRU, a rank that ran its mixer on its own block alone would part at its
block's first position, where the token shift's t-1 and the conv's taps
read the previous rank's positions: the test shows that it does, and that
the ranks' terms on the gathered stream (the RG-LRU's summed over the
ranks) give the unsplit mixer's output on the rank's positions.

Part (ii), gloo ranks (``tests/_torch_ranks.py``, one run a mesh):
``ShardedModel.loss`` and every gradient (``full_tensor``) on (data 2,
model 2) under ``fsdp_tp`` and on (model 4) under ``tp_only``, against the
reference's ``jax.value_and_grad`` on the same weights
(``tests/test_torch_tp_train.py``'s tolerances: the loss within 1e-5
relative, each gradient within 2e-5 of its leaf's largest, MOE_GRAD_TOL for
the MoE models). Reduced gemma2-9b, internvl2-76b with its 16-row prefix,
recurrentgemma-9b, rwkv6-7b, qwen3-moe, phi3.5-moe, and gemma2-9b with a
vocabulary of 510 and a ``d_ff`` of 130 (on (model 4) its embedding, head
and MLP are whole on every rank: each reads its own positions,
``ModelAxis.seq_xent``), at S 56: a 72-row internvl2 stream splits into
blocks of 36 or 18 rows, so rank 0's block holds the prefix and tokens. In
the same runs: the input each remat group keeps for the backward, seen by
``torch.autograd.graph.saved_tensors_hooks``, is the rank's [B, S'/M, d]
block; and internvl2-76b at S 57 (S' 73, which no axis divides: the
resolver replicates the sequence) gives ``fsdp_tp_noseq``'s loss and
gradients bit for bit; rwkv6-7b at S 57, which splits on neither mesh,
runs the RWKV-6 split without the sequence split on real ranks (the
channel mix's product all-gathered along ``d``). Part (iii): that
undivided stream's train step counts the 16 all-reduces over ``model`` of
the path without the split.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro.configs import ARCHS as JARCHS
from repro.models.model_zoo import build_model as jbuild_model
from repro_torch.configs import ARCHS
from repro_torch.models import common
from repro_torch.parallel import tensor_parallel as tp

from _torch_ranks import run_ranks
from test_torch_tp_train import MOE_GRAD_TOL, _model_collectives, _seeded_lm
from test_torch_train import (GRAD_TOL, LOSS_TOL, _assert_grads_close, _numpy_params,
                              _reference_loss_and_grads, _two_threads)  # noqa: F401

SHARE_TOL = 1e-5

# ---------------------------------------------------------------------------
# Part (i): each rank's share in the sequence form, one process
# ---------------------------------------------------------------------------

_ATTN = dataclasses.replace(ARCHS["internvl2-76b"].reduced(), n_layers=1, frontend=None,
                            frontend_seq_len=0)
LAYERS = {
    "attention_mlp": (_ATTN, 0),
    # 6 heads (2 KV) and d_ff 130: W 4 divides neither; W 2 splits both
    "attention_mlp_undivided": (dataclasses.replace(_ATTN, n_heads=6, d_ff=130), 0),
    "rglru": (ARCHS["recurrentgemma-9b"].reduced(), 0),
    # 2 gate blocks: W 2 splits the channels, W 4 runs the layer whole
    "rglru_undivided": (dataclasses.replace(ARCHS["recurrentgemma-9b"].reduced(), n_heads=2),
                        0),
    "rwkv": (ARCHS["rwkv6-7b"].reduced(), 0),
    "moe": (ARCHS["qwen3-moe-235b-a22b"].reduced(), 0),
    # 6 experts, d_ff 130: W 2 splits the experts, W 4 neither (computed whole)
    "moe_undivided": (dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"].reduced(), n_experts=6,
                                          d_ff=130), 0),
}
B, S = 2, 24  # blocks of 12 or 6 positions; the conv's 3 taps cross each boundary


def _layer_case(case):
    cfg, index = LAYERS[case]
    lm = _seeded_lm(cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    gy = torch.randn(B, S, cfg.d_model, generator=g)
    return lm, index, x, gy, torch.arange(S)


def _grads(out, aux, gy, x, leaves):
    """The gradients of <out, gy> + aux of the input and every leaf."""
    return torch.autograd.grad((out * gy).sum() + aux, [x] + leaves)


def _close(got, want, what, tol=SHARE_TOL):
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-12), (what, err)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_sequence_shares_equal_the_unsplit_layer(case, W):
    lm, index, x, gy, positions = _layer_case(case)
    block = lm.layers[index]
    names = [n for n, _ in lm.named_parameters() if n.startswith(f"layers.{index}.")]
    leaves = [lm.get_parameter(n) for n in names]
    xw = x.clone().requires_grad_()
    out, aux = block(xw, positions)
    want = _grads(out, aux, gy, xw, leaves)

    shares = [tp.share(lm, None, r, W, seq_len=S) for r in range(W)]
    axis = shares[0][0]
    assert (axis.seq.lo, axis.seq.hi) == (0, S // W)
    xs = x.clone().requires_grad_()
    got_out, auxs = tp.seq_shares(lm, index, shares, xs, positions)
    # every rank's aux term is the whole one; its gradient counts 1/W a rank
    assert all(float(a) == float(aux) for a in auxs)
    got = _grads(got_out, sum(auxs), gy, xs, leaves)
    _close(got_out.detach(), out.detach(), "output")
    tol = MOE_GRAD_TOL if case.startswith("moe") else SHARE_TOL
    for name, a, b in zip(["input"] + names, got, want):
        _close(a, b, name, tol)
    # under the sequence split every replicated weight's gradient is summed
    layer = axis.layer(index)
    for name in names:
        assert axis.sums_gradient(name) == (axis.split(name) is None), name
    if case == "rwkv":  # the time mix's heads and the channel mix's d_ff split
        assert layer.tm_sum and layer.cm_sum
        assert not axis.sums_gradient(f"layers.{index}.tm.decay_base")
        assert axis.sums_gradient(f"layers.{index}.tm.mu_r")
        assert axis.sums_gradient(f"layers.{index}.cm.mu_k")
    if case.startswith("rglru"):  # the rank's channels and their gates' blocks, or whole
        split = block.rglru.gate_a.shape[0] % W == 0
        assert layer.rglru_sum == split
        for leaf in ("lam", "gate_a", "w_out"):
            assert axis.sums_gradient(f"layers.{index}.rglru.{leaf}") == (not split)
    assert axis.sums_gradient(f"layers.{index}.norm1")
    if case == "attention_mlp_undivided":
        assert (layer.attn_sum, layer.mlp_sum) == (W == 2, W == 2)
    if case == "moe_undivided":
        assert layer.moe_sum == (W == 2)


@pytest.mark.parametrize("case", ["rglru", "rwkv"])
def test_a_rank_alone_parts_at_its_shard_boundary(case):
    """Rank 1 of 4 (positions 6..11): the mixer run on the gathered stream
    gives the unsplit mixer's output there (every rank's heads of the RWKV-6
    time mix, or channels of the RG-LRU, their terms summed and the rank's
    positions kept, as the reduce-scatter keeps them); run on its own block
    alone, its first position reads zeros where the token shift and the
    conv read positions 5, 4 and 3, and the output parts."""
    lm, index, x, _, positions = _layer_case(case)
    block = lm.layers[index]
    with torch.no_grad():
        h = common.apply_norm(block.norm1, x)
        want = block.mix(h, positions)
        shares = [tp.share(lm, None, r, 4, seq_len=S) for r in range(4)]
        lo, hi = shares[1][0].seq.lo, shares[1][0].seq.hi
        terms = []
        for axis, params, _ in shares:  # the gather played here: h whole
            with _reparametrize_module(lm, params):
                terms.append(block.mix(h, positions, axis.layer(index)))
        layer = shares[1][0].layer(index)
        assert (layer.rglru_sum, layer.tm_sum) == (case == "rglru", case == "rwkv")
        got = sum(terms)[:, lo:hi]
        alone = block.mix(h[:, lo:hi], positions[lo:hi])
    assert got.shape[1] == hi - lo == 6
    _close(got, want[:, lo:hi], "gathered")
    scale = float(want[:, lo:hi].abs().max())
    assert float((alone[:, 0] - want[:, lo]).abs().max()) > 1e-3 * scale


def test_an_undivided_or_one_rank_stream_does_not_split():
    from repro_torch.parallel import sharding as shd
    rules = shd.STRATEGIES["fsdp_tp"]()
    assert shd.stream_split({"data": 2, "model": 4}, rules, (4, 72, 64),
                            {"data": 1, "model": 2}) == shd.Split(1, ("model",), 36, 54)
    assert shd.stream_split({"data": 2, "model": 4}, rules, (4, 73, 64), {"data": 0,
                                                                          "model": 1}) is None
    assert shd.stream_split({"model": 1}, rules, (4, 72, 64), {"model": 0}) is None
    for name in ("fsdp_tp_noseq", "serve_2d"):
        assert shd.stream_split({"data": 2, "model": 4}, shd.STRATEGIES[name](), (4, 72, 64),
                                {"data": 0, "model": 0}) is None


# ---------------------------------------------------------------------------
# Part (ii): gloo ranks against the JAX reference
# ---------------------------------------------------------------------------

# an arch at S 56; "<arch>/S<n>" at S n; "gemma2-9b/odd": vocab 510, d_ff 130
MODELS = ["gemma2-9b", "internvl2-76b", "recurrentgemma-9b", "rwkv6-7b",
          "qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b", "gemma2-9b/odd", "rwkv6-7b/S57"]
UNDIVIDED = "internvl2-76b/S57"
MESHES = {"fsdp_tp": ((2, 2), ("data", "model")), "tp_only": ((4,), ("model",))}

_RANKS = """
import sys

from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.weights import from_jax_params

strategy, shape, axes, cases = inputs
mesh = make_mesh_from_devices(range(world), shape, axes, "cpu")
result = {}


def kept_input(t):
    # the checkpoint's inputs are saved by its frame's save_inputs; the first is x
    frame = sys._getframe(1)
    for _ in range(3):
        if frame.f_code.co_name == "save_inputs":
            if t is frame.f_locals["args"][0]:
                kept.append(tuple(t.shape))
            break
        frame = frame.f_back
    return t


def loss_and_grads(cfg, np_params, batch, rules):
    model = ShardedModel(build_model(cfg, device="cpu"), mesh, rules)
    lm = model.shard(from_jax_params(cfg, np_params, device="cpu")).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(kept_input, lambda t: t):
        loss, metrics = model.loss(lm, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   remat_policy="nothing")
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in lm.named_parameters()])
    return {"loss": float(loss), "moe_aux": float(metrics["moe_aux"]),
            "grads": {n: g.full_tensor().numpy() for n, g in zip(names, grads)}}


for name, cfg, np_params, batch in cases:
    rules = shd.STRATEGIES[strategy]()
    kept = []
    result[name] = loss_and_grads(cfg, np_params, batch, rules)
    result[name]["kept"] = kept
    if name == "internvl2-76b/S57":
        kept = []
        result[name + ":noseq"] = loss_and_grads(cfg, np_params, batch, {**rules, "seq": None})
"""


def _cfgs(name):
    """(the port's reduced config, the reference's, S)."""
    arch, _, var = name.partition("/")
    over = dict(vocab_size=510, d_ff=130) if var == "odd" else {}
    S = int(var[1:]) if var.startswith("S") else 56
    return (dataclasses.replace(ARCHS[arch].reduced(), **over),
            dataclasses.replace(JARCHS[arch].reduced(), **over), S)


def _batch(cfg, S, seed=5):
    """B 4 x S tokens and labels, a mask denser in the first two rows, and
    internvl2's prefix."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32),
             "mask": (rng.random((4, S)) < [[0.9], [0.9], [0.4], [0.4]]).astype(np.float32)}
    if cfg.frontend:
        batch["prefix_embeds"] = rng.standard_normal(
            (4, cfg.frontend_seq_len, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _case(name):
    cfg, jcfg, S = _cfgs(name)
    return name, cfg, _numpy_params(jcfg, seed=2), _batch(cfg, S)


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """Both meshes' rank runs, started at once; the reference is computed
    while they run."""
    from concurrent.futures import ThreadPoolExecutor
    cases = [_case(name) for name in MODELS + [UNDIVIDED]]
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {strategy: pool.submit(run_ranks, _RANKS, 4, tmp_path_factory.mktemp(strategy),
                                      inputs=(strategy, *MESHES[strategy], cases), timeout=240)
                for strategy in MESHES}
        for name in MODELS:
            _reference(name)
        return {strategy: run.result() for strategy, run in runs.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    _, cfg, np_params, batch = _case(name)
    return _reference_loss_and_grads(cfg, jbuild_model(_cfgs(name)[1]), np_params, batch)


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, _runs):
    return request.param, _runs[request.param]


@pytest.mark.parametrize("name", MODELS)
def test_sequence_split_loss_and_every_gradient_equal_the_reference(ranks, name):
    strategy, results = ranks
    cfg = _case(name)[1]
    want_loss, want_grads, want_metrics = _reference(name)
    tol = MOE_GRAD_TOL if cfg.is_moe else GRAD_TOL
    for res in results:  # every rank holds the whole loss and gradients
        got = res[name]
        assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss), (strategy, got["loss"])
        want_aux = want_metrics["moe_aux"]
        assert abs(got["moe_aux"] - want_aux) <= LOSS_TOL * max(abs(want_aux), 1e-12)
        _assert_grads_close({n: torch.from_numpy(g) for n, g in got["grads"].items()},
                            want_grads, tol)


@pytest.mark.parametrize("name", MODELS)
def test_each_remat_group_keeps_the_ranks_block(ranks, name):
    """remat "nothing": one group a pattern (the tail outside any), each
    keeping its input; on a rank that is [B / data, S' / model, d], or
    [B / data, S', d] where ``model`` does not divide S' (rwkv6-7b at S
    57: the stream is whole)."""
    strategy, results = ranks
    cfg = _case(name)[1]
    shape, axes = MESHES[strategy]
    sizes = dict(zip(axes, shape))
    S = _cfgs(name)[2] + cfg.frontend_seq_len
    n_groups, _ = cfg.n_groups_and_tail()
    block = (4 // sizes.get("data", 1), S // sizes["model"] if S % sizes["model"] == 0 else S,
             cfg.d_model)
    for res in results:
        assert res[name]["kept"] == [block] * n_groups, (strategy, res[name]["kept"])


def test_an_undivided_stream_is_the_path_without_the_split(ranks):
    """S' = 16 + 57 = 73: the resolver replicates the sequence, so the loss,
    every gradient and the kept inputs are ``fsdp_tp_noseq``'s, bit for bit
    (``tp_only`` with its ``seq`` rule dropped on (model 4))."""
    strategy, results = ranks
    batch_rows = 4 // dict(zip(MESHES[strategy][1], MESHES[strategy][0])).get("data", 1)
    for res in results:
        got, want = res[UNDIVIDED], res[UNDIVIDED + ":noseq"]
        assert got["loss"] == want["loss"]
        for n, g in want["grads"].items():
            np.testing.assert_array_equal(got["grads"][n], g, err_msg=n)
        assert got["kept"] == [(batch_rows, 73, 64)] * 2


# ---------------------------------------------------------------------------
# Part (iii): the undivided stream's collectives
# ---------------------------------------------------------------------------

def test_an_undivided_stream_counts_the_sums_over_model():
    """``tests/test_torch_tp_train.py``'s train step under ``fsdp_tp`` with 33
    tokens after the 16-row prefix: S' = 49 does not divide by the axis, and
    the step is the path without the split: 16 all-reduces over ``model``."""
    ops = _model_collectives("fsdp_tp", seq_len=33)
    assert [op.kind for op in ops] == ["all-reduce"] * 16

