"""Tensor-parallel training on the ``model`` axis (``repro_torch.parallel``)
against the unsplit layer and the JAX reference, on the CPU.

Part (i), one process: for a ``model`` axis of W = 2 and 4, each rank's
training share of a reduced layer goes through the functions the ranks
call, on its weight blocks (``tensor_parallel.share``, whose reductions over
``model`` return the rank's own term). Attention and the MLP: each rank's
forward term, its weight-block gradients and its input gradient from the
same upstream gradient; the terms summed where the layer splits (else each
rank's equal to the whole), a split weight's block gradient equal to that
block of the unsplit gradient, a replicated weight read in part
(``ModelAxis.sums_gradient``: K/V where ``n_kv_heads`` does not divide W,
QK-norm's scales) summed over the ranks, every other weight's gradient
whole on each rank. Cases: GQA with and without ``n_kv_heads`` dividing W,
MQA, QK-norm, a local window with the score softcap, the three MLPs and a
``d_ff`` W does not divide. The RG-LRU layer of reduced recurrentgemma-9b
(4 gate blocks) at W 2, 4 and 8: the rank's channels (every leaf a block,
the gates' blocks among them) where W divides the blocks, the layer whole
at W 8. The RWKV-6 layer of reduced rwkv6-7b (4 heads, ``d_ff`` 128) at
W 2, 4 and 8 through ``tensor_parallel.rwkv_shares``' training form: the
time mix's heads (whole at W 8) and the channel mix's ``d_ff`` blocks,
the mixes' ``mu_*`` and ``decay_a`` summed. The embedding, the head and
the vocab-parallel cross-entropy (with a mask, tied and untied, with the
final softcap): every
rank's lookup summed, its logits block's terms combined as the mesh
combines them (``Shares.merge_xent``), one backward. Everything within 1e-5
of the largest value of the unsplit output or gradient, in fp32.

Part (ii), gloo ranks (``tests/_torch_ranks.py``, one run a mesh and a
group of models, ``GROUPS``): reduced
gemma2-9b, internvl2-76b with its prefix, recurrentgemma-9b, qwen3-moe,
phi3.5-moe (8 experts: each rank computes its block of them, the expert
split), rwkv6-7b (both mixers split, the stream's sequence too), and
phi3.5-moe with 6 experts (3 a rank on (data 2, model 2); on
(model 4), which does not divide 6, every expert's ff columns: the ff
split), whisper-medium (its encoder's and decoder's streams split their
positions over ``model``, each where the axis divides its own length: at
24 frames and 64 tokens both, and on (model 4) three variants split one:
24 frames and 22 tokens, the encoder's alone, also with 6 heads, where
every attention is whole and no rank's gradient of the memory is a partial
term; 26 frames and 24 tokens, the decoder's alone) on (data 2, model 2)
under ``fsdp_tp`` and on (model 4) under ``tp_only``:
``ShardedModel.loss`` and every gradient (``full_tensor``) against the
reference's ``jax.value_and_grad`` of its loss on the same weights (the loss
within 1e-5 relative, each gradient within 2e-5 of its leaf's largest, as
``tests/test_torch_train.py``; the MoE models' gradients within
MOE_GRAD_TOL, their bf16 gates'), then 6 AdamW steps in fp32 against the
single process's
``train_loop`` (``tests/test_torch_parallel.py``'s fp32 tolerances: the
losses within 1e-5 relative; every parameter within FP32_SPLIT_PARAM_ATOL,
and all but a share SPLIT_OUTLIERS of them within 1e-5, since AdamW turns
the split's fp32 rounding into up to a whole step at a gradient within a few
eps of 0. Seen: up to 5.0e-5 and 3 parameters beyond 1e-5 for the dense
models. The MoE models' are held to FP32_SPLIT_PARAM_ATOL alone: their
gradients part by up to MOE_GRAD_TOL, so whole expert rows may part by more
than 1e-5 after 6 steps; seen up to 9.3e-4, and 403 of 484736 parameters
beyond 1e-5 at S 128 on (model 4)).
Sequences are 64 tokens (past the reduced window of 32): on the (data 2)
mesh a rank's 128 tokens are half of qwen3-moe's routing group (256 tokens),
so its rows are gathered over ``data`` and routed in the global group.
qwen3-moe also runs at S 128, where a rank's rows hold a whole group: they
are routed there with the global group size, and the aux term is the mean
over every rank's groups (summed over ``data``), not weighted by the rank's
share of the masked tokens.

Part (iii), the dry run's trace of a train step on a (data 2, model 2)
mesh: the collectives over ``model`` the op counter files, counted one by
one, and no weight gathered over ``model`` in the forward (rwkv6-7b's
time-mix ``w_v`` block moved by all-to-alls, its gradient back by one).
"""

import dataclasses
import functools
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro.configs import ARCHS as JARCHS
from repro.models.model_zoo import build_model as jbuild_model
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import shapes as shp, steps
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import common
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, train_loop
from repro_torch.weights import from_jax_params

from _torch_ranks import run_ranks
from test_torch_launch import _mesh
from test_torch_parallel import (LOSS_RTOL, SPLIT_OUTLIERS, TRAIN_LR, TRAIN_STEPS,
                                 assert_params_close)
from test_torch_encdec import _assert_grads_close_key_bias_apart
from test_torch_encdec import _numpy_params as _encdec_numpy_params
from test_torch_train import (GRAD_TOL, LOSS_TOL, _assert_grads_close, _numpy_params,
                              _port_loss_and_grads, _reference_loss_and_grads,
                              _two_threads)  # noqa: F401

SHARE_TOL = 1e-5
# qwen3-moe's gradients pass its bf16 gates, whose gradient is itself rounded
# to bf16 (2^-8 relative) on every side: a change of 1e-7 upstream flips
# such a rounding. The one-process port parts from the reference by 1.8e-4 of
# the router's largest gradient on part (ii)'s batch, the sharded path from
# the one process by 7.1e-5; the card-vs-CPU training check's tolerance
# (``chip_smoke.py`` train_check) bounds them. A missed or doubled sum over
# ``model`` would part by a whole term.
MOE_GRAD_TOL = 2e-3

# ---------------------------------------------------------------------------
# Part (i): each rank's training share, one process
# ---------------------------------------------------------------------------

_BASE = dataclasses.replace(ARCHS["internvl2-76b"].reduced(), n_layers=1, frontend=None,
                            frontend_seq_len=0)

ATTN_CASES = {
    "gqa_kv_divides": dict(n_heads=8, n_kv_heads=4),
    # 2 KV heads: they divide W 2, not W 4 (two ranks read each, in part)
    "gqa_kv_does_not_divide": dict(n_heads=4, n_kv_heads=2, qkv_bias=True),
    "mqa": dict(n_heads=4, n_kv_heads=1),
    "qk_norm": dict(qk_norm=True),
    "local_window_softcap": dict(mixer_pattern=("attn_local",), window=8, attn_softcap=5.0),
}
MLP_CASES = {
    "swiglu": dict(mlp_type="swiglu"),
    "geglu": dict(mlp_type="geglu"),
    "gelu": dict(mlp_type="gelu"),
    # 130: divides W 2, not W 4 (whole on every rank, no sum)
    "d_ff_does_not_divide": dict(d_ff=130),
}
HEAD_CASES = {
    "untied": dict(),
    "tied_final_softcap": dict(tie_embeddings=True, final_softcap=3.0, embed_scale=True),
    # 510: divides W 2, not W 4 (the lookup, the head and the loss whole)
    "vocab_does_not_divide": dict(vocab_size=510),
    # the encoder-decoder's tied head (``EncDec._embed`` / ``_logits``): vocab
    # 512 splits; 510 splits at W 2 only, as whisper-medium's 51865 at none
    "whisper_tied": dict(arch="whisper-medium"),
    "whisper_vocab_does_not_divide": dict(arch="whisper-medium", vocab_size=510),
}
B, S = 2, 12
# the encoder-decoder's memory: 20 frames
T_MEMORY = 20


def _reduced(arch):
    """``arch`` reduced to one layer (one block a stack)."""
    cfg = ARCHS[arch].reduced()
    return dataclasses.replace(cfg, n_layers=1,
                               n_encoder_layers=1 if cfg.is_encoder_decoder else 0)


def _seeded_lm(cfg, seed=0):
    """The LM with every leaf a seeded normal (norm scales, biases and QK-norm
    too, which the init leaves at zero), trainable."""
    lm = build_model(cfg, device="cpu").init(seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lm.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.2 if p.ndim > 1 else 0.1))
    return lm.requires_grad_(True)


def _close(got, want, what=""):
    tol = SHARE_TOL * max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= tol, (what, err, tol)


def _module_shares(lm, module, W, run):
    """Each rank's (axis, forward term, input gradient, {state-dict name:
    gradient of its block}) for ``run(module, x, axis)`` on the same input
    and upstream gradient. ``module`` is the state-dict prefix."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, lm.cfg.d_model, generator=g)
    gy = torch.randn(B, S, lm.cfg.d_model, generator=g)
    names = [n for n, _ in lm.named_parameters() if n.startswith(module + ".")]
    sub = lm.get_submodule(module)
    xw = x.clone().requires_grad_()
    out = run(sub, xw, None)
    grads = torch.autograd.grad(out, [xw] + [lm.get_parameter(n) for n in names], gy)
    want = (out.detach(), grads[0], dict(zip(names, grads[1:])))
    ranks = []
    for r in range(W):
        axis, params, _ = tp.share(lm, None, r, W)
        blocks = {n: params[n].detach().clone().requires_grad_() for n in names}
        xr = x.clone().requires_grad_()
        with _reparametrize_module(lm, blocks):
            o = run(sub, xr, axis)
        grads = torch.autograd.grad(o, [xr] + list(blocks.values()), gy)
        ranks.append((axis, o.detach(), grads[0], dict(zip(names, grads[1:]))))
    return want, ranks


def _check_module(want, ranks, summed):
    """The forward terms and input gradients summed where the layer splits
    (``summed``), else each whole; each weight's gradient by its kind."""
    out, dx, grads = want
    if summed:
        _close(sum(o for _, o, _, _ in ranks), out, "output")
        _close(sum(d for _, _, d, _ in ranks), dx, "input gradient")
    else:
        for _, o, d, _ in ranks:
            _close(o, out, "output")
            _close(d, dx, "input gradient")
    kinds = {}
    for name, g in grads.items():
        splits = [axis.split(name) for axis, _, _, _ in ranks]
        sums = {axis.sums_gradient(name) for axis, _, _, _ in ranks}
        assert len(sums) == 1, name
        if splits[0] is not None:
            kinds[name] = "block"
            for s, (_, _, _, got) in zip(splits, ranks):
                _close(got[name], g.narrow(s.dim, s.lo, s.hi - s.lo), name)
        elif sums.pop():
            kinds[name] = "summed"
            _close(sum(got[name] for _, _, _, got in ranks), g, name)
        else:
            kinds[name] = "whole"
            for _, _, _, got in ranks:
                _close(got[name], g, name)
    return kinds


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_training_shares_equal_the_unsplit_layer(case, W):
    cfg = dataclasses.replace(_BASE, **ATTN_CASES[case])
    lm = _seeded_lm(cfg)
    positions = torch.arange(S)

    def run(attn, x, axis):
        layer = None if axis is None else axis.layer(0)
        return attn(x if axis is None else axis.to_split(x), positions, axis=layer)

    want, ranks = _module_shares(lm, "layers.0.attn", W, run)
    layer = ranks[0][0].layer(0)
    assert layer.attn_sum == (cfg.n_heads % W == 0)
    kinds = _check_module(want, ranks, layer.attn_sum)
    assert kinds["layers.0.attn.wq"] == kinds["layers.0.attn.wo"] == "block"
    # K/V: the rank's KV heads where they divide W, else read in part by each rank
    kv = "block" if cfg.n_kv_heads % W == 0 else "summed"
    assert kinds["layers.0.attn.wk"] == kinds["layers.0.attn.wv"] == kv
    if cfg.qkv_bias:
        assert (kinds["layers.0.attn.bq"], kinds["layers.0.attn.bk"]) == ("block", kv)
    if cfg.qk_norm:  # applied to the rank's heads only
        assert kinds["layers.0.attn.q_norm"] == kinds["layers.0.attn.k_norm"] == "summed"


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_training_shares_equal_the_unsplit_layer(case, W):
    cfg = dataclasses.replace(_BASE, **MLP_CASES[case])
    lm = _seeded_lm(cfg)

    def run(mlp, x, axis):
        return mlp(x if axis is None or not axis.layer(0).mlp_sum else axis.to_split(x))

    want, ranks = _module_shares(lm, "layers.0.mlp", W, run)
    split = cfg.d_ff % W == 0
    assert ranks[0][0].layer(0).mlp_sum == split
    kinds = _check_module(want, ranks, split)
    assert set(kinds.values()) == {"block" if split else "whole"}


@pytest.mark.parametrize("W", [2, 4, 8])
def test_rglru_training_shares_equal_the_unsplit_layer(W):
    """Each rank's RG-LRU forward term on its channels, its input gradient
    and every leaf's block gradient from one upstream gradient; at W 8,
    which does not divide the 4 gate blocks, whole on every rank."""
    cfg = dataclasses.replace(ARCHS["recurrentgemma-9b"].reduced(), n_layers=1)
    lm = _seeded_lm(cfg)

    def run(rglru, x, axis):
        return rglru(x if axis is None or not axis.layer(0).rglru_sum else axis.to_split(x))

    want, ranks = _module_shares(lm, "layers.0.rglru", W, run)
    split = cfg.n_heads % W == 0
    assert ranks[0][0].layer(0).rglru_sum == split
    kinds = _check_module(want, ranks, split)
    assert len(kinds) == 10 and set(kinds.values()) == {"block" if split else "whole"}


# the time mix's leaves that read the whole input: their gradient is a
# partial term a rank where the time mix splits
_RWKV_WHOLE_INPUT = ("tm.mu_r", "tm.mu_k", "tm.mu_v", "tm.mu_w", "tm.mu_g", "tm.decay_a")


@pytest.mark.parametrize("W", [2, 4, 8])
def test_rwkv_training_shares_equal_the_unsplit_layer(W):
    """Reduced rwkv6-7b's layer 0 (d 64, 4 heads of 16, ``d_ff`` 128) in
    ``tensor_parallel.rwkv_shares``' training form (no cache: ``Block.mix``
    and the channel mix on each rank's blocks, the sums over ``model``
    played there), one backward from one upstream gradient: the output, the
    input's gradient and every leaf's against the unsplit ``Block.forward``.
    Each rank's blocks are leaves of their own, so each gradient is checked
    by its kind: a split leaf's block (the time mix's heads at W 2 and 4,
    ``w_o``, ``bonus``, ``decay_b`` and the 1-D leaves, whole at rest,
    among them; the channel mix's ``d_ff`` block at all three W) equal to
    that block of the unsplit gradient; the mixes' ``mu_*`` and
    ``decay_a``, which read the whole input, summed over the ranks where
    their mixer splits; the rest (the time mix at W 8, which does not
    divide 4 heads; the norms) whole on rank 0, whose whole output
    ``rwkv_shares`` takes."""
    cfg = dataclasses.replace(ARCHS["rwkv6-7b"].reduced(), n_layers=1)
    lm = _seeded_lm(cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    gy = torch.randn(B, S, cfg.d_model, generator=g)
    names = [n for n, _ in lm.named_parameters() if n.startswith("layers.0.")]
    xw = x.clone().requires_grad_()
    out, _ = lm.layers[0](xw, torch.arange(S))
    want = torch.autograd.grad(out, [xw] + [lm.get_parameter(n) for n in names], gy)
    shares = []
    for r in range(W):
        axis, params, _ = tp.share(lm, None, r, W)
        shares.append((axis, {n: p.detach().clone().requires_grad_() for n, p in params.items()},
                       None))
    xr = x.clone().requires_grad_()
    got = tp.rwkv_shares(lm, 0, shares, xr)
    leaves = [params[n] for _, params, _ in shares for n in names]
    grads = torch.autograd.grad(got, [xr] + leaves, gy, allow_unused=True,
                                materialize_grads=True)
    _close(got.detach(), out.detach(), "output")
    _close(grads[0], want[0], "input gradient")
    per_rank = [dict(zip(names, grads[1 + r * len(names):1 + (r + 1) * len(names)]))
                for r in range(W)]
    layer = shares[0][0].layer(0)
    assert (layer.tm_sum, layer.cm_sum) == (W != 8, True)
    kinds = {}
    for name, whole in zip(names, want[1:]):
        splits = [axis.split(name) for axis, _, _ in shares]
        sums = {axis.sums_gradient(name) for axis, _, _ in shares}
        assert len(sums) == 1, name
        summed = sums.pop()
        assert not (summed and splits[0] is not None), name  # never both
        leaf = name[len("layers.0."):]
        if splits[0] is not None:
            kinds[leaf] = "block"
            for s, got_r in zip(splits, per_rank):
                _close(got_r[name], whole.narrow(s.dim, s.lo, s.hi - s.lo), name)
        elif summed:
            kinds[leaf] = "summed"
            _close(sum(got_r[name] for got_r in per_rank), whole, name)
        else:
            kinds[leaf] = "whole"
            _close(per_rank[0][name], whole, name)
    tm = "block" if layer.tm_sum else "whole"
    want_kinds = {f"tm.{leaf}": tm for leaf in tp._TM_DIMS}
    want_kinds.update({leaf: "summed" if layer.tm_sum else "whole"
                       for leaf in _RWKV_WHOLE_INPUT})
    want_kinds.update({"cm.w_k": "block", "cm.w_v": "block", "cm.w_r": "block",
                       "cm.mu_k": "summed", "cm.mu_r": "summed"})
    want_kinds.update({f"{norm}.{leaf}": "whole" for norm in ("norm1", "norm2")
                       for leaf in ("g", "b")})  # layernorm's scale and bias
    assert kinds == want_kinds


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_vocab_parallel_lookup_head_and_cross_entropy(case, W):
    """The lookup's terms summed, each rank's logits block through the
    cross-entropy's terms combined as the mesh combines them, one backward:
    the loss, the embedding's and head's gradients (a tied embedding's block
    takes the lookup's and the head's terms), the final norm's and the
    input's, against ``softmax_xent`` on the unsplit head."""
    over = dict(HEAD_CASES[case])
    arch = over.pop("arch", None)
    cfg = dataclasses.replace(_BASE if arch is None else _reduced(arch), **over)
    lm = _seeded_lm(cfg)
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn(B, S, cfg.d_model, generator=g, requires_grad=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    mask = (torch.rand(B, S, generator=g) < 0.7).float()
    # the model's own leaves (the encoder-decoder's positions and encoder
    # norm among them, which neither side reads: their gradients are 0)
    names = [n for n, _ in lm.named_parameters() if n.split(".")[0] not in tp.SPLIT_MODULES]
    leaves = [lm.get_parameter(n) for n in names]
    unused = {"allow_unused": True, "materialize_grads": True}

    want = common.softmax_xent(lm._logits(x0 + lm._embed(tokens)), labels, mask)
    want_grads = torch.autograd.grad(want, [x0] + leaves, **unused)

    shares = [tp.share(lm, None, r, W) for r in range(W)]

    def each(fn):
        out = []
        for axis, params, _ in shares:
            with _reparametrize_module(lm, {n: params[n] for n in names}):
                out.append(fn(axis))
        return out

    split = shares[0][0].head is not None
    assert split == (cfg.vocab_size % W == 0)
    lookups = each(lambda axis: lm._embed(tokens, model_axis=axis))
    x = x0 + (sum(lookups) if split else lookups[0])  # whole on every rank: no sum
    if split:
        lse, gold = tp.Shares.merge_xent(
            each(lambda axis: axis.xent_terms(lm._logits(x, axis), labels)))
        got = common.masked_mean(lse - gold, mask)
    else:  # whole on every rank: rank 0's loss is the loss
        got = each(lambda axis: common.softmax_xent(lm._logits(x, axis), labels, mask))[0]
    got_grads = torch.autograd.grad(got, [x0] + leaves, **unused)
    _close(got.detach(), want.detach(), "loss")
    for name, a, b in zip(["input"] + names, got_grads, want_grads):
        _close(a, b, name)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("stack", ["enc_blocks", "dec_blocks"])
def test_encdec_block_training_shares_equal_the_unsplit_block(stack, W):
    """Reduced whisper-medium's encoder block (non-causal self-attention, the
    MLP) or decoder block (causal self-attention, the cross-attention over a
    20-frame memory, the MLP): every rank's share in turn
    (``tensor_parallel.block_shares``: each part's normed input, and the
    memory, fed to every rank, so autograd adds its gradient's terms as the
    mesh's sum over ``model`` does; the terms of a split part added), one
    backward from one upstream gradient. The output, the input's and the
    memory's gradients and every leaf's gradient against the unsplit block's
    (a key bias's gradient is 0 exactly, and held to its ``wk``'s largest,
    as ``tests/test_torch_encdec.py`` holds it). The split: query heads
    (``wq``, ``bq``, ``wo``) and ``d_ff`` blocks at both W; the
    self-attention's 2 KV heads blocks at W 2 and read in part at W 4
    (summed); the cross-attention's 4 KV heads blocks at both; norms whole."""
    cfg = _reduced("whisper-medium")
    model = _seeded_lm(cfg)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, S, cfg.d_model, generator=g, requires_grad=True)
    memory = (torch.randn(B, T_MEMORY, cfg.d_model, generator=g, requires_grad=True)
              if stack == "dec_blocks" else None)
    inputs = [x] + ([] if memory is None else [memory])
    positions = torch.arange(S)
    names = [n for n, _ in model.named_parameters() if n.startswith(f"{stack}.0.")]
    leaves = [model.get_parameter(n) for n in names]
    block = getattr(model, stack)[0]
    want = block(*inputs[:1], positions, *inputs[1:])
    gy = torch.randn(want.shape, generator=g)
    want_grads = torch.autograd.grad(want, inputs + leaves, gy)

    shares = [tp.share(model, None, r, W) for r in range(W)]
    got = tp.block_shares(model, stack, 0, shares, x, positions, memory)
    got_grads = torch.autograd.grad(got, inputs + leaves, gy)
    _close(got.detach(), want.detach(), "output")
    for name, a, b in zip(["input", "memory"][:len(inputs)], got_grads, want_grads):
        _close(a, b, name)
    _assert_grads_close_key_bias_apart(dict(zip(names, got_grads[len(inputs):])),
                                       dict(zip(names, want_grads[len(inputs):])), SHARE_TOL)

    axis = shares[0][0]
    kinds = {n.split(".", 2)[2]: "block" if axis.split(n) is not None
             else "summed" if axis.sums_gradient(n) else "whole" for n in names}
    kv = "block" if W == 2 else "summed"
    parts = ("attn", "mlp") + (("xattn",) if stack == "dec_blocks" else ())
    want_kinds = {f"{part}.{leaf}": "block" for part in parts for leaf in (
        ("w_up", "w_down") if part == "mlp" else ("wq", "bq", "wo", "wk", "bk", "wv", "bv"))}
    want_kinds.update({f"attn.{leaf}": kv for leaf in ("wk", "bk", "wv", "bv")})
    assert {k: v for k, v in kinds.items() if "norm" not in k} == want_kinds
    assert {v for k, v in kinds.items() if "norm" in k} == {"whole"}
    view = axis.layer(0, stack)
    assert view.attn_sum and view.mlp_sum and view.xattn_sum == (stack == "dec_blocks")


def test_sums_gradient_reads_the_resolved_spec_and_the_layer_split():
    """Replicated leaves read in part are summed (the MoE router where the
    experts split); split leaves (the RG-LRU's, its gates' blocks among
    them), norms and the leaves of mixers outside the split are not."""
    cfg = ARCHS["qwen3-moe-235b-a22b"].reduced()  # 4/2 heads, QK-norm, 8 experts
    meta = shp.param_specs_shapes(cfg, torch.float32)
    for W, kv in ((2, False), (4, True)):
        axis = tp.ModelAxis({"model": W}, shd.STRATEGIES["tp_only"](),
                            tp.param_shapes(meta), None, tp.Shares(), coord={"model": 0})
        summed = {n for n, _ in meta.named_parameters() if axis.sums_gradient(n)}
        want = {f"layers.{i}.{leaf}" for i in range(cfg.n_layers)
                for leaf in ("attn.q_norm", "attn.k_norm", "moe.router")
                + (("attn.wk", "attn.wv") if kv else ())}
        assert summed == want, (W, summed ^ want)
    cfg = ARCHS["recurrentgemma-9b"].reduced()  # 1 KV head; RG-LRU layers split
    meta = shp.param_specs_shapes(cfg, torch.float32)
    axis = tp.ModelAxis({"model": 2}, shd.STRATEGIES["fsdp_tp"](), tp.param_shapes(meta),
                        None, tp.Shares(), coord={"model": 1})
    summed = {n for n, _ in meta.named_parameters() if axis.sums_gradient(n)}
    assert summed == {f"layers.{i}.attn.{w}" for i in range(2, cfg.n_layers, 3)
                      for w in ("wk", "wv")}
    rglru = [n for n, _ in meta.named_parameters() if ".rglru." in n]
    assert len(rglru) == 10 * 6 and all(axis.split(n) is not None for n in rglru)


# ---------------------------------------------------------------------------
# Part (ii): gloo ranks against the JAX reference and the single process
# ---------------------------------------------------------------------------

# an arch at S 64; "<arch>/<var>", var a run of S<n> (n tokens), E<n> (n
# experts), F<n> (n frames), H<n> (n heads). whisper-medium's two streams
# split independently: at 24 frames and 64 tokens both split on either mesh;
# on (model 4) F24S22 splits only the encoder's, F26S24 only the decoder's,
# and F24S22H6 only the encoder's with every attention whole (6 heads), so
# that no rank's gradient of the memory is a partial term
MODELS = ["gemma2-9b", "internvl2-76b", "recurrentgemma-9b", "qwen3-moe-235b-a22b",
          "qwen3-moe-235b-a22b/S128", "phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b/E6",
          "whisper-medium", "whisper-medium/F24S22", "whisper-medium/F26S24",
          "whisper-medium/F24S22H6", "rwkv6-7b"]
# the models a rank run takes, a few each, so that no run nears its time
# limit; the runs start two at a time, in the order the tests read them
GROUPS = (("gemma2-9b", "internvl2-76b"), ("recurrentgemma-9b",),
          ("rwkv6-7b", "qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b/S128"),
          ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b/E6"),
          ("whisper-medium", "whisper-medium/F24S22"),
          ("whisper-medium/F26S24", "whisper-medium/F24S22H6"))
assert sorted(sum(GROUPS, ())) == sorted(MODELS)
# the encoder-decoder's frames a row: 24, past its reduced 16-row ``enc_pos``
# (the positions tile)
ENCDEC_FRAMES = 24
MESHES = {"fsdp_tp": ((2, 2), ("data", "model")), "tp_only": ((4,), ("model",))}

_RANKS = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel, full_state
from repro_torch.train.train_loop import train_loop
from repro_torch.weights import from_jax_params

strategy, shape, axes, cases = inputs
mesh = make_mesh_from_devices(range(world), shape, axes, "cpu")
result = {}
for name, cfg, np_params, batch, (data, run) in cases:
    model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES[strategy]())
    lm = model.shard(from_jax_params(cfg, np_params, device="cpu")).requires_grad_(True)
    loss, metrics = model.loss(lm, {k: torch.from_numpy(v) for k, v in batch.items()},
                               remat_policy="nothing")
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in lm.named_parameters()])
    out = {"loss": float(loss), "moe_aux": float(metrics["moe_aux"]),
           "grads": {n: g.full_tensor().numpy() for n, g in zip(names, grads)}}
    lm = model.shard(from_jax_params(cfg, np_params, device="cpu"))
    batches = data if isinstance(data, list) else data.batches(run.total_steps)
    lm, state, hist = train_loop(model, lm, batches, run, log_every=1)
    out.update(losses=[h["loss"] for h in hist], opt_step=state.step,
               params={n: p.numpy() for n, p in full_state(lm).items()})
    result[name] = out
"""


def _arch_and_seq(name):
    """(arch, S, the config's fields replaced, the encoder-decoder's frames)."""
    arch, _, var = name.partition("/")
    got = {k: int(n) for k, n in re.findall(r"([A-Z])(\d+)", var)}
    over = {field: got[k] for k, field in (("E", "n_experts"), ("H", "n_heads")) if k in got}
    return arch, got.get("S", 64), over, got.get("F", ENCDEC_FRAMES)


def _cfgs(name):
    """(the port's reduced config, the reference's)."""
    arch, _, over, _ = _arch_and_seq(name)
    return (dataclasses.replace(ARCHS[arch].reduced(), **over),
            dataclasses.replace(JARCHS[arch].reduced(), **over))


def _batch(cfg, S, seed=3, frames=ENCDEC_FRAMES):
    """B 4 x S tokens and labels, a mask (denser in the first two rows, so
    the (data 2) mesh's ranks hold unequal shares of the loss's tokens), and
    internvl2's prefix or the encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32),
             "mask": (rng.random((4, S)) < [[0.9], [0.9], [0.4], [0.4]]).astype(np.float32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((4, frames, cfg.d_model)).astype(np.float32)
    elif cfg.frontend:
        batch["prefix_embeds"] = rng.standard_normal(
            (4, cfg.frontend_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _train_setup(cfg, S, frames):
    """``tests/test_torch_parallel.py``'s 6 steps in fp32; the
    encoder-decoder's batches (frames, tokens, labels, mask) seeded here."""
    if cfg.is_encoder_decoder:
        data = [_batch(cfg, S, seed=10 + i, frames=frames) for i in range(TRAIN_STEPS)]
    else:
        data = SyntheticLM(DataConfig(cfg.vocab_size, S, 4, seed=1))
    run = TrainRunConfig(optimizer=AdamWConfig(lr=TRAIN_LR, weight_decay=0.01),
                         total_steps=TRAIN_STEPS, warmup_steps=2, compute_dtype=torch.float32)
    return data, run


@functools.lru_cache(maxsize=None)
def _case(name):
    _, S, _, frames = _arch_and_seq(name)
    cfg, jcfg = _cfgs(name)
    draw = _encdec_numpy_params if cfg.is_encoder_decoder else _numpy_params
    return (name, cfg, draw(jcfg, seed=1), _batch(cfg, S, frames=frames),
            _train_setup(cfg, S, frames))


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """(the reference's loss and gradients, the one-process port's, and its
    6 AdamW steps: the history and the trained LM)."""
    _, cfg, np_params, batch, (data, run) = _case(name)
    jcfg = _cfgs(name)[1]
    want = _reference_loss_and_grads(cfg, jbuild_model(jcfg), np_params, batch)
    one = _port_loss_and_grads(cfg, np_params, batch)
    lm = from_jax_params(cfg, np_params, device="cpu")
    batches = data if isinstance(data, list) else data.batches(run.total_steps)
    trained = train_loop(build_model(cfg, device="cpu"), lm, batches, run, log_every=1)
    return want, one, trained


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """Every (mesh, group) rank run, started two at a time in the order the
    tests read them; the one-process side is computed while they run."""
    cases = {name: _case(name) for name in MODELS}
    with ThreadPoolExecutor(2) as pool:
        runs = {(strategy, group): pool.submit(
                    run_ranks, _RANKS, 4, tmp_path_factory.mktemp(strategy),
                    inputs=(strategy, *MESHES[strategy], [cases[n] for n in group]),
                    timeout=180)
                for strategy in sorted(MESHES) for group in GROUPS}
        for name in MODELS:
            _one_process(name)
        yield runs


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, _runs):
    """(the mesh, name -> every rank's result for that model), each group's
    run waited for when a test first reads it."""
    strategy = request.param

    def results(name):
        group = next(g for g in GROUPS if name in g)
        return [res[name] for res in _runs[strategy, group].result()]

    return strategy, results


@pytest.mark.parametrize("name", MODELS)
def test_sharded_loss_and_every_gradient_equal_the_reference(ranks, name):
    """Against the reference and against the one-process port on the same
    batch: the loss (and the MoE aux term) within 1e-5 relative, each
    gradient within GRAD_TOL of its leaf's largest (MOE_GRAD_TOL for
    qwen3-moe; the encoder-decoder's key biases, whose gradient is 0
    exactly, within GRAD_TOL of their ``wk``'s largest, as
    ``tests/test_torch_encdec.py`` holds them)."""
    strategy, results = ranks
    cfg = _case(name)[1]
    (want_loss, want_grads, _), (one_loss, one_metrics, one_grads), _ = _one_process(name)
    tol = MOE_GRAD_TOL if cfg.is_moe else GRAD_TOL
    check = (_assert_grads_close_key_bias_apart if cfg.is_encoder_decoder
             else _assert_grads_close)
    check(one_grads, want_grads, tol)
    for got in results(name):  # every rank holds the whole loss and gradients
        assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss), (strategy, got["loss"])
        assert abs(got["loss"] - float(one_loss)) <= LOSS_TOL * abs(want_loss)
        # the aux term is the global batch's mean over its groups
        one_aux = float(one_metrics["moe_aux"])
        assert abs(got["moe_aux"] - one_aux) <= LOSS_TOL * abs(one_aux), (got["moe_aux"], one_aux)
        grads = {n: torch.from_numpy(g) for n, g in got["grads"].items()}
        check(grads, want_grads, tol)
        check(grads, one_grads, tol)


@pytest.mark.parametrize("name", MODELS)
def test_sharded_adamw_steps_equal_the_single_process(ranks, name):
    """The losses within 1e-5 relative; the parameters by
    ``assert_params_close``'s fp32 rule. The encoder-decoder's key biases,
    whose gradient is 0 exactly, take AdamW steps on both sides' rounding
    noise (a step of up to the lr whatever the noise's size): they are held
    to FP32_SPLIT_PARAM_ATOL, and the share of the rest beyond 1e-5 is
    counted without them (seen: 149 of their 256 entries beyond 1e-5; of
    the other leaves' 191616 one, by 1.6e-5)."""
    strategy, results = ranks
    cfg = _case(name)[1]
    lm, state, hist = _one_process(name)[2]
    losses = [h["loss"] for h in hist]
    want = {n: p.detach().numpy() for n, p in lm.named_parameters()}
    noise = {n for n in want if cfg.is_encoder_decoder and n.endswith(".bk")}
    for got in results(name):
        assert got["opt_step"] == state.step == TRAIN_STEPS
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL, err_msg=strategy)
        params = got["params"]
        assert_params_close({n: params[n] for n in noise}, {n: want[n] for n in noise},
                            "fp32", outliers=None)
        assert_params_close({n: p for n, p in params.items() if n not in noise},
                            {n: p for n, p in want.items() if n not in noise}, "fp32",
                            outliers=None if cfg.is_moe else SPLIT_OUTLIERS)


# ---------------------------------------------------------------------------
# Part (iii): the collectives the dry run's counter sees
# ---------------------------------------------------------------------------

def _model_collectives(strategy, seq_len=32):
    """A train step of reduced internvl2-76b (2 layers, 4/2 heads, d_ff 128,
    vocab 512, all split on a model axis of 2; B 4 x (16 prefix rows +
    ``seq_len`` tokens)) on a (data 2, model 2) mesh, remat "nothing" (each
    layer its own group): the collectives over ``model`` (rank 0's group
    {0, 1}), in order; those over ``data`` are a weight's gather and its
    gradient's reduction alone."""
    return _step_collectives("internvl2-76b", strategy, seq_len)[1]


def _step_collectives(arch, strategy, seq_len):
    """A sharded train step of reduced ``arch`` (B 4, ``seq_len`` the cell's
    sequence) on a (data 2, model 2) mesh, remat "nothing": rank 0's
    collectives over ``data`` (group {0, 2}: a weight's gather and its
    gradient's reduction alone) and over ``model`` ({0, 1}), in order."""
    cfg = ARCHS[arch].reduced()
    cell = shp.ShapeCell("tiny", seq_len, 4, "train")
    with _mesh((2, 2)) as mesh:
        step = steps.build_train_step(cfg, cell, mesh, strategy=strategy)
        counter = OpCounter()
        with counter:
            step()
    assert {op.ranks for op in counter.collectives} == {(0, 1), (0, 2)}
    over_data = [op for op in counter.collectives if op.ranks == (0, 2)]
    assert {op.kind for op in over_data} == {"all-gather", "reduce-scatter", "all-reduce"}
    return over_data, [op for op in counter.collectives if op.ranks == (0, 1)]


def test_a_train_step_counts_the_sums_over_model():
    """Without the sequence split (``fsdp_tp_noseq``), over ``model`` a step
    all-reduces: the lookup's sum; each layer's two row-parallel sums in the
    forward; the cross-entropy's max, sum of ``exp`` and label logit; the
    head's input gradient; for each layer in the backward, the recompute's
    attention sum (the checkpoint stops before the MLP's, whose output the
    backward does not read) and its two column-parallel inputs' gradients;
    and the clip's global norm: 1 + 2 * 2 + 3 + 1 + 2 * 3 + 1 = 16. No
    gradient is summed over ``model`` (the KV heads divide it) and no weight
    gathered over it."""
    assert [op.kind for op in _model_collectives("fsdp_tp_noseq")] == ["all-reduce"] * 16


def test_a_sequence_split_train_step_counts_its_gathers_and_scatters():
    """Under ``fsdp_tp`` the stream's 48 positions split over ``model``.
    All-gathers: in the forward each layer's two normed inputs and the
    head's; in the backward, for each layer, the MLP's reduce-scatter's
    gradient, the recompute's two gathers (it stops before the MLP's
    reduce-scatter) and the attention's reduce-scatter's gradient; and the
    lookup's reduce-scatter's gradient: 2 * 2 + 1 + 4 * 2 + 1 = 14.
    Reduce-scatters: the lookup and each layer's two row-parallel sums in
    the forward; the head's gather's gradient; for each layer the
    recompute's attention sum and its two gathers' gradients:
    1 + 2 * 2 + 1 + 3 * 2 = 12. All-reduces: the cross-entropy's three, each
    layer's ``norm1`` and ``norm2`` scale gradients (each rank normalizes its
    own positions), ``final_norm``'s and the clip's global norm:
    3 + 2 * 2 + 1 + 1 = 9. No weight is gathered over ``model``: every
    gather and reduce-scatter moves a rank's stream, [2, 48, d] in bf16."""
    ops = _model_collectives("fsdp_tp")
    kinds = [op.kind for op in ops]
    stream = 2 * 48 * ARCHS["internvl2-76b"].reduced().d_model * 2
    assert {op.bytes for op in ops if op.kind != "all-reduce"} == {stream}
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "all-gather": 14, "reduce-scatter": 12, "all-reduce": 9}
    assert kinds[:13] == (["reduce-scatter"] + ["all-gather", "reduce-scatter"] * 4
                          + ["all-gather"] + ["all-reduce"] * 3)  # the forward


def test_a_whisper_train_step_splits_every_block_along_model():
    """Reduced whisper-medium (2 + 2 blocks, 4/2 heads and 4 in the
    cross-attention, d_ff 128, vocab 512: all split on a model axis of 2; B
    4 x 24 frames x 24 tokens) under ``fsdp_tp_noseq`` (the streams whole
    along ``model``), each block its own checkpoint. Over ``model`` the step
    only all-reduces: in the forward each encoder block's two row-parallel
    sums, the lookup's, each decoder block's three (self-attention,
    cross-attention, MLP) and the cross-entropy's three; in the backward the
    head's input gradient, for each decoder block the recompute's two
    attention sums (the checkpoint stops before the MLP's, whose output the
    backward does not read) and the gradients of its three column-parallel
    inputs (the normed streams), the memory's gradient once for both
    decoder blocks (``ModelAxis.memory_in``), for each encoder block the
    recompute's attention sum and its two inputs' gradients; and the clip's
    global norm, one fp32 a leaf: 2 * 2 + 1 + 3 * 2 + 3 + 1 + 5 * 2 + 1 + 3 *
    2 + 1 = 33. Each sum moves a rank's [2, 24, d] in bf16. No weight is
    gathered over ``model``: the all-gathers over ``data`` bring each split
    weight (every attention, cross-attention and MLP weight, the embedding)
    to its ``model`` block and move nothing of the norms and positions,
    which lie whole on every rank; a block's weights are gathered in its
    forward and again in its recompute."""
    cfg = ARCHS["whisper-medium"].reduced()
    over_data, ops = _step_collectives("whisper-medium", "fsdp_tp_noseq", 24)
    stream, xent = 2 * 24 * cfg.d_model * 2, 2 * 24 * 4
    meta = shp.param_specs_shapes(cfg, torch.float32)
    n_leaves = len(list(meta.parameters()))
    assert [op.kind for op in ops] == ["all-reduce"] * 33
    assert [op.bytes for op in ops] == ([stream] * 11 + [xent] * 3 + [stream] * 18
                                        + [4 * n_leaves])
    specs = shd.param_specs({"data": 2, "model": 2}, shd.STRATEGIES["fsdp_tp"](), meta)
    want = 0
    for name, p in meta.named_parameters():
        axes = {a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        times = 2 if name.split(".")[0] in tp.SPLIT_MODULES else 1
        assert tp.splits_compute(name) == ("model" in axes), name
        want += times * p.numel() * 4 // 2 if axes == {"data", "model"} else 0
    assert sum(op.bytes for op in over_data if op.kind == "all-gather") == want


def test_a_whisper_sequence_split_train_step_counts_its_gathers_and_scatters():
    """The same step under ``fsdp_tp``: both streams, 24 frames and 24
    tokens, split into blocks of 12 over ``model``, and so does nothing
    else. All-gathers: in the forward each encoder block's two normed
    inputs, the memory into the decoder, each decoder block's three and the
    head's; in the backward each decoder block's recompute (three gathers;
    it stops before the MLP's reduce-scatter) and its three reduce-scatters'
    gradients, the lookup's reduce-scatter's gradient, and each encoder
    block's recompute (two) and its two reduce-scatters' gradients:
    2 * 2 + 1 + 3 * 2 + 1 + 6 * 2 + 1 + 4 * 2 = 33. Reduce-scatters: each
    encoder block's two row-parallel sums, the lookup and each decoder
    block's three in the forward; the head's gather's gradient, each decoder
    block's recompute (two) and its three gathers' gradients, the memory's
    gradient (every rank's term, from both decoder blocks, summed once) and
    each encoder block's recompute (one) and its two gathers' gradients:
    2 * 2 + 1 + 3 * 2 + 1 + 5 * 2 + 1 + 3 * 2 = 29. Every gather and
    reduce-scatter moves a rank's gathered stream (or memory), [2, 24, d]
    in bf16. All-reduces move no stream: the cross-entropy's three terms,
    and the gradients of the replicated weights each rank reads for its
    own positions only: every norm's scale and bias (two for each of a
    decoder block's three norms, an encoder block's two, ``enc_norm`` and
    ``dec_norm``), ``dec_pos`` and ``enc_pos`` (the vocabulary splits, so
    ``embed`` is a block); and the clip's global norm:
    3 + (3 * 2 * 2 + 2 * 2 * 2 + 2 + 2) + 2 + 1 = 30."""
    cfg = ARCHS["whisper-medium"].reduced()
    ops = _step_collectives("whisper-medium", "fsdp_tp", 24)[1]
    kinds = [op.kind for op in ops]
    d = cfg.d_model
    stream = 2 * 24 * d * 2
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "all-gather": 33, "reduce-scatter": 29, "all-reduce": 30}
    assert {op.bytes for op in ops if op.kind != "all-reduce"} == {stream}
    n_leaves = len(list(shp.param_specs_shapes(cfg, torch.float32).parameters()))
    reduced = sorted(op.bytes for op in ops if op.kind == "all-reduce")
    assert reduced == sorted([2 * 24 * 4] * 3 + [d * 4] * (12 + 8 + 4)
                             + [cfg.max_seq_len * d * 4, cfg.frontend_seq_len * d * 4]
                             + [4 * n_leaves])
    pair = ["all-gather", "reduce-scatter"]
    assert kinds[:26] == (pair * 4 + ["reduce-scatter", "all-gather"] + pair * 6
                          + ["all-gather"] + ["all-reduce"] * 3)  # the forward


def test_an_rwkv_train_step_splits_both_mixers_along_model():
    """Reduced rwkv6-7b (2 layers, d 64, 4 heads of 16, ``d_ff`` 128, vocab
    512; B 4 x 32 tokens, so a rank's stream is [2, 16, d] and its gathered
    stream [2, 32, d]) under ``fsdp_tp`` on (data 2, model 2), each layer its
    own checkpoint. Over ``model``, counted by kind and bytes (a gather's
    output, a reduce-scatter's or all-to-all's input):

    * the stream, [2, 32, d] in bf16: each layer's time-mix and channel-mix
      inputs gathered along the sequence and the time mix's term and the
      channel mix's value term reduce-scattered (along the sequence and
      along ``d``): 2 all-gathers and 2 reduce-scatters in the forward, 2
      and 2 in the recompute, and their 4 gradients' inverses: 6 and 6 a
      layer; plus the lookup's reduce-scatter, the head's gather and their
      gradients' inverses;
    * each channel mix's product [2, 32, d/2] to the rank's positions by one
      all-to-all, and its gradient back by one (the recompute stops before
      it: nothing after it is saved): 2 a layer;
    * ``tm.w_v``'s fp32 block [d, d/2], rows at rest, to its columns: one
      all-to-all in the forward, one in the recompute and one taking its
      gradient back to the rows: 3 a layer. No other weight moves over
      ``model`` in the forward: every ``tm.`` / ``cm.`` block is where it
      lies or a local slice;
    * the gradients of the time mix's leaves that lie whole at rest and are
      read in blocks (``bonus``, ``decay_b``, ``w_o``, ``out_norm``,
      ``decay_base``), all-gathered from the blocks: 5 a layer;
    * the gradients read in part, all-reduced: the time mix's five
      ``mu_*`` and ``decay_a`` (its ``data`` half, [d/2, 32]), the channel
      mix's two ``mu_*`` and the two norms' scale and bias (each rank
      normalizes its own positions): 12 a layer; plus the cross-entropy's
      three, ``final_norm``'s two and the clip's global norm.

    4 + 2 * 34 + 6 = 78 collectives; nothing else moves over ``model``."""
    cfg = ARCHS["rwkv6-7b"].reduced()
    d, L = cfg.d_model, cfg.n_layers
    assert (L, d, d // cfg.rwkv_head_dim, cfg.d_ff) == (2, 64, 4, 128)
    ops = [(op.kind, op.bytes) for op in _step_collectives("rwkv6-7b", "fsdp_tp", 32)[1]]
    stream, vec = 2 * 32 * d * 2, d * 4
    w_v = d * (d // 2) * 4
    per_layer = ([("all-gather", stream), ("reduce-scatter", stream)] * 6
                 + [("all-to-all", stream // 2)] * 2 + [("all-to-all", w_v)] * 3
                 + [("all-gather", b) for b in (vec, 32 * d * 4, d * d * 4, vec, vec)]
                 + [("all-reduce", vec)] * 11 + [("all-reduce", (d // 2) * 32 * 4)])
    xent = 2 * 32 * 4
    whole = ([("reduce-scatter", stream), ("all-gather", stream)] * 2
             + [("all-reduce", xent)] * 3 + [("all-reduce", vec)] * 2
             + [("all-reduce", 4 * (4 + 24 * L))])  # the clip: one fp32 a leaf
    assert sorted(ops) == sorted(per_layer * L + whole)
    layer_forward = [("all-to-all", w_v), ("all-gather", stream), ("reduce-scatter", stream),
                     ("all-gather", stream), ("reduce-scatter", stream),
                     ("all-to-all", stream // 2)]
    assert ops[:17] == ([("reduce-scatter", stream)] + layer_forward * L
                        + [("all-gather", stream)] + [("all-reduce", xent)] * 3)
