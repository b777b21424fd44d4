"""whisper-medium's sequence split in sharded training (``repro_torch.parallel``),
on the CPU: the encoder's stream [B, T_f, d] and the decoder's [B, S, d]
each split their positions over ``model`` where the rules and the axis
divide their own length, and the memory enters the decoder once.

Part (ii) of the slice, one process: each rank's share of a reduced encoder
block and decoder block in the sequence form
(``tensor_parallel.block_shares`` over ``tensor_parallel.share`` with the
two streams' lengths: each rank normalizes its own block of positions, the
concatenated normed blocks are every rank's gathered input, a split part's
whole terms are summed in fp32 and sliced, an unsplit part gives each
rank's own positions, and the memory reaches every rank whole through a
cast from fp32) at W 2 and 4: the ranks' blocks concatenated, the input's,
the memory's and every leaf's gradient against the unsplit block's, within
1e-5 of each largest in fp32 (a key bias's gradient, 0 exactly, held to its
``wk``'s largest, as ``tests/test_torch_encdec.py`` holds it). Reduced
whisper-medium has 4 heads (2 KV heads in the self-attention, 4 in the
cross-attention) and ``d_ff`` 128: W 2 and 4 split all three parts; a
6-head variant runs both attentions whole at W 4 (each rank keeps its
positions of the whole term).

Which weights a rank reads for its own positions only
(``ModelAxis.sums_gradient``), at whisper-medium's full width on ``meta``,
and which collective takes the memory into the decoder
(``ModelAxis.memory_in``) in every combination of the two streams' splits
and of the cross-attention's. The gloo ranks against the JAX reference are
``tests/test_torch_tp_train.py``'s part (ii) (whisper-medium and its
variants that split one stream), the collective counts its part (iii).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch import shapes as shp
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

from test_torch_encdec import _assert_grads_close_key_bias_apart
from test_torch_tp_train import SHARE_TOL, _close, _reduced, _seeded_lm

B = 2
# each stack's own stream: 24 frames, 12 tokens (blocks of 12 / 6 and 6 / 3
# positions at W 2 / 4); the decoder block's memory, 20 frames, is whole
LENGTHS = {"enc_blocks": 24, "dec_blocks": 12}
T_MEMORY = 20
CASES = {"whisper": {}, "whisper_6_heads": {"n_heads": 6}}


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("stack", ["enc_blocks", "dec_blocks"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_form_block_shares_equal_the_unsplit_block(case, stack, W):
    cfg = dataclasses.replace(_reduced("whisper-medium"), **CASES[case])
    model = _seeded_lm(cfg)
    S = LENGTHS[stack]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, S, cfg.d_model, generator=g, requires_grad=True)
    memory = (torch.randn(B, T_MEMORY, cfg.d_model, generator=g, requires_grad=True)
              if stack == "dec_blocks" else None)
    inputs = [x] + ([] if memory is None else [memory])
    positions = torch.arange(S)
    names = [n for n, _ in model.named_parameters() if n.startswith(f"{stack}.0.")]
    leaves = [model.get_parameter(n) for n in names]
    want = getattr(model, stack)[0](*inputs[:1], positions, *inputs[1:])
    gy = torch.randn(want.shape, generator=g)
    want_grads = torch.autograd.grad(want, inputs + leaves, gy)

    shares = [tp.share(model, None, r, W, seq_len=LENGTHS) for r in range(W)]
    views = [axis.on(stack) for axis, _, _ in shares]
    assert [(v.seq.lo, v.seq.hi) for v in views] == [(r * S // W, (r + 1) * S // W)
                                                     for r in range(W)]
    got = tp.block_shares(model, stack, 0, shares, x, positions, memory)
    got_grads = torch.autograd.grad(got, inputs + leaves, gy)
    _close(got.detach(), want.detach(), "output")
    for name, a, b in zip(["input", "memory"][:len(inputs)], got_grads, want_grads):
        _close(a, b, name)
    _assert_grads_close_key_bias_apart(dict(zip(names, got_grads[len(inputs):])),
                                       dict(zip(names, want_grads[len(inputs):])), SHARE_TOL)

    axis = shares[0][0]
    layer = axis.layer(0, stack)
    split = cfg.n_heads % W == 0
    assert (layer.attn_sum, layer.mlp_sum) == (split, True)
    if stack == "dec_blocks":
        assert layer.xattn_sum == split
    # each rank back-propagates its own positions: every replicated leaf sums
    for n in names:
        assert axis.sums_gradient(n) == (axis.split(n) is None), n


def _whisper_axis(frames, tokens, W, rules="fsdp_tp", reduced=False, **over):
    cfg = ARCHS["whisper-medium"]
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg, **over)
    meta = shp.param_specs_shapes(cfg, torch.float32)
    d = cfg.d_model
    axis = tp.ModelAxis({"model": W}, shd.STRATEGIES[rules](), tp.param_shapes(meta), None,
                        tp.Shares(), coord={"model": 1},
                        stream={"enc_blocks": (1, frames, d), "dec_blocks": (1, tokens, d)})
    return axis, [n for n, _ in meta.named_parameters()]


# (frames, tokens, rules): whisper-medium at 16 ranks; 448 tokens split into
# blocks of 28, 1500 frames do not divide, train_4k's 4096 do
SUMMED = {
    "both_split": (4096, 448, "fsdp_tp"),
    "decoder_split": (1500, 448, "fsdp_tp"),
    "encoder_split": (4096, 450, "fsdp_tp"),
    "noseq": (4096, 448, "fsdp_tp_noseq"),
}


@pytest.mark.parametrize("case", sorted(SUMMED))
def test_each_stream_sums_the_replicated_weights_it_reads_in_part(case):
    """Full-width whisper-medium (16 heads, ``d_ff`` 4096, vocab 51865, which
    16 ranks do not divide) on a model axis of 16: every head and ``d_ff``
    block splits, so the replicated leaves are the positions, the norms and
    the embedding. Each is summed where the stream it works on splits: the
    encoder's for ``enc_pos``, ``enc_norm`` and its blocks' norms; the
    decoder's for ``dec_pos``, ``dec_norm``, its blocks' norms and the
    unsplit embedding (the lookup and the tied head read the rank's
    positions)."""
    frames, tokens, rules = SUMMED[case]
    axis, names = _whisper_axis(frames, tokens, 16, rules)
    enc, dec = axis.on("enc_blocks").seq, axis.seq
    assert (enc is not None, dec is not None) == {
        "both_split": (True, True), "decoder_split": (False, True),
        "encoder_split": (True, False), "noseq": (False, False)}[case]
    if dec is not None:
        assert (dec.lo, dec.hi) == (28, 56)
    assert axis.split("embed") is None
    replicated = {n for n in names if axis.split(n) is None}
    assert replicated == {n for n in names if n in ("embed", "enc_pos", "dec_pos")
                          or "norm" in n}
    summed = {n for n in names if axis.sums_gradient(n)}
    want = {n for n in replicated
            if (enc if n.startswith("enc_") else dec) is not None}
    assert summed == want, summed ^ want


class _Recorder:
    """A ``model`` axis of ``size`` ranks whose every rank holds the same
    tensor: the collectives return what the mesh's would and record their
    kind, in order."""

    def __init__(self, size):
        self.size, self.kinds = size, []

    def all_gather(self, x, dim, axis):
        self.kinds.append("all-gather")
        return torch.cat([x] * self.size, dim)

    def reduce_scatter(self, x, dim, axis):
        self.kinds.append("reduce-scatter")
        return self.size * x.narrow(dim, 0, x.shape[dim] // self.size)

    def all_reduce(self, x, axis, op="sum"):
        self.kinds.append("all-reduce")
        return self.size * x


# (frames, tokens, heads) on reduced whisper-medium at W 4 -> the memory's
# collectives, forward then backward: a partial gradient (a cross-attention
# split by heads, or the decoder's stream split) is summed once; a whole and
# equal one (every attention whole on the whole decoder stream) is not
MEMORY = {
    "both_split": ((24, 24, 4), ["all-gather", "reduce-scatter"]),
    "encoder_split_cross_split": ((24, 22, 4), ["all-gather", "reduce-scatter"]),
    "encoder_split_all_whole": ((24, 22, 6), ["all-gather"]),
    "decoder_split": ((26, 24, 6), ["all-reduce"]),
    "cross_split": ((26, 22, 4), ["all-reduce"]),
    "all_whole": ((26, 22, 6), []),
}


@pytest.mark.parametrize("case", sorted(MEMORY))
def test_the_memory_enters_the_decoder_once(case):
    (frames, tokens, heads), kinds = MEMORY[case]
    axis, _ = _whisper_axis(frames, tokens, 4, "tp_only", reduced=True, n_heads=heads)
    comm = axis.comm = _Recorder(4)
    enc = axis.on("enc_blocks").seq
    n = frames if enc is None else enc.hi - enc.lo
    memory = torch.randn(1, n, 64, requires_grad=True)
    whole = axis.memory_in(memory)
    assert whole.shape == (1, frames, 64)
    grad, = torch.autograd.grad(whole, memory, torch.ones_like(whole))
    assert comm.kinds == kinds
    # the rank's block of the gradient: W terms where they were partial
    assert float(grad.min()) == float(grad.max()) == (1.0 if kinds in ([], ["all-gather"])
                                                      else 4.0)
