"""The CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one. On the card:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference (the card's machine has
neither); the twins are held against the reference on the CPU in
``test_torch_kernels.py``. Tolerances: 1e-5 in fp32 (summation order);
2e-2 * (1 + |plain|) in bf16 (one bf16 ulp of the output; the flash
attention tensor-core kernel, which serves bf16 at head_dim 64, 128 and 256,
also rounds P to bf16 before P V, a relative error of at most 2^-9 on
each weight of an average, well inside that bound); the RG-LRU scan and
the WKV6 state are exact, as they round like their twins (separate fp32
multiply and add).
"""

import copy
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref
from repro_torch.launch.perf import stray_knobs

# a knob left set would change the plain reference the port is held to
assert not stray_knobs(), f"unset {stray_knobs()} to run these tests"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CUDA_FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset
    (2, 64, 64, 4, 2, 16, True, None, None, 0),     # GQA causal
    (1, 48, 48, 8, 1, 64, True, None, None, 0),     # MQA
    (2, 32, 64, 4, 4, 16, False, None, None, 0),    # bidirectional
    (1, 64, 64, 2, 2, 256, True, 24, 50.0, 0),      # window+softcap, head_dim 256
    (1, 16, 64, 4, 2, 16, True, None, None, 48),    # decode tile at q_offset
    (1, 37, 37, 4, 2, 16, True, 8, None, 0),        # prime length
    (1, 64, 64, 4, 2, 32, True, 16, None, 0),       # sliding window
    (1, 64, 64, 4, 2, 16, True, None, 30.0, 0),     # logit softcap
    (2, 200, 200, 16, 1, 256, True, 64, None, 0),   # ragged tiles, MQA, window
    (1, 130, 130, 16, 8, 256, True, None, 50.0, 0), # gemma2 heads, softcap
    (1, 70, 70, 4, 2, 128, False, None, None, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CUDA_FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, case, dt):
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset = case
    g = torch.Generator(device=cuda).manual_seed(Sq + D)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out = fa_ops.attention(q, k, v, **kw)
    want = fa_ref.mha_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


WGMMA_FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset -- all bf16
    (2, 200, 200, 16, 1, 256, True, 64, None, 0),     # group 16, ragged, B 2
    (1, 2500, 2500, 16, 8, 256, True, 2048, 50.0, 0), # group 2, softcap, S % 64 != 0
    (1, 2500, 2500, 8, 8, 128, True, None, None, 0),  # group 1, head_dim 128
    (1, 100, 300, 4, 2, 128, True, None, None, 200),  # Sq < Sk at q_offset
    (1, 100, 300, 4, 1, 256, True, 24, None, 200),    # window below one tile
    (2, 300, 300, 4, 2, 128, True, 4096, 30.0, 0),    # window above S, softcap
    (1, 130, 130, 2, 2, 256, False, None, None, 0),   # bidirectional
    (3, 129, 129, 32, 8, 128, True, None, None, 0),   # mistral-nemo heads, one row past a tile
    (2, 1, 1, 16, 1, 256, True, 2048, None, 0),       # a one-token prompt
    (4, 2560, 2560, 64, 4, 128, True, None, None, 0), # qwen3-moe prefill, group 16
    (1, 2522, 2522, 64, 4, 128, True, None, None, 0), # qwen3-moe heads, ragged
    (1, 1030, 1030, 32, 8, 128, True, None, None, 0), # phi3.5-moe heads
    (1, 37, 37, 4, 2, 128, True, 8, None, 0),         # fewer keys than one tile
    (4, 1500, 1500, 16, 16, 64, False, None, None, 0),  # whisper-medium encoder
    (4, 448, 448, 16, 16, 64, True, None, None, 0),     # whisper-medium decoder
    (4, 448, 1500, 16, 16, 64, False, None, None, 0),   # whisper-medium cross
    (2, 100, 1037, 8, 8, 64, False, None, None, 0),     # ragged S_k, S_q < one tile
    (1, 300, 300, 8, 2, 64, True, 64, 30.0, 0),         # head_dim 64: GQA, window, softcap
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_FLASH_CASES)
def test_flash_wgmma_kernel_matches_plain_on_card(cuda, case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset = case
    assert fa_ops.kernel_for(torch.bfloat16, D) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(Sq + D)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16()
               for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    before = fa_ops.WGMMA_KERNEL.launches
    out = fa_ops.attention(q, k, v, **kw)
    want = fa_ref.mha_reference(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert fa_ops.WGMMA_KERNEL.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(((out.float() - want).abs() <= 2e-2 * (1 + want.abs())).all())


@pytest.mark.cuda
def test_flash_kernel_fully_masked_rows_are_zero(cuda):
    q = torch.randn(1, 32, 2, 64, device=cuda)
    out = fa_ops.attention(q, q, q, causal=False, window=8, q_offset=30)
    dead = torch.arange(32, device=cuda) + 22 >= 31
    assert torch.all(out[:, dead] == 0)


@pytest.mark.cuda
def test_flash_wgmma_kernel_fully_masked_rows_are_zero(cuda):
    """Rows at positions 30..69 against keys 0..39 with a window of 8: rows
    past position 46 see no key and get 0, as from the Pallas kernel."""
    q = torch.randn(1, 40, 2, 256, device=cuda).bfloat16()
    out = fa_ops.attention(q, q, q, causal=False, window=8, q_offset=30)
    want = fa_ref.mha_reference(q, q, q, causal=False, window=8, q_offset=30).float()
    torch.cuda.synchronize()
    dead = torch.arange(40, device=cuda) + 30 - 8 >= 39
    assert dead.any() and not dead.all()
    assert torch.all(out[:, dead] == 0)
    live = (out[:, ~dead].float() - want[:, ~dead]).abs()
    assert bool((live <= 2e-2 * (1 + want[:, ~dead].abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt,D,kernel", [
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 256, "simt"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "simt"),
])
def test_flash_call_moves_only_its_kernels_count(cuda, dt, D, kernel):
    counts = {"wgmma": fa_ops.WGMMA_KERNEL, "simt": fa_ops.KERNEL}
    before = {name: kern.launches for name, kern in counts.items()}
    x = torch.randn(1, 70, 4, D, device=cuda).to(dt)
    fa_ops.attention(x, x, x, window=32)
    torch.cuda.synchronize()
    after = {name: kern.launches for name, kern in counts.items()}
    assert after == {name: n + (name == kernel) for name, n in before.items()}


@pytest.mark.cuda
def test_flash_wgmma_kernel_rejects_non_contiguous_or_misaligned_q(cuda):
    k = torch.zeros(1, 64, 2, 256, device=cuda, dtype=torch.bfloat16)
    strided = torch.zeros(1, 2, 64, 256, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.attention(strided, k, k)
    flat = torch.zeros(k.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(k.shape)   # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.attention(shifted, k, k)
    before = fa_ops.WGMMA_KERNEL.launches
    with pytest.raises(ValueError):
        fa_ops.flash_attention_wgmma_cuda(k.float(), k.float(), k.float())
    assert fa_ops.WGMMA_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,C", [
    (2, 64, 128),
    (1, 37, 100),     # bf16: a row of 200 bytes, the simple path
    (4, 300, 4096),   # the serving width, T across the ring and past it
    (3, 193, 4000),   # one step past a full ring of 6 x 32, a part tile of channels
    (1, 5, 4096),     # T inside one ring stage
    (2, 33, 4096),    # one step past a stage
])
def test_rglru_kernel_matches_plain_on_card(cuda, B, T, C, with_h0, dt):
    g = torch.Generator(device=cuda).manual_seed(T)
    a = (0.7 + 0.299 * torch.rand(B, T, C, generator=g, device=cuda)).to(dt)
    b = (0.1 * torch.randn(B, T, C, generator=g, device=cuda)).to(dt)
    h0 = (0.1 * torch.randn(B, C, generator=g, device=cuda)).to(dt) if with_h0 else None
    h, h_final = lru_ops.linear_scan(a, b, h0)
    want, want_final = lru_ref.linear_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    # the kernel rounds as the plain loop does (separate multiply and add)
    torch.testing.assert_close(h, want, atol=0, rtol=0)
    assert h_final.dtype == dt
    torch.testing.assert_close(h_final, want_final.to(dt), atol=0, rtol=0)


@pytest.mark.cuda
def test_rglru_ring_path_refuses_a_row_tma_cannot_map(cuda):
    """bf16 C = 100 is a 200-byte row: asked for the ring path, the kernel
    refuses the launch instead of misreading it."""
    a = torch.full((1, 8, 100), 0.5, dtype=torch.bfloat16, device=cuda)
    h, h_final = torch.empty_like(a), torch.empty((1, 100), dtype=a.dtype, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        lru_ops.KERNEL.launch(cuda, a.data_ptr(), a.data_ptr(), None, h.data_ptr(),
                              h_final.data_ptr(), 1, 8, 100, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,C", [
    (2, 2560, 4096),  # the training shape's width, T past many rings
    (3, 193, 4000),   # one step past a full ring, a part tile of channels
    (1, 5, 4096),     # T inside one ring stage
    (1, 37, 100),     # a bf16 row of 200 bytes: the simple path
])
def test_rglru_kernel_bf16_a_fp32_b_matches_plain_on_card(cuda, B, T, C, with_h0):
    """The training backward's pair: a bf16 decay, an fp32 b read as fp32;
    h (and h0) in a's dtype. Exact, as for the matching pairs."""
    g = torch.Generator(device=cuda).manual_seed(T + C)
    a = (0.7 + 0.299 * torch.rand(B, T, C, generator=g, device=cuda)).bfloat16()
    b = 0.1 * torch.randn(B, T, C, generator=g, device=cuda)
    h0 = (0.1 * torch.randn(B, C, generator=g, device=cuda)).bfloat16() if with_h0 else None
    assert lru_ops.route_for(a.dtype, C, b.dtype) == ("simple" if C == 100 else "ring")
    h, h_final = lru_ops.linear_scan(a, b, h0)
    want, want_final = lru_ref.linear_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    assert h.dtype == h_final.dtype == torch.bfloat16
    torch.testing.assert_close(h, want, atol=0, rtol=0)
    torch.testing.assert_close(h_final, want_final.bfloat16(), atol=0, rtol=0)


def _grads(fn, inputs, cot):
    """fn(*inputs) -> outputs; their VJP with cotangents ``cot``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return out, torch.autograd.grad(out, leaves, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,D", [(torch.float32, 64), (torch.bfloat16, 256),
                                  (torch.bfloat16, 64)])
def test_flash_function_grads_on_card_match_autograd_through_plain(cuda, dt, D):
    """The attention Function (the kernel forward, a recompute backward)
    against autograd through ``mha_reference`` on the same card."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn(2, 300, 8, D, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(2, 300, 2, D, generator=g, device=cuda).to(dt) for _ in range(2))
    cot = torch.randn(2, 300, 8, D, generator=g, device=cuda).to(dt)
    kw = dict(causal=True, window=100, softcap=30.0)
    kern = fa_ops.WGMMA_KERNEL if fa_ops.kernel_for(dt, D) == "wgmma" else fa_ops.KERNEL
    before = kern.launches
    (out,), grads = _grads(lambda *x: fa_ops.attention(*x, **kw), (q, k, v), cot)
    (want,), want_grads = _grads(lambda *x: fa_ref.mha_reference(*x, **kw), (q, k, v), cot)
    torch.cuda.synchronize()
    assert kern.launches == before + 1  # the forward only; the backward recomputes plainly
    tol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for got, w in zip(grads, want_grads):
        torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_scan_function_grads_on_card_match_autograd_through_plain(cuda, dt):
    """da, db, dh0 of ``linear_scan`` (the kernel forward and the kernel again
    on reversed inputs) against autograd through the plain loop. In bf16 the
    VJP rounds g and reads h in bf16, as the reference's does, where autograd
    through the loop keeps both in fp32: one bf16 ulp of the largest."""
    B, T, C = 2, 96, 4096
    g = torch.Generator(device=cuda).manual_seed(5)
    a = (0.7 + 0.299 * torch.rand(B, T, C, generator=g, device=cuda)).to(dt)
    b = (0.1 * torch.randn(B, T, C, generator=g, device=cuda)).to(dt)
    h0 = (0.1 * torch.randn(B, C, generator=g, device=cuda)).to(dt)
    dh = torch.randn(B, T, C, generator=g, device=cuda).to(dt)
    dh_final = torch.randn(B, C, generator=g, device=cuda).to(dt)
    before = lru_ops.KERNEL.launches
    (h, hn), grads = _grads(lru_ops.linear_scan, (a, b, h0), (dh, dh_final))
    # the plain loop's h_final is fp32: the same cotangent, widened
    (want, _), want_grads = _grads(lru_ref.linear_scan_reference, (a, b, h0),
                                   (dh, dh_final.float()))
    torch.cuda.synchronize()
    assert lru_ops.KERNEL.launches == before + 2
    torch.testing.assert_close(h, want, atol=0, rtol=0)
    for got, w in zip(grads, want_grads):
        tol = 1e-5 * float(w.abs().max()) if dt == torch.float32 else (
            2e-2 * float(w.abs().max()))
        assert got.dtype == w.dtype == dt
        torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One fp32 train step of reduced recurrentgemma-9b (remat "nothing"),
    card against CPU from the same weights and batch: the loss, the clipped
    gradients' norm, and the moments the step leaves (mu = 0.1 g and
    nu = 0.001 g^2 after one step: the gradients, leaf by leaf, within 1e-4
    of each leaf's largest). The parameters themselves are not compared: a
    first Adam step moves each by lr * g / (|g| + eps), which turns a
    rounding difference in a near-zero gradient into one of up to lr. The
    launches are the path's: 2 attention layers in groups (forward and
    recompute) on the CUDA-core flash kernel; 4 RG-LRU layers in groups
    (forward, recompute, backward) and 2 in the tail (forward, backward) on
    the scan."""
    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainRunConfig, make_train_step
    from repro_torch.weights import init_params

    cfg = ARCHS["recurrentgemma-9b"].reduced()
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 48, 2, seed=1)).batch(0)
    run = TrainRunConfig(optimizer=AdamWConfig(lr=1e-3, weight_decay=0.1), total_steps=10,
                         warmup_steps=0, compute_dtype=torch.float32)
    out = {}
    for dev in ("cpu", cuda):
        lm = init_params(cfg, seed=0, device="cpu").to(dev)
        step, opt_init = make_train_step(build_model(cfg, device=dev), run)
        counts = [fa_ops.KERNEL.launches, lru_ops.KERNEL.launches]
        lm, state, metrics = step(lm, opt_init(lm), batch)
        out[str(dev)] = (float(metrics["loss"]), float(metrics["grad_norm"]), state,
                         [fa_ops.KERNEL.launches - counts[0],
                          lru_ops.KERNEL.launches - counts[1]])
    (loss_c, norm_c, st_c, n_c), (loss_g, norm_g, st_g, n_g) = out["cpu"], out["cuda"]
    assert n_c == [0, 0] and n_g == [4, 16]
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    assert abs(norm_g - norm_c) <= 1e-4 * norm_c
    assert st_g.step == st_c.step == 1
    for moments_g, moments_c in ((st_g.mu, st_c.mu), (st_g.nu, st_c.nu)):
        for n, m in moments_c.items():
            err = float((moments_g[n].cpu() - m).abs().max())
            assert err <= 1e-4 * float(m.abs().max()), (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"])
def test_moe_prefill_and_decode_on_card_match_cpu(cuda, name):
    """A reduced MoE model (experts, routing with drops in decode, qwen3's
    QK-norm) at head_dim 128, fp32: prefill over 200 positions and 3 greedy
    decode steps on the card against the same weights on the CPU. The flash
    kernel (CUDA cores, fp32) runs once a layer in the prefill, never in
    decode; logits within 1e-4 (fp32 sums in another order), the same
    greedy tokens."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    from repro_torch.weights import init_params

    cfg = dataclasses.replace(ARCHS[name].reduced(), d_model=256, head_dim=128, d_ff=256)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 200)))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev)
        lm = init_params(cfg, seed=0, device="cpu").to(dev)
        cache = model.init_cache(2, 256, torch.float32)
        before = fa_ops.KERNEL.launches
        with torch.inference_mode():
            logits, cache = model.prefill(lm, {"tokens": toks.to(dev)}, cache)
            launches = [fa_ops.KERNEL.launches - before]
            steps = [logits.float().cpu()]
            for _ in range(3):
                nxt = steps[-1].argmax(-1)
                logits, cache = model.decode_step(lm, cache, nxt.to(dev))
                steps.append(logits.float().cpu())
        launches.append(fa_ops.KERNEL.launches - before - launches[0])
        out[str(dev)] = (torch.cat(steps, 1), launches)
    (want, n_cpu), (got, n_card) = out["cpu"], out["cuda"]
    assert n_cpu == [0, 0] and n_card == [cfg.n_layers, 0]
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def _whisper_runs(cfg, dtype, devices, S=10, steps=6):
    """Reduced whisper from seeded fp32 weights, run in ``dtype`` on each
    device in turn: the encode's memory (20 frames against a 16-row
    enc_pos), the teacher-forced logits, and ``steps`` greedy decode steps
    (every device is fed the first device's choices); each device's flash
    launches (CUDA-core, tensor-core) in the encode, in decode_train and in
    decode. Outputs come back as fp32 on the CPU."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.weights import init_params

    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    weights = init_params(cfg, seed=0, device="cpu")
    kerns = (fa_ops.KERNEL, fa_ops.WGMMA_KERNEL)
    fed, out = [toks[:, :1]], {}
    for dev in devices:
        model = build_model(cfg, device=dev)
        params = copy.deepcopy(weights).to(dev, dtype)
        marks = [[k.launches for k in kerns]]
        with torch.inference_mode():
            memory, cache = model.prefill(params, {"frames": frames.to(dev, dtype)},
                                          model.init_cache(2, 32, dtype))
            marks.append([k.launches for k in kerns])
            teacher = params.decode_train(toks.to(dev), memory)
            marks.append([k.launches for k in kerns])
            logits = []
            for t in range(steps):
                step, cache = model.decode_step(params, cache, fed[t].to(dev), memory)
                logits.append(step.float().cpu())
                if len(fed) < steps:
                    fed.append(logits[-1].argmax(-1))
            marks.append([k.launches for k in kerns])
        launches = [tuple(b - a for a, b in zip(m0, m1)) for m0, m1 in zip(marks, marks[1:])]
        out[str(dev)] = (memory.float().cpu(), teacher.float().cpu(), logits, launches)
    return out


@pytest.mark.cuda
def test_whisper_encode_decode_train_and_decode_on_card_match_cpu(cuda):
    """Reduced whisper (2 + 2 layers, head_dim 16) in fp32: memory, the
    teacher-forced logits and 6 greedy decode steps on the card against the
    same weights on the CPU, within 1e-4 (fp32 sums in another order) and
    with the same argmax. The CUDA-core flash kernel runs once a layer in the
    encode and twice a decoder layer (self, cross) in decode_train, never in
    decode."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS["whisper-medium"].reduced()
    runs = _whisper_runs(cfg, torch.float32, ["cpu", cuda])
    (m0, t0, s0, n0), (m1, t1, s1, n1) = runs["cpu"], runs["cuda"]
    assert n0 == [(0, 0)] * 3 and n1 == [(2, 0), (4, 0), (0, 0)]
    for got, want in [(m1, m0), (t1, t0)] + list(zip(s1, s0)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_whisper_bf16_at_head_dim_64_runs_the_tensor_core_kernel(cuda):
    """Reduced whisper widened to head_dim 64 (d 128, 2 heads) in bf16: every
    attention of the encode and of decode_train launches the tensor-core
    kernel, decode none; the card's bf16 memory and logits lie within 5e-2
    of their largest magnitude from the CPU's fp32 run from the same seed
    (weights and activations rounded to bf16 on the card, 2 + 2 layers)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS["whisper-medium"].reduced(), d_model=128, n_heads=2,
                              n_kv_heads=2, head_dim=64)
    card = _whisper_runs(cfg, torch.bfloat16, [cuda])["cuda"]
    assert card[3] == [(0, 2), (0, 4), (0, 0)]
    cpu = _whisper_runs(cfg, torch.float32, ["cpu"])["cpu"]
    for got, want in [(card[0], cpu[0]), (card[1], cpu[1])]:
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())


def _wkv_inputs(device, B, T, H, dt, with_s0, seed):
    """Decays in (0.5, 1) and O(1) inputs, as the time mix feeds the kernel."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (0.5 * torch.randn(B, T, H, 64, generator=g, device=device) for _ in range(3))
    w = 0.5 + 0.4999 * torch.rand(B, T, H, 64, generator=g, device=device)
    u = 0.5 * torch.randn(H, 64, generator=g, device=device)
    s0 = torch.randn(B, H, 64, 64, generator=g, device=device) if with_s0 else None
    return [t.to(dt) for t in (r, k, v, w, u)] + [s0]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("B,T,H", [
    (4, 1, 64),     # a decode step at full width
    (3, 37, 8),     # ragged: T is not a multiple of the staged chunk
    (2, 16, 2),     # exactly one chunk
    (2, 15, 4),     # one step short of a chunk
    (2, 17, 4),     # one step past a chunk
    (1, 48, 2),     # one whole ring of 3 chunks, B * H far below the SM count
    (1, 49, 1),     # one step past the ring, one head
    (1, 64, 2),     # four chunks: the ring wraps
    (1, 65, 1),     # one step past four chunks
    (4, 300, 64),   # the serving width: 256 blocks, about two per SM
])
def test_wkv6_kernel_matches_plain_on_card(cuda, B, T, H, with_s0, dt):
    r, k, v, w, u, s0 = _wkv_inputs(cuda, B, T, H, dt, with_s0, seed=T + H)
    y, s_final = wkv_ops.wkv(r, k, v, w, u, s0)
    want, want_final = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert y.dtype == dt and s_final.dtype == torch.float32
    # the state update rounds as the plain loop does; y's K-sum runs in
    # another order (fp32), then both round to dt
    torch.testing.assert_close(s_final, want_final, atol=0, rtol=0)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    scale = 1.0 + want.float().abs()
    assert bool(((y.float() - want.float()).abs() <= tol * scale).all())


@pytest.mark.cuda
def test_wkv6_kernel_chains_state_on_card(cuda):
    """Two halves with the state carried give the whole, bit for bit."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, 50, 4, torch.float32, True, seed=5)
    y, s = wkv_ops.wkv(r, k, v, w, u, s0)
    y1, s1 = wkv_ops.wkv(*(t[:, :23].contiguous() for t in (r, k, v, w)), u, s0)
    y2, s2 = wkv_ops.wkv(*(t[:, 23:].contiguous() for t in (r, k, v, w)), u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=0, rtol=0)
    torch.testing.assert_close(s2, s, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 37])
def test_wkv6_kernel_writes_its_state_in_place_on_card(cuda, T):
    """s_final may be s0 itself (the decode cache): same bits as a fresh one."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 4, T, 64, torch.bfloat16, True, seed=T)
    y, s = wkv_ops.wkv(r, k, v, w, u, s0)
    state = s0.clone()
    y_in, s_in = wkv_ops.wkv(r, k, v, w, u, state, out=state)
    torch.cuda.synchronize()
    assert s_in is state
    torch.testing.assert_close(y_in, y, atol=0, rtol=0)
    torch.testing.assert_close(state, s, atol=0, rtol=0)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.attention(x, x, x)                       # head_dim 48
    y = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.attention(y, y.transpose(1, 2).contiguous().transpose(1, 2), y)
    a = torch.zeros(1, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        lru_ops.linear_scan(a, a)
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 1, 4, 2, torch.float32, True, seed=0)
    small = torch.zeros(1, 4, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        wkv_ops.wkv(small, small, small, small, torch.zeros(2, 16, device=cuda))  # K 16
    with pytest.raises(ValueError):
        wkv_ops.wkv(r.half(), k.half(), v.half(), w.half(), u.half())          # fp16
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k, v, w, u, s0.bfloat16())                             # bf16 state
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k.bfloat16(), v, w, u)                                 # mixed types
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k, v.transpose(1, 2).contiguous().transpose(1, 2), w, u)
    both = torch.zeros(2, *s0.shape, device=cuda).flatten()
    with pytest.raises(ValueError):                                           # out overlaps s0
        wkv_ops.wkv(r, k, v, w, u, both[:s0.numel()].view_as(s0),
                    out=both[64:64 + s0.numel()].view_as(s0))


# ---------------------------------------------------------------------------
# The dispatcher's fused descent: one CUDA graph replay a descent
# ---------------------------------------------------------------------------

def _dispatch_stack(name="H100"):
    from repro_torch import core

    cl = core.PAPER_CLUSTERS[name]()
    sim = core.BandwidthSimulator(cl)
    return core, cl, core.IntraHostTables(cl, sim)


def _surrogate(seed, device, bias=1.2):
    """Random weights with the head's output bias raised, so predictions sit
    near real bandwidths (about 400 GB/s) and the contention caps bind."""
    from repro_torch.core import surrogate as surr

    params = surr.init_hierarchical_params(torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        params.trunk.head[2].b += bias
    return params.to(device)


def _tenanted(core, cl):
    led = core.JobLedger(cl)
    led.admit("a", [0, 1, cl.hosts[1].gpu_ids[0]])
    led.admit("b", [cl.hosts[1].gpu_ids[1], cl.hosts[-1].gpu_ids[0]])
    return led


def _on_cpu(params):
    return copy.deepcopy(params).to("cpu")  # Module.to moves in place


def _same_result(a, b):
    assert a.subset == b.subset and a.n_rounds == b.n_rounds and a.n_capped == b.n_capped
    np.testing.assert_array_equal(a.sels, b.sels)
    np.testing.assert_array_equal(a.elims, b.elims)
    np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5)


@pytest.mark.cuda
def test_descent_graph_replay_matches_eager(cuda):
    """The captured graph gives the eager descent's ScanResult (scores to
    1e-5: the same float32 program; eliminations identical), isolated and
    through the contention caps, and each descent is one replay."""
    from repro_torch.core import surrogate as surr

    core, cl, tables = _dispatch_stack()
    params = _surrogate(0, cuda)
    pred = core.SurrogatePredictor(cl, tables, params)
    assert pred.warm_scan() >= 0.0
    rng = np.random.default_rng(0)
    led = _tenanted(core, cl)
    wrapped = core.ContentionAwarePredictor(cl, pred, led)
    free = sorted(set(range(cl.n_gpus)) - led.busy())
    for n0, k in ((32, 8), (20, 4), (12, 6), (9, 2)):
        parent = sorted(rng.choice(cl.n_gpus, size=n0, replace=False).tolist())
        res = pred.eliminate_to(parent, k)
        key, f32, i32 = pred.scan_inputs(parent, k)
        eager = surr._scan_from_buffers(params, key, torch.from_numpy(f32).to(cuda),
                                        torch.from_numpy(i32).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(pred._run_scan(key, f32, i32), eager, rtol=1e-5)
        cpu = core.SurrogatePredictor(cl, tables, _on_cpu(params))
        _same_result(res, cpu.eliminate_to(parent, k))
        capped = sorted(rng.choice(free, size=min(n0, len(free)), replace=False).tolist())
        res = wrapped.eliminate_to(capped, k)
        cpu_wrapped = core.ContentionAwarePredictor(cl, cpu, led)
        _same_result(res, cpu_wrapped.eliminate_to(capped, k))
    assert pred.n_graph_replays == pred.n_descents > 0


@pytest.mark.cuda
def test_descent_graph_gives_each_predictor_its_own_weights(cuda):
    """Two predictors with different weights share one bucket's graph; each
    gets the scores of its own parameters, in either order."""
    core, cl, tables = _dispatch_stack()
    a = core.SurrogatePredictor(cl, tables, _surrogate(1, cuda))
    b = core.SurrogatePredictor(cl, tables, _surrogate(2, cuda, bias=0.8))
    parent = list(range(4)) + list(range(8, 14)) + list(range(16, 20))
    want = {}
    for name, pred in (("a", a), ("b", b)):
        cpu = core.SurrogatePredictor(cl, tables, _on_cpu(pred.params))
        want[name] = cpu.eliminate_to(parent, 5)
    for name, pred in (("a", a), ("b", b), ("a", a), ("b", b)):
        _same_result(pred.eliminate_to(parent, 5), want[name])
    assert not np.allclose(want["a"].scores, want["b"].scores)
    assert a.n_graph_replays == b.n_graph_replays == 2


@pytest.mark.cuda
def test_concurrent_descents_match_serial(cuda):
    """Four threads descend at once through the same bucket graphs (replays
    serialize on each graph's lock); every result equals the serial one."""
    core, cl, tables = _dispatch_stack("Het-4Mix")
    pred = core.SurrogatePredictor(cl, tables, _surrogate(3, cuda))
    rng = np.random.default_rng(4)
    jobs = [(sorted(rng.choice(cl.n_gpus, size=int(n0), replace=False).tolist()), int(k))
            for n0, k in zip(rng.integers(9, 33, size=24), rng.integers(2, 9, size=24))]
    jobs = [(p, k) for p, k in jobs if len(cl.partition_by_host(p)) > 1]
    serial = [pred.eliminate_to(p, k) for p, k in jobs]
    out = [None] * len(jobs)

    def work(w):
        for i in range(w, len(jobs), 4):
            out[i] = pred.eliminate_to(*jobs[i])

    threads = [threading.Thread(target=work, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for got, want in zip(out, serial):
        _same_result(got, want)
    assert pred.n_graph_replays == pred.n_descents == 2 * len(jobs)


@pytest.mark.cuda
def test_surrogate_trains_and_scores_on_card(cuda):
    """train_surrogate(device="cuda") keeps the model on the card, matches
    the CPU's loss curve from the same init and batches (2e-3 relative, as
    on the CPU against the reference), and its predictor scores there."""
    core, cl, tables = _dispatch_stack()
    sim = core.BandwidthSimulator(cl)
    train, test = core.make_train_test_split(sim, 64, seed=0)
    cfg = core.TrainConfig(steps=30, batch_size=32)
    init = _surrogate(5, "cpu", bias=0.0)
    params, info = core.train_surrogate(cl, tables, train, cfg, init_params=init)
    assert params.device.type == "cuda"
    _, cpu_info = core.train_surrogate(cl, tables, train, cfg, init_params=init, device="cpu")
    np.testing.assert_allclose(info["loss_curve"], cpu_info["loss_curve"], rtol=2e-3)
    pred = core.SurrogatePredictor(cl, tables, params)
    cpu = core.SurrogatePredictor(cl, tables, _on_cpu(params))
    subsets = [s for s, _ in test]
    np.testing.assert_allclose(pred.predict(subsets), cpu.predict(subsets), rtol=1e-4)


# ---------------------------------------------------------------------------
# The sharded training step on a 1-rank NCCL mesh
# ---------------------------------------------------------------------------

def _sharded_setup():
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainRunConfig

    cfg = ARCHS["recurrentgemma-9b"].reduced()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=1))
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-3, weight_decay=0.01), total_steps=4,
                         warmup_steps=1, compute_dtype=torch.bfloat16)
    return cfg, data, run


@pytest.mark.cuda
def test_sharded_step_on_one_card_is_train_loop(cuda, tmp_path):
    """On a 1-rank mesh the gathers and reductions move nothing: 2 steps,
    a checkpoint of the DTensor state restored into a fresh mesh's
    placements, 2 more, give train_loop's losses and parameters (bf16
    compute, the card's kernels; same operations, so 1e-5 relative is
    generous). The flash and scan kernels run on the rank's weight blocks,
    on one rank the whole weights."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import make_mesh_from_devices, process_group
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import LM
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.fsdp import ShardedModel, full_state
    from repro_torch.train.train_loop import make_train_step, train_loop

    cfg, data, run = _sharded_setup()
    model = build_model(cfg)
    lm, _, hist = train_loop(model, model.init(0), data.batches(4), run, log_every=1)
    want = [h["loss"] for h in hist]
    rules = shd.STRATEGIES["fsdp_tp"]()
    ck = Checkpointer(str(tmp_path), keep=1)
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        sharded = ShardedModel(model, mesh, rules)
        for kern in KERNELS:
            kern.launches = 0
        slm, state, h1 = train_loop(sharded, sharded.init(0), data.batches(2), run,
                                    log_every=1, checkpointer=ck, checkpoint_every=2)
        launches = {kern.name: kern.launches for kern in KERNELS}
        del slm, state
        again = ShardedModel(model, make_mesh_from_devices([0], (1, 1), ("data", "model"),
                                                           "cuda"), rules)
        fresh = again.shard(LM(cfg, cuda, torch.float32))
        step, restored = ck.restore({"params": fresh,
                                     "opt": make_train_step(again, run)[1](fresh)})
        slm, state, h2 = train_loop(again, restored["params"], data.batches(2, start=2), run,
                                    log_every=1, start_step=step, opt_state=restored["opt"])
        got = full_state(slm)
    assert step == 2 and state.step == 4
    assert launches["flash_attention_wgmma"] + launches["flash_attention"] > 0
    assert launches["rglru_scan"] > 0
    np.testing.assert_allclose([h["loss"] for h in h1 + h2], want, rtol=1e-5)
    for n, p in lm.named_parameters():
        torch.testing.assert_close(got[n], p.detach(), rtol=1e-5, atol=1e-6)
