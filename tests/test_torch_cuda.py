"""The CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one. On the card:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference (the card's machine has
neither); the twins are held against the reference on the CPU in
``test_torch_kernels.py``. Tolerances: 1e-5 in fp32 (summation order);
2e-2 in bf16 (one bf16 ulp at |x| < 4); the RG-LRU scan is exact, as it
rounds like its twin (separate fp32 multiply and add).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref


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


@pytest.mark.cuda
def test_flash_kernel_fully_masked_rows_are_zero(cuda):
    q = torch.randn(1, 32, 2, 64, device=cuda)
    out = fa_ops.attention(q, q, q, causal=False, window=8, q_offset=30)
    dead = torch.arange(32, device=cuda) + 22 >= 31
    assert torch.all(out[:, dead] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,C", [(2, 64, 128), (1, 37, 100), (4, 300, 4096)])
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
