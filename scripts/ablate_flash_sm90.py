#!/usr/bin/env python3
"""The tensor-core flash kernel against copies with one design choice undone.

    python3 scripts/ablate_flash_sm90.py

For each entry of ``ABLATIONS``, writes a copy of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu`` with
that choice undone under ``build/ablate/``, builds it beside the shipped
kernel (one nvcc each, in parallel), holds both against the plain twin, and
times them in turns (shipped, ablated, ablated, shipped) at the serving
shapes: recurrentgemma-9b prefill, gemma2-9b global with softcap and
mistral-nemo-12b's heads, all bf16. Prints one JSON line per shape and writes
them to ``chiprun_out/ablate_flash_sm90.json``. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import cuda_ms  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.cuda_build import CudaKernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402

# name -> [(text in the shipped source, text in the ablated copy)]
ABLATIONS = {
    # q tiles in grid order instead of heaviest (most keys) first
    "no_heaviest_first": [("const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;",
                           "const int q0 = blockIdx.z * BQ;")],
}

# name, B, S, Hq, Hkv, D, window, softcap
SHAPES = [
    ("recurrentgemma-9b prefill", 4, 2560, 16, 1, 256, 2048, None),
    ("gemma2-9b global, softcap", 2, 2560, 16, 8, 256, None, 50.0),
    ("mistral-nemo-12b heads", 2, 2560, 32, 8, 128, None, None),
]


def ablated_kernels():
    src = fa_ops.SOURCE_SM90.read_text()
    out_dir = ROOT / "build" / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source exactly once")
            text = text.replace(old, new)
        path = out_dir / f"flash_attention_sm90_{name}.cu"
        path.write_text(text)
        kernels[name] = CudaKernel(f"flash_attention_wgmma_{name}", path,
                                   fa_ops.WGMMA_KERNEL.symbol,
                                   fa_ops.WGMMA_KERNEL.argtypes[:-1])
    return kernels


def run_with(kernel, *args, **kw):
    """fa_ops' wgmma launcher with ``kernel`` in place of the shipped one."""
    shipped, fa_ops.WGMMA_KERNEL = fa_ops.WGMMA_KERNEL, kernel
    try:
        return fa_ops.flash_attention_wgmma_cuda(*args, **kw)
    finally:
        fa_ops.WGMMA_KERNEL = shipped


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    kernels = {"shipped": fa_ops.WGMMA_KERNEL, **ablated_kernels()}
    cuda_build.build(kernels.values())
    dev = torch.device("cuda")
    lines = []
    for case, B, S, Hq, Hkv, D, window, softcap in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + Hkv)
        q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
                   for H in (Hq, Hkv, Hkv))
        kw = dict(causal=True, window=window, softcap=softcap)
        want = fa_ref.attention_plain(q, k, v, **kw).float()
        rec = {"case": case, "gpu": gpu, "ms": {}, "max_abs_err": {}}
        for name, kern in kernels.items():
            diff = (run_with(kern, q, k, v, **kw).float() - want).abs()
            if not bool((diff <= 2e-2 * (1 + want.abs())).all()):
                raise RuntimeError(f"{name} at {case}: error above 2e-2 * (1 + |plain|)")
            rec["max_abs_err"][name] = float(diff.max())
        for name, kern in kernels.items():
            if name == "shipped":
                continue
            pair = {}
            for who in ("shipped", name, name, "shipped"):
                pair.setdefault(who, []).append(
                    cuda_ms(lambda: run_with(kernels[who], q, k, v, **kw), iters=20))
            rec["ms"][name] = pair
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ablate_flash_sm90.json").write_text(json.dumps(lines, indent=1) + "\n")


if __name__ == "__main__":
    main()
