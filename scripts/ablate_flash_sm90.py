#!/usr/bin/env python3
"""The tensor-core flash kernel against copies built at other design points.

    python3 scripts/ablate_flash_sm90.py [NAME ...]

For each entry of ``ABLATIONS`` (or only those named), writes a copy of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu`` under
``build/ablate/``: with one design choice undone (a text edit), or with some
of its ``#ifndef`` design constants defined at its top (the ring depth and
blocks an SM at head_dim 64). Builds each beside the shipped kernel (one nvcc
each, in parallel; ptxas's registers and spills printed), holds both against
the plain twin, and times them in turns (shipped, ablated, ablated, shipped)
at the entry's shapes: recurrentgemma-9b prefill, gemma2-9b global with
softcap and mistral-nemo-12b's heads for the edits; whisper-medium's encoder,
decoder and cross-attention (head_dim 64) for the head_dim-64 points; all
bf16. Prints one JSON line per shape and writes them to
``chiprun_out/ablate_flash_sm90.json``. Needs a CUDA card.
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

from chip_smoke import cuda_ms, print_ptxas  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.cuda_build import CudaKernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402

# name, B, S_q, S_k, Hq, Hkv, D, causal, window, softcap
SERVING_SHAPES = [
    ("recurrentgemma-9b prefill", 4, 2560, 2560, 16, 1, 256, True, 2048, None),
    ("gemma2-9b global, softcap", 2, 2560, 2560, 16, 8, 256, True, None, 50.0),
    ("mistral-nemo-12b heads", 2, 2560, 2560, 32, 8, 128, True, None, None),
]
WHISPER_SHAPES = [
    ("whisper-medium encoder", 4, 1500, 1500, 16, 16, 64, False, None, None),
    ("whisper-medium decoder", 4, 448, 448, 16, 16, 64, True, None, None),
    ("whisper-medium cross", 4, 448, 1500, 16, 16, 64, False, None, None),
]

# name -> (edits [(text in the shipped source, text in the copy)],
#          design constants defined before the source, the shapes it is timed at)
ABLATIONS = {
    # q tiles in grid order instead of heaviest (most keys) first
    "no_heaviest_first": ([("const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;",
                            "const int q0 = blockIdx.z * BQ;")], {}, SERVING_SHAPES),
    # head_dim 64: one block an SM (no register cap below 255), as at 128 / 256
    "d64_one_block": ([], {"FA_D64_BLOCKS_PER_SM": 1}, WHISPER_SHAPES),
    # one block an SM with a ring twice as deep
    "d64_one_block_8_stages": ([], {"FA_D64_BLOCKS_PER_SM": 1, "FA_D64_STAGES": 8},
                               WHISPER_SHAPES),
    # two blocks an SM, a shallower and a deeper ring (6 stages do not fit twice)
    "d64_3_stages": ([], {"FA_D64_STAGES": 3}, WHISPER_SHAPES),
    "d64_5_stages": ([], {"FA_D64_STAGES": 5}, WHISPER_SHAPES),
}


def ablated_kernels(names):
    src = fa_ops.SOURCE_SM90.read_text()
    out_dir = ROOT / "build" / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name in names:
        edits, consts, _ = ABLATIONS[name]
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source exactly once")
            text = text.replace(old, new)
        text = "".join(f"#define {k} {v}\n" for k, v in consts.items()) + text
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


def main(argv):
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    names = argv or list(ABLATIONS)
    unknown = sorted(set(names) - set(ABLATIONS))
    if unknown:
        raise SystemExit(f"unknown ablations {unknown}; known: {list(ABLATIONS)}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    kernels = {"shipped": fa_ops.WGMMA_KERNEL, **ablated_kernels(names)}
    cuda_build.build(kernels.values())
    for kern in kernels.values():
        print_ptxas(kern)
    dev = torch.device("cuda")
    shapes = []
    for name in names:
        shapes += [s for s in ABLATIONS[name][2] if s not in shapes]
    lines = []
    for case, B, S_q, S_k, Hq, Hkv, D, causal, window, softcap in shapes:
        g = torch.Generator(device=dev).manual_seed(S_q + Hkv)
        q = torch.randn(B, S_q, Hq, D, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(B, S_k, Hkv, D, generator=g, device=dev).bfloat16()
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        want = fa_ref.attention_plain(q, k, v, **kw).float()
        here = ["shipped"] + [n for n in names if (case, B, S_q, S_k, Hq, Hkv, D, causal,
                                                   window, softcap) in ABLATIONS[n][2]]
        rec = {"case": case, "gpu": gpu, "ms": {}, "max_abs_err": {}}
        for name in here:
            diff = (run_with(kernels[name], q, k, v, **kw).float() - want).abs()
            if not bool((diff <= 2e-2 * (1 + want.abs())).all()):
                raise RuntimeError(f"{name} at {case}: error above 2e-2 * (1 + |plain|)")
            rec["max_abs_err"][name] = float(diff.max())
        for name in here[1:]:
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
    main(sys.argv[1:])
