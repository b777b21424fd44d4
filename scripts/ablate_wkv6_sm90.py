#!/usr/bin/env python3
"""The WKV6 kernel at other design points than the one that ships.

    python3 scripts/ablate_wkv6_sm90.py

``src/repro_torch/kernels/rwkv6/csrc/wkv6.cu`` takes its design constants
(columns a block holds, threads sharing a column group, columns a thread
holds, steps a chunk, chunks in the ring) from ``#ifndef`` defaults. For
each entry of ``POINTS`` this writes a copy of the source with those
constants defined at its top under ``build/ablate/``, builds it beside the
shipped kernel (one nvcc each, in parallel), holds both against the plain
twin (``s_final`` exact, y within 2e-2 * (1 + |plain|)), and times them in
turns (shipped, point, point, shipped) at rwkv6-7b's prefill shape (B 4,
T 2560, H 64, bf16) and at its decode step (T 1 with the state carried,
written in place). The decode step is timed as the replay of a CUDA graph
of 20 steps, which leaves the wrapper's host time out. Prints one JSON line per shape and writes them to
``chiprun_out/ablate_wkv6_sm90.json``. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import cuda_ms, graph_ms  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.cuda_build import CudaKernel  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref  # noqa: E402

# name -> the constants defined before the source; the rest keep their defaults
POINTS = {
    "vt8": {"WKV_VT": 8},                            # 64 threads: 8 rows x 8 columns
    "ks16": {"WKV_KSPLIT": 4},                       # 64 threads: 16 rows x 4 columns
    "chunk8": {"WKV_CHUNK": 8},                      # twice the barriers per step
    "ring2": {"WKV_NSTAGE": 2},                      # one chunk ahead instead of two
    "ring4": {"WKV_NSTAGE": 4},                      # three chunks ahead
}

# name, B, T, H, with s0 (written in place)
SHAPES = [("rwkv6-7b prefill", 4, 2560, 64, False), ("rwkv6-7b decode step", 4, 1, 64, True)]


def point_kernels():
    src = wkv_ops.SOURCE.read_text()
    out_dir = ROOT / "build" / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, consts in POINTS.items():
        path = out_dir / f"wkv6_{name}.cu"
        path.write_text("".join(f"#define {k} {v}\n" for k, v in consts.items()) + src)
        kernels[name] = CudaKernel(f"wkv6_{name}", path, wkv_ops.KERNEL.symbol,
                                   wkv_ops.KERNEL.argtypes[:-1])
    return kernels


def run_with(kernel, *args, **kw):
    """wkv_ops' launcher with ``kernel`` in place of the shipped one."""
    shipped, wkv_ops.KERNEL = wkv_ops.KERNEL, kernel
    try:
        return wkv_ops.wkv6_cuda(*args, **kw)
    finally:
        wkv_ops.KERNEL = shipped


def design(kernel):
    vals = (ctypes.c_int * 6)()
    lib = ctypes.CDLL(str(kernel.library))
    lib.wkv6_design(vals)
    return {"VS": vals[0], "KSPLIT": vals[1], "VT": vals[2], "CHUNK": vals[3],
            "NSTAGE": vals[4], "threads": vals[5], "smem_bytes_bf16": lib.wkv6_smem_bytes(1)}


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    kernels = {"shipped": wkv_ops.KERNEL, **point_kernels()}
    cuda_build.build(kernels.values())
    designs = {name: design(kern) for name, kern in kernels.items()}
    print(json.dumps({"designs": designs}), flush=True)
    dev = torch.device("cuda")
    lines = []
    for case, B, T, H, with_s0 in SHAPES:
        g = torch.Generator(device=dev).manual_seed(T + H)
        r, k, v = (0.5 * torch.randn(B, T, H, 64, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + 5.5 * torch.rand(B, T, H, 64, generator=g,
                                                         device=dev))).bfloat16()
        u = (0.5 * torch.randn(H, 64, generator=g, device=dev)).bfloat16()
        s0 = torch.randn(B, H, 64, 64, generator=g, device=dev) if with_s0 else None
        want, want_final = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
        rec = {"case": case, "gpu": gpu, "shape": [B, T, H, 64, 64], "ms": {},
               "max_abs_err": {}}
        for name, kern in kernels.items():
            y, s_final = run_with(kern, r, k, v, w, u, s0)
            diff = (y.float() - want.float()).abs()
            if not bool((diff <= 2e-2 * (1 + want.float().abs())).all()):
                raise RuntimeError(f"{name} at {case}: y error above 2e-2 * (1 + |plain|)")
            if not torch.equal(s_final, want_final):
                raise RuntimeError(f"{name} at {case}: s_final differs from the twin")
            rec["max_abs_err"][name] = float(diff.max())
        if with_s0:  # a decode step: the state is the cache, updated in place
            state = s0.clone()
            timer = graph_ms
            call = lambda kern: (lambda: run_with(kern, r, k, v, w, u, state, out=state))  # noqa: E731
        else:
            timer = lambda fn: cuda_ms(fn, iters=20)  # noqa: E731
            call = lambda kern: (lambda: run_with(kern, r, k, v, w, u))  # noqa: E731
        for name in kernels:
            if name == "shipped":
                continue
            pair = {}
            for who in ("shipped", name, name, "shipped"):
                pair.setdefault(who, []).append(timer(call(kernels[who])))
            rec["ms"][name] = pair
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ablate_wkv6_sm90.json").write_text(
        json.dumps({"designs": designs, "shapes": lines}, indent=1) + "\n")


if __name__ == "__main__":
    main()
