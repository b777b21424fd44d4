"""Where the time goes in the PyTorch port's serve path, on the card.

    python3 scripts/profile_torch_serve.py [--arch recurrentgemma-9b] [--layers N]

Serves one warm-up batch with the port (full width, random seeded bf16
weights, 4 requests of 2304-2560 tokens, as ``chip_smoke.py``), then
profiles one prefill and 8 decode steps of a second batch with
``torch.profiler``. Prints, for each phase, the host wall time, the summed
device kernel time (one stream, so kernels do not overlap), the device's
idle share, the kernels that take the most device time, and the port's own
kernels' device time and launches; writes the same to
``chiprun_out/profile_<arch>.json``. Fails if the profiler sees no device
time.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


# the port's kernels, by a piece of their CUDA function's name
PORT_KERNELS = {"flash_attention_wgmma": "flash_fwd_sm90", "flash_attention": "flash_fwd_kernel",
                "rglru_scan": "rglru_scan_kernel", "wkv6": "wkv6_kernel"}


def _device_kernels(prof):
    """(total device us, {kernel name: device us}, {kernel name: launches})
    from the profiler's events."""
    per, n = collections.Counter(), collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per[evt.name] += evt.time_range.elapsed_us()
            n[evt.name] += 1
    return sum(per.values()), per, n


def _phase(name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, per, n = _device_kernels(prof)
    if busy_us <= 0:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    top = [{"kernel": k[:120], "ms": us / 1e3, "share_of_busy": us / busy_us}
           for k, us in per.most_common(12)]
    rec = {"phase": name, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / wall_us, "n_kernel_names": len(per),
           "top": top, "port_kernels": {}}
    for port, piece in PORT_KERNELS.items():
        names = [k for k in per if piece in k]
        us = sum(per[k] for k in names)
        rec["port_kernels"][port] = {"ms": us / 1e3, "share_of_busy": us / busy_us,
                                     "launches": sum(n[k] for k in names)}
    print(f"{name}: wall {rec['wall_ms']:.2f} ms, device busy {rec['device_busy_ms']:.2f} ms, "
          f"idle share {rec['idle_share']:.3f}")
    for t in top:
        print(f"  {t['ms']:10.3f} ms  {100 * t['share_of_busy']:5.1f}%  {t['kernel']}")
    for port, t in rec["port_kernels"].items():
        print(f"  port kernel {port}: {t['ms']:.3f} ms, {100 * t['share_of_busy']:.1f}%, "
              f"{t['launches']} launches")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (qwen3-moe-235b-a22b: 8 fit the card)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(_smi())
    cuda_build.build(KERNELS)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(args.seed, torch.bfloat16)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(2304, 2561, 4)
    plen = int(lens.max())
    toks = np.zeros((4, plen), np.int64)
    for i, n in enumerate(lens):
        toks[i, plen - n:] = rng.integers(0, cfg.vocab_size, n)
    toks = torch.from_numpy(toks).cuda()

    def prefill(cache):
        logits, cache = model.prefill(params, {"tokens": toks}, cache)
        return logits.argmax(-1), cache

    with torch.inference_mode():
        cache = model.init_cache(4, 4096, torch.bfloat16)
        nxt, cache = prefill(cache)  # warm-up: cuBLAS handles, kernel load
        for _ in range(2):
            logits, cache = model.decode_step(params, cache, nxt)
            nxt = logits.argmax(-1)
        state = {}

        def run_prefill():
            state["cache"] = model.init_cache(4, 4096, torch.bfloat16)
            state["next"], state["cache"] = prefill(state["cache"])

        def run_decode():
            nxt = state["next"]
            for _ in range(8):
                logits, state["cache"] = model.decode_step(params, state["cache"], nxt)
                nxt = logits.argmax(-1)

        out = {"arch": cfg.name, "layers": cfg.n_layers, "gpu": _smi(),
               "prefill_len": plen, "batch": 4,
               "phases": [_phase("prefill", run_prefill), _phase("decode x8", run_decode)]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_{cfg.name}.json").write_text(json.dumps(out, indent=1) + "\n")
    print(out["gpu"])
    return out


if __name__ == "__main__":
    main()
