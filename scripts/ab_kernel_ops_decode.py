"""Serve decode step time with another checkout's kernel wrappers against this one's.

    python3 scripts/ab_kernel_ops_decode.py OTHER_CHECKOUT [--rounds 3]

Each kernel launch of the port goes through a registered operator
(``torch.ops.repro_torch.*``, so that a meta or fake tensor takes the
card's route in a trace); an older commit called the ctypes launcher
directly. The operator's dispatch is host time, which a host-bound decode
step pays on each launch (rwkv6-7b: 32 WKV6 launches a step).

Runs ``repro_torch.launch.serve`` at full width (chip_smoke.py's serve
flags: batch 4, prompts of 2304-2560 tokens, 16 new tokens) on rwkv6-7b and
recurrentgemma-9b, each in its own process, in turns: ``OTHER_CHECKOUT``
(unpack the other commit with ``git archive`` into a gitignored directory
such as ``build/``), this checkout, this checkout, the other, ``--rounds``
times. Prints each run's decode ms a step (median and mean over the 16
steps) and prefill ms. A decode step is host-bound and its time spreads
by tens of percent between processes on a shared host, so the script also
times the launch itself in one process: the WKV6 decode call at rwkv6-7b's
shape (B 4, T 1, 64 heads, state updated in place) through the operator
(``wkv_ops.wkv``) and through the ctypes launcher alone
(``wkv_ops.wkv6_cuda``, the older route), 2000 calls each in turns, wall µs
a call after a synchronize (the kernel takes about 4 µs of device time,
so the host sets the pace). Writes ``chiprun_out/ab_kernel_ops_decode.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
SERVE_FLAGS = ["--batch", "4", "--prompt-len", "2560", "--min-prompt-len", "2304",
               "--max-len", "4096", "--max-new", "16", "--seed", "0"]

_RUN = """
import json, statistics, sys
from repro_torch.launch import serve
for arch in sys.argv[1].split(","):
    res = serve.main(["--arch", arch] + json.loads(sys.argv[2]))
    dec = [s * 1e3 for s in res["timing"]["decode_s"]]
    print("RESULT " + json.dumps({"arch": arch, "decode_ms_median": statistics.median(dec),
                                  "decode_ms_mean": statistics.fmean(dec), "decode_ms": dec,
                                  "prefill_ms": res["timing"]["prefill_s"] * 1e3}), flush=True)
"""


def run(checkout: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(checkout / "src")}
    out = subprocess.run([sys.executable, "-c", _RUN, ",".join(ARCHS), json.dumps(SERVE_FLAGS)],
                         env=env, capture_output=True, text=True, timeout=900, cwd=checkout)
    if out.returncode != 0:
        sys.exit(f"{checkout}: exit {out.returncode}\n{out.stdout[-2000:]}{out.stderr[-3000:]}")
    return [json.loads(line[7:]) for line in out.stdout.splitlines()
            if line.startswith("RESULT ")]


def launch_us(calls: int = 2000, turns: int = 4) -> dict:
    """Wall µs a WKV6 decode call, through the operator and through the
    ctypes launcher alone, in turns (operator, launcher, launcher, operator...)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.rwkv6 import ops as wkv_ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r, k, v, w = (torch.rand(4, 1, 64, 64, generator=g, device=dev).bfloat16() for _ in range(4))
    u = torch.rand(64, 64, generator=g, device=dev).bfloat16()
    state = torch.zeros(4, 64, 64, 64, device=dev)
    routes = {"operator": lambda: wkv_ops.wkv(r, k, v, w, u, state, out=state),
              "launcher": lambda: wkv_ops.wkv6_cuda(r, k, v, w, u, state, out=state)}
    times = {name: [] for name in routes}
    for i in range(turns):
        for name in (("operator", "launcher") if i % 2 == 0 else ("launcher", "operator")):
            fn = routes[name]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {name: {"us_per_call": statistics.median(ts), "runs": ts}
            for name, ts in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    launches = launch_us()
    print(f"wkv6 decode call, wall us: {json.dumps(launches)}", flush=True)
    runs = []
    order = (("other", args.other.resolve()), ("this", ROOT), ("this", ROOT),
             ("other", args.other.resolve()))
    for _ in range(args.rounds):
        for side, checkout in order:
            for rec in run(checkout):
                rec["side"] = side
                runs.append(rec)
                print(f"{side} {rec['arch']}: decode {rec['decode_ms_median']} ms a step "
                      f"(median; mean {rec['decode_ms_mean']}), prefill {rec['prefill_ms']} ms",
                      flush=True)
    summary = {}
    for arch in ARCHS:
        for side in ("other", "this"):
            med = [x["decode_ms_median"] for x in runs if (x["arch"], x["side"]) == (arch, side)]
            summary[f"{arch} {side}"] = statistics.median(med)
    print("decode ms a step, median over runs:", json.dumps(summary), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_kernel_ops_decode.json").write_text(json.dumps(
        {"gpu": smi, "wkv6_launch_us": launches, "decode_ms_median": summary, "runs": runs},
        indent=1) + "\n")


if __name__ == "__main__":
    main()
