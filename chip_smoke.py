#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, through the entry points a user
calls, and fails (exit code not 0, no result line) on any miss:

  1. gpu      the card's name and power limit, as nvidia-smi gives them;
  2. build    every CUDA kernel from ``csrc/``, one nvcc each, in parallel,
              with ptxas's registers and spills, the tensor-core flash
              kernel's shared memory, and the ring depth and shared memory
              of the WKV6 kernel and the RG-LRU scan's ring path;
  3. kernels  each kernel at the serving shapes against its plain PyTorch
              twin on the same inputs, with its stated tolerance, and its
              time beside the twin's, a library call's and its bound; the
              tensor-core flash kernel also beside the CUDA-core one on the
              same bf16 inputs; the RG-LRU scan's path (TMA ring or simple)
              for each case, as the wrapper picks it, and the scan with a
              bf16 a and an fp32 b (the training backward's call) at the
              training shape, timed; the WKV6 decode step also as a CUDA
              graph of 20 steps (its device time without the wrapper's host
              time);
  4. serve    ``repro_torch.launch.serve.main`` on recurrentgemma-9b at full
              width (38 layers, bf16, random seeded weights): 4 requests with
              prompts of 2304-2560 tokens, longer than the 2048 window, 16
              new tokens; the launch counts must show 12 tensor-core flash
              and 26 RG-LRU launches for its one prefill;
  5. check    recurrentgemma-9b at full width, depth cut to one pattern
              group, in fp32: prefill and decode logits on the card
              (kernels; fp32 attention runs the CUDA-core flash kernel)
              against the same weights on the CPU (plain path, which the CPU
              tests hold against the JAX reference);
  6. gemma2   gemma2-9b at full width, depth cut to 4 layers (2 local with
              softcap, 2 global), served through ServeEngine;
  7. rwkv6    ``launch.serve.main`` on rwkv6-7b at full width (32 layers,
              bf16), prompts of the same lengths as phase 4; the WKV kernel
              must run 32 times in the prefill and 32 times in each of the
              16 decode steps (544);
  8. check    rwkv6-7b at full width, depth cut to 2 layers, in fp32, card
              against CPU as in phase 5;
  9. train    ``train_loop`` on recurrentgemma-9b at full width, depth cut
              to one (rglru, rglru, attn_local) group: bf16 compute over fp32
              masters, remat "nothing", B 2 x S 2560 from ``SyntheticLM``, 4
              steps and one more with grad_accum=2; exactly 2 tensor-core
              flash and 6 RG-LRU launches a step (twice that with
              grad_accum=2); prints the step time (CUDA events, median after
              the first), tokens/s, peak memory and model FLOPs against the
              card's dense bf16 peak;
 10. check    the loss and every parameter's gradient in fp32 on the card
              against the CPU: recurrentgemma-9b (3 layers, B 1 x S 2176,
              the CUDA-core flash kernel and the scan) and rwkv6-7b (2
              layers, B 1 x T 256, the chunked WKV twin: no wkv6 launch);
 11. train_lm ``repro_torch.launch.train_lm --steps 60`` (nemo-100m, fp32):
              finite losses, the last logged below the first.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve, train_lm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import LM, lm_loss  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_loop import TrainRunConfig, train_loop  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by input type (bf16 on the tensor cores, fp32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 0
SERVE_FLAGS = ["--batch", "4", "--prompt-len", "2560", "--min-prompt-len", "2304",
               "--max-len", "4096", "--max-new", "16", "--seed", str(SEED)]


def need(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=1):
    """Mean device milliseconds of fn() over iters back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, steps=20, replays=10):
    """Device ms per call of fn, as the replay of a CUDA graph of ``steps``
    calls (the host's launch time left out)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(steps):
            fn()
    return cuda_ms(graph.replay, iters=replays) / steps


def bound(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def visible_pairs(S, causal, window):
    rows = np.arange(S)
    hi = rows + 1 if causal else np.full(S, S)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros(S, int)
    return int(np.sum(hi - lo))


def flash_case(name, B, S, Hq, Hkv, D, window, softcap, dtype, tol, timed,
               previous=False):
    """Through ``fa_ops.attention``, which picks the kernel for dtype and
    head_dim. tol bounds |kernel - plain| by tol * (1 + |plain|): in bf16 one
    ulp of the output (the tensor-core kernel also rounds P to bf16 before
    P V, a relative error of at most 2^-9 on each weight of an average), in
    fp32 the summation order. ``previous``: the CUDA-core kernel on the same
    inputs too, checked and, if ``timed``, timed in turns with the new one."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(S + Hkv)
    q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
    kw = dict(causal=True, window=window, softcap=softcap)
    kernel = fa_ops.kernel_for(dtype, D)
    out = fa_ops.attention(q, k, v, **kw)
    want = fa_ref.attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()

    def check(out, what):
        need(torch.isfinite(out.float()).all(), f"flash {name} ({what}): non-finite output")
        diff = (out.float() - want).abs()
        err = float(diff.max())
        need(bool((diff <= tol * (1 + want.abs())).all()),
             f"flash {name} ({what}): error above {tol} * (1 + |plain|), max abs {err}")
        return err

    rec = {"case": name, "kernel": kernel, "shape": [B, S, Hq, Hkv, D],
           "dtype": str(dtype)[6:], "window": window, "softcap": softcap,
           "max_abs_err": check(out, kernel), "tol": f"{tol} * (1 + |plain|)"}
    del out
    if previous:
        rec["previous_max_abs_err"] = check(fa_ops.flash_attention_cuda(q, k, v, **kw),
                                            "simt")
    print("kernel_check flash_attention", json.dumps(rec), flush=True)
    if not timed:
        return rec
    run = lambda: fa_ops.attention(q, k, v, **kw)  # noqa: E731
    lib = None
    if softcap is None:  # one library call computes the same function
        mask = fa_ref.attention_mask(S, S, True, window, 0, dev)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
        # a yardstick only: it must compute the same function (a wrong mask
        # would be off by O(1)), in its own rounding
        rec["library_max_abs_err"] = float((lib().transpose(1, 2).float() - want).abs().max())
        need(rec["library_max_abs_err"] < 0.1, f"flash {name}: library call disagrees")
    del want
    # in turns on one card: kernel, previous kernel, library, kernel
    runs = [cuda_ms(run, iters=20)]
    if previous:
        rec["previous_ms"] = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw),
                                     iters=3)
    rec["library_ms"] = cuda_ms(lib, iters=5) if lib else None
    runs.append(cuda_ms(run, iters=20))
    rec["ms_runs"], rec["ms"] = runs, sum(runs) / len(runs)
    rec["plain_ms"] = cuda_ms(lambda: fa_ref.attention_plain(q, k, v, **kw), iters=3)
    ops = 4 * D * visible_pairs(S, True, window) * B * Hq
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(q, k, v, q), ops, dtype)
    rec["tflop_per_s"] = ops / (rec["ms"] * 1e-3) / 1e12
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    print("kernel_time flash_attention", json.dumps(rec), flush=True)
    return rec


def rglru_case(name, B, T, C, with_h0, dtype, timed, dtype_b=None):
    """``dtype_b``: b's dtype when it is not a's (the training backward's
    bf16 a with fp32 b); h and h0 are in a's dtype."""
    dev = torch.device("cuda")
    dtype_b = dtype if dtype_b is None else dtype_b
    g = torch.Generator(device=dev).manual_seed(T + C)
    a = (0.7 + 0.299 * torch.rand(B, T, C, generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn(B, T, C, generator=g, device=dev)).to(dtype_b)
    h0 = (0.1 * torch.randn(B, C, generator=g, device=dev)).to(dtype) if with_h0 else None
    h, h_final = lru_ops.linear_scan(a, b, h0)
    want, want_final = lru_ref.linear_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    # same roundings as the plain loop (separate multiply and add): exact
    err = max(float((h.float() - want.float()).abs().max()),
              float((h_final.float() - want_final.to(dtype).float()).abs().max()))
    rec = {"case": name, "shape": [B, T, C], "dtype": str(dtype)[6:],
           "dtype_b": str(dtype_b)[6:], "h0": with_h0,
           "route": lru_ops.route_for(dtype, C, dtype_b), "max_abs_err": err, "tol": 0.0}
    print("kernel_check rglru_scan", json.dumps(rec), flush=True)
    need(err == 0.0, f"rglru {name}: max abs err {err} != 0")
    if not timed:
        return rec
    rec["ms"] = cuda_ms(lambda: lru_ops.linear_scan(a, b, h0), iters=20)
    rec["plain_ms"] = cuda_ms(lambda: lru_ref.linear_scan_reference(a, b, h0), iters=2)
    rec["library_ms"] = None  # no single PyTorch call computes a linear recurrence
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(a, b, h0, h, h_final), 2 * B * T * C,
                                             torch.float32)
    print("kernel_time rglru_scan", json.dumps(rec), flush=True)
    return rec


def wkv6_case(name, B, T, H, with_s0, dtype, timed):
    """s_final has tolerance 0: the state update rounds as the plain loop does
    (separate fp32 multiply and add). y bounds |kernel - plain| by
    tol * (1 + |plain|): in fp32 (1e-5) the K-sum's order, in bf16 (2e-2) one
    ulp of the output (both sides round nearly the same fp32 value)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(T + H)
    r, k, v = (0.5 * torch.randn(B, T, H, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    # the time mix's decays: exp(-exp(x)) for x in the decay_base range
    w = torch.exp(-torch.exp(-6.0 + 5.5 * torch.rand(B, T, H, 64, generator=g,
                                                     device=dev))).to(dtype)
    u = (0.5 * torch.randn(H, 64, generator=g, device=dev)).to(dtype)
    s0 = torch.randn(B, H, 64, 64, generator=g, device=dev) if with_s0 else None
    y, s_final = wkv_ops.wkv(r, k, v, w, u, s0)
    want, want_final = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    need(torch.isfinite(y.float()).all(), f"wkv6 {name}: non-finite output")
    diff = (y.float() - want.float()).abs()
    err = float(diff.max())
    state_err = float((s_final - want_final).abs().max())
    rec = {"case": name, "shape": [B, T, H, 64, 64], "dtype": str(dtype)[6:],
           "s0": with_s0, "max_abs_err": err, "tol": f"{tol} * (1 + |plain|)",
           "state_max_abs_err": state_err, "state_tol": 0.0}
    print("kernel_check wkv6", json.dumps(rec), flush=True)
    need(bool((diff <= tol * (1 + want.float().abs())).all()),
         f"wkv6 {name}: y error above {tol} * (1 + |plain|), max abs {err}")
    need(state_err == 0.0, f"wkv6 {name}: s_final max abs err {state_err} != 0")
    if not timed:
        return rec
    rec["ms"] = cuda_ms(lambda: wkv_ops.wkv(r, k, v, w, u, s0), iters=20)
    if with_s0:  # a decode step: also its device time, the cache updated in place
        state = s0.clone()
        rec["graph_ms"] = graph_ms(lambda: wkv_ops.wkv(r, k, v, w, u, state, out=state))
    rec["plain_ms"] = cuda_ms(lambda: wkv_ref.wkv6_reference(r, k, v, w, u, s0), iters=2)
    rec["library_ms"] = None  # no single PyTorch call computes this recurrence
    # 5 fp32 operations per state element per step on the CUDA cores: r*S into
    # y (a multiply-add, 2) and w*S + k*v (3); the bonus term is v * sum_k(r u k),
    # O(K + V) per step, nothing per state element
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(r, k, v, w, u, s0, y, s_final),
                                             5 * B * T * H * 64 * 64, torch.float32)
    # an exact state update issues 4 fp32 instructions per element per step
    # (y's multiply-add; w*S, k*v and their sum); the fp32 rate counts a
    # multiply-add as 2 operations, so lanes issue at half of it. A derived
    # floor, printed here and kept out of the kernel's record.
    floor_ms = 4 * B * T * H * 64 * 64 / (PEAK_OPS_PER_S[torch.float32] / 2) * 1e3
    print("kernel_time wkv6", json.dumps({**rec, "instruction_floor_ms": floor_ms}), flush=True)
    return rec


def kernel_phase():
    flash = flash_case("recurrentgemma-9b prefill", 4, 2560, 16, 1, 256, 2048, None,
                       torch.bfloat16, 2e-2, timed=True, previous=True)
    flash_checks = [
        flash_case("gemma2-9b global, softcap", 2, 2560, 16, 8, 256, None, 50.0,
                   torch.bfloat16, 2e-2, timed=True, previous=True),
        flash_case("mistral-nemo-12b heads", 2, 2560, 32, 8, 128, None, None,
                   torch.bfloat16, 2e-2, timed=True),
        flash_case("gemma2-9b local, softcap, ragged", 1, 2500, 16, 8, 256, 2048, 50.0,
                   torch.bfloat16, 2e-2, timed=False),
    ]
    simt_checks = [
        flash_case("recurrentgemma-9b heads, fp32", 1, 2560, 16, 1, 256, 2048, None,
                   torch.float32, 1e-5, timed=False),
    ]
    need([c["kernel"] for c in [flash] + flash_checks] == ["wgmma"] * 4
         and simt_checks[0]["kernel"] == "simt", "flash cases took the wrong kernel")
    lru = rglru_case("recurrentgemma-9b prefill", 4, 2560, 4096, False, torch.bfloat16,
                     timed=True)
    lru_checks = [
        rglru_case("fp32 with h0, ragged", 3, 1001, 4000, True, torch.float32, timed=False),
        rglru_case("bf16 with h0", 2, 517, 4096, True, torch.bfloat16, timed=False),
        rglru_case("bf16, one step past a full ring", 3, 193, 4000, True, torch.bfloat16,
                   timed=False),
        rglru_case("bf16, T inside one stage", 1, 5, 4096, False, torch.bfloat16,
                   timed=False),
        rglru_case("bf16, unaligned C: simple path", 1, 37, 100, True, torch.bfloat16,
                   timed=False),
        # the training backward's call: bf16 decay, fp32 upstream gradient
        rglru_case("bf16 a, fp32 b: recurrentgemma-9b training backward", 2, 2560, 4096,
                   False, torch.bfloat16, timed=True, dtype_b=torch.float32),
        rglru_case("bf16 a, fp32 b, with h0, unaligned C: simple path", 1, 37, 100, True,
                   torch.bfloat16, timed=False, dtype_b=torch.float32),
    ]
    need(lru["route"] == "ring" and [c["route"] for c in lru_checks]
         == ["ring"] * 4 + ["simple", "ring", "simple"], "rglru cases took the wrong path")
    wkv = wkv6_case("rwkv6-7b prefill", 4, 2560, 64, False, torch.bfloat16, timed=True)
    wkv_checks = [
        wkv6_case("fp32 with s0, ragged", 3, 1001, 8, True, torch.float32, timed=False),
        wkv6_case("rwkv6-7b decode step", 4, 1, 64, True, torch.bfloat16, timed=True),
        wkv6_case("bf16, T 1, no state", 2, 1, 64, False, torch.bfloat16, timed=False),
        wkv6_case("bf16 with s0, one step past a chunk", 2, 17, 64, True, torch.bfloat16,
                  timed=False),
        wkv6_case("bf16 with s0, one step past the ring", 2, 49, 64, True,
                  torch.bfloat16, timed=False),
        wkv6_case("bf16, B*H 2 below the SM count", 1, 300, 2, False, torch.bfloat16,
                  timed=False),
    ]
    return (flash, flash_checks, simt_checks), (lru, lru_checks), (wkv, wkv_checks)


# ---------------------------------------------------------------------------
# Phases 4-6: the model path
# ---------------------------------------------------------------------------

def reset_counts():
    for kern in KERNELS:
        kern.launches = 0


def counts():
    return {kern.name: kern.launches for kern in KERNELS}


def check_outputs(outs, n_req, n_new, vocab):
    need(len(outs) == n_req, f"expected {n_req} outputs, got {len(outs)}")
    for o in outs:
        need(len(o) == n_new and all(0 <= t < vocab for t in o),
             f"bad continuation {o}")


def want_launches(cfg, decode_steps, dtype):
    """Launches of one prefill and ``decode_steps`` decode steps, by layer
    kind: flash (on the kernel ``kernel_for`` picks) and the RG-LRU scan run
    in prefill only, WKV in both."""
    kinds = [cfg.mixer_pattern[i % len(cfg.mixer_pattern)] for i in range(cfg.n_layers)]
    flash = {"wgmma": "flash_attention_wgmma", "simt": "flash_attention"}[
        fa_ops.kernel_for(dtype, cfg.head_dim)]
    want = {kern.name: 0 for kern in KERNELS}
    want[flash] = kinds.count("attn") + kinds.count("attn_local")
    want["rglru_scan"] = kinds.count("rglru")
    want["wkv6"] = kinds.count("rwkv") * (1 + decode_steps)
    return want


def launch_counts(flash=0, flash_wgmma=0, rglru=0, wkv=0):
    return {"flash_attention": flash, "flash_attention_wgmma": flash_wgmma,
            "rglru_scan": rglru, "wkv6": wkv}


def serve_phase(arch, expect):
    """launch.serve.main at full width; ``expect`` is the launch count the
    run must show, written out (not derived) for the full config."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = launch_serve.main(["--arch", arch] + SERVE_FLAGS)
    torch.cuda.synchronize()
    launches = counts()
    cfg, timing = res["cfg"], res["timing"]
    check_outputs(res["outputs"], 4, 16, cfg.vocab_size)
    need(all(2304 <= len(p) <= 2560 for p in res["prompts"]), "prompt lengths")
    dec = timing["decode_s"]
    want = want_launches(cfg, len(dec), torch.bfloat16)
    need(want == expect, f"{arch}: layer kinds give {want}, expected {expect}")
    need(launches == want, f"{arch}: launches {launches}, expected {want}")
    rec = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": res["n_params"], "dtype": res["dtype"], "batch": 4,
        "prompt_lens": [len(p) for p in res["prompts"]],
        "prefill_len": timing["prefill_len"], "prefill_ms": timing["prefill_s"] * 1e3,
        "prefill_tok_per_s": 4 * timing["prefill_len"] / timing["prefill_s"],
        "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
        "decode_ms_per_step_median": 1e3 * float(np.median(dec)),
        "decode_steps": len(dec), "new_tokens": res["tokens"],
        "tok_per_s": res["tokens"] / res["seconds"], "seconds": res["seconds"],
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return rec, cfg, timing


def recurrentgemma_serve_phase():
    rec, cfg, timing = serve_phase("recurrentgemma-9b", launch_counts(flash_wgmma=12, rglru=26))
    need(timing["prefill_len"] > cfg.window, "prefill must exceed the window")
    print("serve", json.dumps(rec), flush=True)
    return rec


def rwkv6_serve_phase():
    rec, cfg, _ = serve_phase("rwkv6-7b", launch_counts(wkv=32 + 16 * 32))
    need((cfg.n_layers, cfg.d_model, cfg.n_heads) == (32, 4096, 64), "rwkv6-7b width")
    print("rwkv6", json.dumps(rec), flush=True)
    return rec


def model_check_phase(arch, n_layers, expect, tol):
    """Full width, depth cut to ``n_layers``, fp32: prefill over 2090
    positions and 3 decode steps, logits on the card (kernels) against the
    same weights on the CPU (plain twins)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    lm = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    model = build_model(cfg)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, 2100))
    steps = [toks[:, :2090]] + [toks[:, t:t + 1] for t in range(2090, 2093)]

    def run(model, lm, dev):
        cache = model.init_cache(1, 4096, torch.float32)
        with torch.inference_mode():
            out, cache = model.prefill(lm, {"tokens": torch.from_numpy(steps[0]).to(dev)},
                                       cache)
            outs = [out.float().cpu()]
            for tok in steps[1:]:
                out, cache = model.decode_step(lm, cache, torch.from_numpy(tok).to(dev))
                outs.append(out.float().cpu())
        return torch.cat(outs, dim=1)

    reset_counts()
    on_card = run(model, lm, torch.device("cuda"))
    launches = counts()
    need(launches == expect, f"{arch} check launches {launches}, expected {expect}")
    cpu_lm = LM(cfg, torch.device("cpu"), torch.float32)
    cpu_lm.load_state_dict(lm.state_dict())
    del lm
    torch.cuda.empty_cache()
    on_cpu = run(build_model(cfg, device="cpu"), cpu_lm, torch.device("cpu"))
    err = float((on_card - on_cpu).abs().max())
    rec = {"arch": cfg.name, "layers": n_layers, "dtype": "float32", "prefill_len": 2090,
           "decode_steps": 3, "max_abs_logit": float(on_cpu.abs().max()),
           "max_abs_err": err, "tol": tol, "launches": launches,
           "argmax_equal": bool(torch.equal(on_card.argmax(-1), on_cpu.argmax(-1)))}
    print("model_check", json.dumps(rec), flush=True)
    need(torch.isfinite(on_card).all(), "non-finite logits on the card")
    need(err <= tol, f"card vs CPU logits differ by {err} > {tol}")
    need(rec["argmax_equal"], "card and CPU pick different tokens")
    return rec


def gemma2_phase():
    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=4)
    model = build_model(cfg)
    params = model.init(SEED, torch.bfloat16)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(2304, 2561)).tolist()
               for _ in range(4)]
    eng = ServeEngine(model, params, ServeConfig(max_len=4096, max_new_tokens=16,
                                                 cache_dtype=torch.bfloat16))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, rng_seed=SEED)
    dt = time.perf_counter() - t0
    launches = counts()
    check_outputs(outs, 4, 16, cfg.vocab_size)
    need(launches == launch_counts(flash_wgmma=4), f"gemma2 launches {launches}")
    dec = eng.last_timing["decode_s"]
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in params.parameters()), "dtype": "bfloat16",
           "prefill_len": eng.last_timing["prefill_len"],
           "prefill_ms": eng.last_timing["prefill_s"] * 1e3,
           "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
           "tok_per_s": sum(len(o) for o in outs) / dt, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("gemma2", json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phases 9-11: training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 2560


def timed_batches(batches, events):
    """Yield ``batches``, recording a CUDA event on the stream as each is
    taken: the events bracket each step the loop runs."""
    for batch in batches:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        yield batch


def train_phase():
    """recurrentgemma-9b at full width, depth cut to one pattern group of 3
    layers: 4 steps of ``train_loop`` (bf16 compute over fp32 masters, remat
    "nothing") and one more with grad_accum=2, B 2 x S 2560."""
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    need(cfg.n_groups_and_tail() == (1, 0), "train: one pattern group, no tail")
    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED))
    batches = [data.batch(i) for i in range(5)]  # set-up, not timed
    before = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1), total_steps=5,
                         warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    events = []
    reset_counts()
    lm, state, hist = train_loop(model, lm, timed_batches(batches[:4], events), run,
                                 log_every=1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    launches = counts()
    # per step: the flash forward, again in the group's recompute (its backward
    # recomputes plainly); the scan forward, recompute and backward, 2 layers
    need(launches == launch_counts(flash_wgmma=4 * 2, rglru=4 * 6),
         f"train launches {launches}")
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    accum_events = []
    reset_counts()
    lm, state, accum_hist = train_loop(
        model, lm, timed_batches(batches[4:], accum_events),
        dataclasses.replace(run, grad_accum=2), log_every=1, opt_state=state, start_step=4)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    accum_launches = counts()
    need(accum_launches == launch_counts(flash_wgmma=2 * 2, rglru=2 * 6),
         f"train grad_accum=2 launches {accum_launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist + accum_hist]
    need(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    need(state.step == 5, f"train: optimizer step {state.step}, expected 5")
    unmoved = [n for n, p in lm.named_parameters() if torch.equal(p.detach().cpu(), before[n])]
    need(not unmoved, f"train: parameters that did not move: {unmoved}")
    median_ms = float(np.median(step_ms[1:]))
    # model FLOPs of a step: 6 N per token for the matrix products (the tied
    # embedding counted once, as the head's product), and the attention
    # layer's QK^T and PV, 4 D Hq per visible (query, key) pair forward and
    # twice that backward; remat's recompute is not model work
    pairs = visible_pairs(TRAIN_S, True, cfg.window)
    n_attn = 1
    dense = 6 * n_params * TRAIN_B * TRAIN_S
    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * pairs * TRAIN_B * n_attn
    flops = dense + attn
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "compute_dtype": "bfloat16", "master_dtype": "float32",
           "remat_policy": run.remat_policy, "batch": TRAIN_B, "seq": TRAIN_S,
           "losses": losses, "opt_step": state.step, "step_ms": step_ms,
           "step_ms_median_after_first": median_ms,
           "grad_accum2_step_ms": accum_events[0].elapsed_time(end),
           "tok_per_s": TRAIN_B * TRAIN_S / (median_ms * 1e-3),
           "peak_mem_gib": peak, "launches_per_4_steps": launches,
           "launches_grad_accum2_step": accum_launches,
           "model_flops_per_step": flops,
           "model_flops_count": f"6 * {n_params} params * {TRAIN_B * TRAIN_S} tokens + "
                                f"12 * D {cfg.head_dim} * Hq {cfg.n_heads} * {pairs} pairs "
                                f"* B {TRAIN_B} * {n_attn} attention layer",
           "model_flops_share_of_bf16_peak":
               flops / (median_ms * 1e-3) / PEAK_OPS_PER_S[torch.bfloat16]}
    print("train", json.dumps(rec), flush=True)
    return rec


def train_check_phase(arch, n_layers, B, S, expect, loss_tol, grad_tol):
    """Full width, depth cut to ``n_layers``, fp32 (TF32 off): the loss and
    every parameter's gradient on the card (kernels) against the same
    weights and batch on the CPU (plain twins). No remat: the CPU tests hold
    every remat policy to the gradients of none."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    lm = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=SEED)).batch(0)

    def loss_and_grads(lm, dev):
        lm.requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _ = lm_loss(lm, tb, remat_policy=None)
        names, params = zip(*lm.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}

    # WKV's training route: the chunked twin, called once a layer (counted by
    # wrapping it for the card's run)
    chunked, calls = wkv_ref.wkv6_chunked, []
    wkv_ref.wkv6_chunked = lambda *a, **kw: calls.append(1) or chunked(*a, **kw)
    reset_counts()
    try:
        loss, grads = loss_and_grads(lm, torch.device("cuda"))
        torch.cuda.synchronize()
    finally:
        wkv_ref.wkv6_chunked = chunked
    launches = counts()
    need(launches == expect, f"{arch} train check launches {launches}, expected {expect}")
    n_rwkv = sum(layer.mixer == "rwkv" for layer in lm.layers)
    need(len(calls) == n_rwkv, f"{arch}: {len(calls)} chunked WKV calls, expected {n_rwkv}")
    cpu_lm = LM(cfg, torch.device("cpu"), torch.float32)
    cpu_lm.load_state_dict(lm.state_dict())
    del lm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(cpu_lm, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    rel = {n: float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for n, g in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    rec = {"arch": cfg.name, "layers": n_layers, "dtype": "float32", "batch": B, "seq": S,
           "loss": loss, "cpu_loss": cpu_loss, "loss_abs_err": abs(loss - cpu_loss),
           "loss_tol": loss_tol, "worst_leaf": worst, "worst_leaf_rel_err": rel[worst],
           "grad_tol": f"{grad_tol} * max|g| per leaf", "leaves": len(rel),
           "launches": launches, "wkv6_chunked_calls": len(calls), "cpu_s": cpu_s}
    print("train_check", json.dumps(rec), flush=True)
    need(np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
         f"{arch} train check: non-finite loss or gradient")
    need(abs(loss - cpu_loss) <= loss_tol, f"{arch}: card vs CPU loss {loss} vs {cpu_loss}")
    need(rel[worst] <= grad_tol, f"{arch}: gradient of {worst} off by {rel[worst]}")
    return rec


def train_lm_phase():
    """``python -m repro_torch.launch.train_lm --steps 60``: nemo-100m in
    fp32 (head_dim 64: the CUDA-core flash kernel), 8 layers each its own
    remat group, so 2 flash launches a layer a step."""
    ckpt = ROOT / "build" / "train_lm_ckpt"
    reset_counts()
    res = train_lm.main(["--steps", "60", "--ckpt-dir", str(ckpt)])
    torch.cuda.synchronize()
    launches = counts()
    need(launches == launch_counts(flash=60 * 8 * 2), f"train_lm launches {launches}")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    need(res["cfg"].name == "nemo-100m" and res["opt_step"] == 60, "train_lm: config or steps")
    need(len(losses) == 6 and all(np.isfinite(losses)), f"train_lm losses {losses}")
    need(losses[-1] < losses[0], f"train_lm: loss did not fall: {losses}")
    rec = {"arch": res["cfg"].name, "params": res["n_params"], "steps": res["steps"],
           "history": hist, "s_per_step": [h["s_per_step"] for h in hist],
           "seconds": res["seconds"], "checkpoints": res["checkpoints"],
           "launches": launches}
    print("train_lm", json.dumps(rec), flush=True)
    return rec


def kernel_record(name, route, source, replaces, launches, main, checks, **extra):
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"], **extra,
            "checks": [main] + checks}


def function_name(mangled):
    """The function's own name in a mangled _ZN<len><namespace><len><name>..."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return ""
    rest = mangled[m.end() + int(m.group(1)):]
    n = re.match(r"(\d+)", rest)
    return rest[n.end():n.end() + int(n.group(1))] if n else ""


def print_ptxas(kern):
    """Registers, spills and ptxas warnings of each entry function built."""
    entry = ""
    for line in kern.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the function's name and template arguments: type, head_dim
            name = m.group(1)
            fn = function_name(name)
            d = re.search(r"Li(\d+)E", name)
            dtype = "bf16" if "bfloat16" in name else "fp32" if re.search(r"If(Li|E)", name) else ""
            entry = " ".join(filter(None, [fn, dtype, d and f"head_dim {d.group(1)}"]))
        elif "registers" in line or "spill" in line or "C75" in line:
            print(f"ptxas {kern.name} [{entry}]: {line.strip()}", flush=True)


def print_rings():
    """The ring depth and shared memory per block of the WKV6 kernel and of
    the RG-LRU scan's ring path, from their libraries."""
    lib = ctypes.CDLL(str(wkv_ops.KERNEL.library))
    d = (ctypes.c_int * 6)()
    lib.wkv6_design(d)
    print(f"wkv6: {d[4]} chunks of {d[3]} steps in the ring; {d[0]} columns a block, "
          f"{d[1]} threads sharing each group of {d[2]} columns, {d[5]} threads a block; "
          f"dynamic shared memory per block "
          f"bf16 {lib.wkv6_smem_bytes(1)} bytes, fp32 {lib.wkv6_smem_bytes(0)} bytes",
          flush=True)
    lib = ctypes.CDLL(str(lru_ops.KERNEL.library))
    d = (ctypes.c_int * 3)()
    lib.rglru_scan_design(d)
    print(f"rglru_scan ring path: {d[2]} stages of {d[1]} steps x {d[0]} channels; "
          f"dynamic shared memory per block bf16 {lib.rglru_scan_smem_bytes(1, 1)} bytes, "
          f"fp32 {lib.rglru_scan_smem_bytes(0, 0)} bytes, "
          f"bf16 a with fp32 b {lib.rglru_scan_smem_bytes(1, 0)} bytes", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    secs = cuda_build.build(KERNELS)
    print(f"build: {secs:.1f} s for {len(KERNELS)} kernels", flush=True)
    for kern in KERNELS:
        print_ptxas(kern)
    smem = ctypes.CDLL(str(fa_ops.WGMMA_KERNEL.library)).flash_attention_sm90_smem_bytes
    print("flash_attention_wgmma dynamic shared memory per block: " + ", ".join(
        f"head_dim {d} {smem(d)} bytes" for d in fa_ops.WGMMA_HEAD_DIMS), flush=True)
    print_rings()

    (flash, flash_checks, simt_checks), (lru, lru_checks), (wkv, wkv_checks) = kernel_phase()
    lru_mixed = next(c for c in lru_checks if c["dtype_b"] != c["dtype"] and "ms" in c)
    serve = recurrentgemma_serve_phase()
    # fp32 over the cut depth and a 256000-way head (rwkv6: 65536); logits O(1)
    check = model_check_phase("recurrentgemma-9b", 3, launch_counts(flash=1, rglru=2), 2e-3)
    gemma2 = gemma2_phase()
    rwkv6 = rwkv6_serve_phase()
    rwkv6_check = model_check_phase("rwkv6-7b", 2, launch_counts(wkv=8), 2e-3)
    train = train_phase()
    # fp32 over a 256000-way (rwkv6: 65536) softmax and 2176 (256) positions;
    # the loss is near ln(V), the tolerance 1e-4 absolute; each gradient within
    # 2e-3 of its leaf's largest, the summation orders of card and CPU apart
    train_check = train_check_phase("recurrentgemma-9b", 3, 1, 2176,
                                    launch_counts(flash=1, rglru=2 * 2), 1e-4, 2e-3)
    rwkv6_train_check = train_check_phase("rwkv6-7b", 2, 1, 256, launch_counts(), 1e-4, 2e-3)
    train_lm_rec = train_lm_phase()

    # the CUDA-core kernel serves fp32 (and the small head dims); its record
    # holds its bf16 time at the serving shape, measured beside the new one
    simt_main = {"case": flash["case"] + " (bf16, CUDA-core kernel)",
                 "max_abs_err": flash["previous_max_abs_err"], "ms": flash["previous_ms"],
                 "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
                 "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]}
    kernels = [
        kernel_record("flash_attention_wgmma", "cuda",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:103",
                      serve["launches"]["flash_attention_wgmma"], flash, flash_checks,
                      previous_ms=flash["previous_ms"],
                      launches_train_4_steps=train["launches_per_4_steps"][
                          "flash_attention_wgmma"]),
        kernel_record("flash_attention", "cuda",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:103",
                      check["launches"]["flash_attention"], simt_main, simt_checks,
                      launches_in="check: recurrentgemma-9b fp32, 3 layers",
                      launches_train_check=train_check["launches"]["flash_attention"],
                      launches_train_lm_60_steps=train_lm_rec["launches"]["flash_attention"]),
        kernel_record("rglru_scan", "cuda",
                      "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
                      "src/repro/kernels/rglru/rglru.py:69",
                      serve["launches"]["rglru_scan"], lru, lru_checks, path=lru["route"],
                      launches_train_4_steps=train["launches_per_4_steps"]["rglru_scan"],
                      bf16_a_fp32_b_ms=lru_mixed["ms"], bf16_a_fp32_b_bound_ms=lru_mixed["bound_ms"],
                      bf16_a_fp32_b_plain_ms=lru_mixed["plain_ms"]),
        kernel_record("wkv6", "cuda", "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
                      "src/repro/kernels/rwkv6/rwkv6.py:67",
                      rwkv6["launches"]["wkv6"], wkv, wkv_checks,
                      decode_step_graph_ms=wkv_checks[1]["graph_ms"]),
    ]
    need(all(kern["launches"] > 0 for kern in kernels), "a kernel did not run on its path")
    summary = {"gpu": smi, "build_s": secs, "serve": serve, "model_check": check,
               "gemma2": gemma2, "rwkv6": rwkv6, "rwkv6_check": rwkv6_check,
               "train": train, "train_check": train_check,
               "rwkv6_train_check": rwkv6_train_check, "train_lm": train_lm_rec}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps({"kernels": kernels, **summary}, indent=1) + "\n")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
