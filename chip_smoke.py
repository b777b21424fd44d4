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
              for each case, as the wrapper picks it; the WKV6 decode step
              also as a CUDA graph of 20 steps (its device time without the
              wrapper's host time);
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
              against CPU as in phase 5.

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
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402
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


def rglru_case(name, B, T, C, with_h0, dtype, timed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(T + C)
    a = (0.7 + 0.299 * torch.rand(B, T, C, generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn(B, T, C, generator=g, device=dev)).to(dtype)
    h0 = (0.1 * torch.randn(B, C, generator=g, device=dev)).to(dtype) if with_h0 else None
    h, h_final = lru_ops.linear_scan(a, b, h0)
    want, want_final = lru_ref.linear_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    # same roundings as the plain loop (separate multiply and add): exact
    err = max(float((h.float() - want.float()).abs().max()),
              float((h_final.float() - want_final.to(dtype).float()).abs().max()))
    rec = {"case": name, "shape": [B, T, C], "dtype": str(dtype)[6:], "h0": with_h0,
           "route": lru_ops.route_for(dtype, C), "max_abs_err": err, "tol": 0.0}
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
    ]
    need(lru["route"] == "ring" and [c["route"] for c in lru_checks]
         == ["ring"] * 4 + ["simple"], "rglru cases took the wrong path")
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
          f"dynamic shared memory per block bf16 {lib.rglru_scan_smem_bytes(1)} bytes, "
          f"fp32 {lib.rglru_scan_smem_bytes(0)} bytes", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    serve = recurrentgemma_serve_phase()
    # fp32 over the cut depth and a 256000-way head (rwkv6: 65536); logits O(1)
    check = model_check_phase("recurrentgemma-9b", 3, launch_counts(flash=1, rglru=2), 2e-3)
    gemma2 = gemma2_phase()
    rwkv6 = rwkv6_serve_phase()
    rwkv6_check = model_check_phase("rwkv6-7b", 2, launch_counts(wkv=8), 2e-3)

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
                      previous_ms=flash["previous_ms"]),
        kernel_record("flash_attention", "cuda",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:103",
                      check["launches"]["flash_attention"], simt_main, simt_checks,
                      launches_in="check: recurrentgemma-9b fp32, 3 layers"),
        kernel_record("rglru_scan", "cuda",
                      "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
                      "src/repro/kernels/rglru/rglru.py:69",
                      serve["launches"]["rglru_scan"], lru, lru_checks, path=lru["route"]),
        kernel_record("wkv6", "cuda", "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
                      "src/repro/kernels/rwkv6/rwkv6.py:67",
                      rwkv6["launches"]["wkv6"], wkv, wkv_checks,
                      decode_step_graph_ms=wkv_checks[1]["graph_ms"]),
    ]
    need(all(kern["launches"] > 0 for kern in kernels), "a kernel did not run on its path")
    summary = {"gpu": smi, "build_s": secs, "serve": serve, "model_check": check,
               "gemma2": gemma2, "rwkv6": rwkv6, "rwkv6_check": rwkv6_check}
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
