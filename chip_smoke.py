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
 12. dispatch the BandPilot dispatcher (``repro_torch.core``) on the paper's
              32-GPU H100 and Het-4Mix clusters: the surrogate trained on the
              card (the quickstart's 250 samples, 2000 steps; its first 50
              steps' losses against the CPU's from the same init and
              batches), scored on the card against the CPU on 4096 random
              subsets a cluster (isolated and contended applies), the
              Fig. 1 scenario and the quickstart's dispatcher comparison,
              the fused descent (each a CUDA graph replay: capture seconds a
              bucket, per-descent time, every round audited against the
              host loop), and traces through ``AdmissionScheduler`` (the
              pinned 14-job fifo golden and a 200-job Poisson trace,
              analytic mode on both clusters, learned mode on H100) whose
              subsets must equal the CPU's; no port kernel runs on it;
 13. elastic  BandPilot-placed training (``launch/elastic.py``,
              ``parallel/fsdp.py``) on recurrentgemma-9b at full width, depth
              cut to one (rglru, rglru, attn_local) group, bf16 over fp32
              masters, B 1 x S 2048, 6 steps: (a) ``train_loop`` uninterrupted;
              (b) the sharded step on a 1-rank NCCL mesh over the card, 16 of
              the simulated 32-GPU H100 cluster dispatched, a checkpoint (about
              19.7 GB: parameters and both moments in fp32, free space checked
              first) and host 1's failure at step 3, re-dispatch, a new mesh,
              restore, resume; (c) the same coordinator on the CPU. (b)'s
              losses within 1e-5 of (a)'s (bit-equality printed), its event log
              (allocations, predicted GB/s) equal to (c)'s, no GPU of the dead
              host re-used, 2 tensor-core flash and 6 RG-LRU launches a step;
              step ms under CUDA events, checkpoint bytes, save and restore s,
              and the time to recover split into re-dispatch, mesh build,
              restore and the first resumed step. Then
              ``repro_torch.launch.train`` on the same config for 2 steps.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

import copy
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import surrogate as surr  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref  # noqa: E402
from repro_torch.ft.elastic import ElasticCoordinator, FailureEvent  # noqa: E402
from repro_torch.ft.elastic import run_elastic_training  # noqa: E402
from repro_torch.launch import elastic as launch_elastic  # noqa: E402
from repro_torch.launch import serve as launch_serve, train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402
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


# -- phase 12: the dispatcher ---------------------------------------------------

# training steps: the quickstart's 2000 on H100; Het-4Mix is cut to 500 to
# keep the phase near two minutes (``dispatch_train`` prints the R² reached)
DISPATCH_CLUSTERS = {"H100": 2000, "Het-4Mix": 500}
CURVE_STEPS = 50
# card against CPU, both fp32 with TF32 off, sums in other orders: a loss
# curve 2e-3 relative a step (Adam magnifies early rounding, as in the CPU
# tests against the reference); a decoded score 1e-4 relative (expm1(5 y)
# of a normalized output within 2e-5); a descent round's scores 1e-5
# relative to the same predictor's host loop on the card
CURVE_RTOL = 2e-3
SCORE_RTOL = 1e-4
SCAN_RTOL = 1e-5


def on_cpu(params):
    return copy.deepcopy(params).to("cpu")  # Module.to moves in place


def multi_host_subsets(cl, rng, n, exclude=()):
    pool = [g for g in range(cl.n_gpus) if g not in set(exclude)]
    out = []
    while len(out) < n:
        s = sorted(rng.choice(pool, size=int(rng.integers(2, 25)), replace=False).tolist())
        if len(cl.partition_by_host(s)) > 1:
            out.append(s)
    return out


def max_rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def dispatch_train(name, steps):
    """The quickstart's training on the card; the first CURVE_STEPS steps'
    losses again on the CPU from the same init and batches."""
    cl = core.PAPER_CLUSTERS[name]()
    sim = core.BandwidthSimulator(cl)
    tables = core.IntraHostTables(cl, sim)
    train, test = core.make_train_test_split(sim, 250, seed=0)
    init = surr.init_hierarchical_params(torch.Generator().manual_seed(0), device="cpu")
    params, info = core.train_surrogate(cl, tables, train, core.TrainConfig(steps=steps),
                                        init_params=init)
    need(params.device.type == "cuda", "the surrogate did not train on the card")
    acc = core.evaluate_surrogate(core.SurrogatePredictor(cl, tables, params), test)
    short = core.TrainConfig(steps=CURVE_STEPS)
    _, card = core.train_surrogate(cl, tables, train, short, init_params=init)
    _, cpu = core.train_surrogate(cl, tables, train, short, init_params=init, device="cpu")
    curve_err = max_rel(card["loss_curve"], cpu["loss_curve"])
    need(curve_err <= CURVE_RTOL, f"{name}: card and CPU loss curves differ by {curve_err}")
    rec = {"cluster": name, "steps": steps, "train_s": info["train_seconds"],
           "ms_per_step": info["train_seconds"] / steps * 1e3,
           "final_loss": info["final_loss"], "r2": acc["r2"], "mape": acc["mape"],
           "curve_steps": CURVE_STEPS, "curve_max_rel_err": curve_err,
           "curve_tol": CURVE_RTOL, "param_bytes": info["param_bytes"]}
    print("dispatch_train", json.dumps(rec), flush=True)
    need(np.isfinite(info["final_loss"]) and acc["r2"] > 0.5, f"{name}: surrogate did not learn")
    return (cl, sim, tables), params, rec


def tenanted_ledger(cl):
    led = core.JobLedger(cl)
    led.admit("a", [0, 1, cl.hosts[1].gpu_ids[0]])
    led.admit("b", [cl.hosts[1].gpu_ids[1], cl.hosts[-1].gpu_ids[0]])
    led.admit("c", list(cl.hosts[2].gpu_ids[:2]) + [cl.hosts[3].gpu_ids[1]])
    return led


def timed_apply(fn, params, x, m):
    """(decoded scores, device ms of the apply under CUDA events, or None on
    the CPU)."""
    if params.device.type != "cuda":
        return surr._apply_np(fn, params, x, m), None
    xt, mt = torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda()
    ms = cuda_ms(lambda: fn(params, xt, mt), iters=20)
    return fn(params, xt, mt).cpu().numpy(), ms


def score_check(stack, params):
    """4096 random multi-host subsets, card against CPU, isolated and (with
    a random context embedding, against a tenanted ledger) contended."""
    cl, _, tables = stack
    rng = np.random.default_rng(1)
    subsets = multi_host_subsets(cl, rng, 4096)
    x, m = core.features.featurize_batch(cl, tables, subsets)
    card, card_ms = timed_apply(surr._apply_hierarchical_bw, params, x, m)
    cpu, _ = timed_apply(surr._apply_hierarchical_bw, on_cpu(params), x, m)
    cparams = surr.init_contended_params(params)
    with torch.no_grad():
        cparams.ctx_embed.w.copy_(torch.randn(cparams.ctx_embed.w.shape,
                                              generator=torch.Generator().manual_seed(5)) * 0.3)
    led = tenanted_ledger(cl)
    free = multi_host_subsets(cl, rng, 4096, exclude=led.busy())
    cx, cm = core.features.featurize_contended_batch(cl, tables, [(s, led) for s in free])
    ccard, ccard_ms = timed_apply(surr._apply_contended_bw, cparams, cx, cm)
    ccpu, _ = timed_apply(surr._apply_contended_bw, on_cpu(cparams), cx, cm)
    rec = {"cluster": cl.name, "n": len(subsets), "tokens": int(x.shape[1]),
           "hierarchical_max_rel_err": max_rel(card, cpu), "hierarchical_ms": card_ms,
           "contended_max_rel_err": max_rel(ccard, ccpu), "contended_ms": ccard_ms,
           "tol": SCORE_RTOL}
    print("dispatch_scores", json.dumps(rec), flush=True)
    need(rec["hierarchical_max_rel_err"] <= SCORE_RTOL
         and rec["contended_max_rel_err"] <= SCORE_RTOL, f"{cl.name}: card scores disagree")
    return rec


def fig1_phase(stack, params):
    cl, sim, tables = stack
    pred = core.SurrogatePredictor(cl, tables, params)
    avail = list(range(0, 6)) + list(range(8, 14))
    bp = core.BandPilotDispatcher(cl, tables, pred)
    topo = core.BaselineDispatcher(cl, "topo")
    s_bp, s_topo = bp.dispatch(avail, 8), topo.dispatch(avail, 8)
    split = sorted(len(v) for v in cl.partition_by_host(s_bp).values())
    bw_bp, bw_topo = sim.true_bandwidth(s_bp), sim.true_bandwidth(s_topo)
    need(split == [4, 4], f"Fig. 1: BandPilot chose {s_bp}, not a 4+4 split")
    need(bw_bp > bw_topo, f"Fig. 1: BandPilot {bw_bp} GB/s does not beat Topo {bw_topo}")
    ds = [bp, topo, core.BaselineDispatcher(cl, "default"), core.BaselineDispatcher(cl, "random")]
    t0 = time.perf_counter()
    recs = core.evaluate_dispatchers(cl, sim, tables, ds, request_sizes=[4, 8, 12, 16, 20],
                                     n_scenarios=10, seed=1)
    gbe = {name: s["mean_gbe"] for name, s in core.summarize(recs).items()}
    rec = {"cluster": cl.name, "bandpilot": s_bp, "bandpilot_gbps": bw_bp, "topo": s_topo,
           "topo_gbps": bw_topo, "mean_gbe": gbe, "protocol_s": time.perf_counter() - t0,
           "descents": pred.n_descents, "graph_replays": pred.n_graph_replays}
    print("dispatch_fig1", json.dumps(rec), flush=True)
    need(gbe["BandPilot"] > max(gbe["Topo"], gbe["Default"], gbe["Random"]),
         "BandPilot does not lead the dispatcher comparison")
    return rec


def audit_descent(pred, res, parent, k):
    """Every round of a descent against the predictor's own host loop: the
    scores within SCAN_RTOL, the same elimination."""
    s = sorted(parent)
    worst = 0.0
    for r in range(res.n_rounds):
        live = np.nonzero(res.sels[r])[0]
        need([sorted(parent)[i] for i in live] == s, "descent audit: live slots differ")
        host = np.float32(pred.predict([s[:i] + s[i + 1:] for i in range(len(s))]))
        worst = max(worst, max_rel(res.scores[r][live], host))
        j = int(np.argmax(host))
        need(res.elims[r] == live[j], f"descent audit: round {r} eliminated another slot")
        s.pop(j)
    need(res.subset == s and len(s) == k and worst <= SCAN_RTOL,
         f"descent audit failed (worst round score error {worst})")
    return worst


def host_descent(pred, parent, k):
    """pts_search's host loop (the use_scan=False path)."""
    s = sorted(parent)
    while len(s) > k:
        j = int(np.argmax(pred.predict_children(s)))
        s = s[:j] + s[j + 1:]
    return s


def descent_phase(stack, params, reps=20):
    cl, _, tables = stack
    pred = core.SurrogatePredictor(cl, tables, params)
    warm_s = pred.warm_scan()  # 0 where a same-shaped cluster captured the buckets
    off = core.SurrogatePredictor(cl, tables, params, use_scan=False)
    cpu = core.SurrogatePredictor(cl, tables, on_cpu(params))
    parent = list(range(cl.n_gpus))
    rows = []
    for k in (4, 8, 16):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        wall, dev = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            res = pred.eliminate_to(parent, k)
            ev1.record()
            wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            dev.append(ev0.elapsed_time(ev1))
        worst = audit_descent(pred, res, parent, k)
        need(host_descent(off, parent, k) == res.subset, "descent: use_scan=False chose otherwise")
        need(cpu.eliminate_to(parent, k).subset == res.subset, "descent: the CPU chose otherwise")
        rows.append({"k": k, "rounds": res.n_rounds, "ms_median": float(np.median(wall)),
                     "events_ms_median": float(np.median(dev)), "ms_first": wall[0],
                     "audit_worst_rel_err": worst, "subset": res.subset})
    need(pred.n_graph_replays == pred.n_descents, "a descent on the card was not a graph replay")
    rec = {"cluster": cl.name, "warm_scan_s": warm_s, "graphs": surr.scan_graphs(),
           "descents": pred.n_descents, "graph_replays": pred.n_graph_replays, "parent": 32,
           "per_k": rows}
    print("dispatch_descent", json.dumps(rec), flush=True)
    return rec


def trace_run(stack, params, trace, cparams=None):
    """One AdmissionScheduler replay (fifo): the dispatch log, wall seconds,
    the predictor chain's stats and the base predictor's descent counts."""
    cl, sim, tables = stack
    pred = core.SurrogatePredictor(cl, tables, params)
    kw = {}
    if cparams is not None:
        kw = {"contention_mode": "learned",
              "contended_predictor": core.ContendedSurrogatePredictor(cl, tables, cparams)}
    disp = core.BandPilotDispatcher(cl, tables, pred, **kw)
    log = []
    orig = disp.dispatch

    def logged(avail, k, rng=None):
        s = orig(avail, k, rng=rng)
        log.append((list(s), disp.last_result.predicted_bw))
        return s

    disp.dispatch = logged
    t0 = time.perf_counter()
    recs = core.AdmissionScheduler(cl, sim, tables, disp).run(trace)
    return log, recs, time.perf_counter() - t0, disp.predictor_stats(), pred


def first_divergence(log, cpu_log):
    """The index of the first dispatch whose subset differs between the card
    and the CPU, or None. Where one differs, the two choices' predicted
    bandwidths must be a near-tie (within SCORE_RTOL): the card's float32
    sums and the CPU's ordered two equally good candidates differently, and
    from there on the two ledgers, and so the runs, part ways."""
    for i, ((s, bw), (cs, cbw)) in enumerate(zip(log, cpu_log)):
        if s != cs:
            need(abs(bw - cbw) <= SCORE_RTOL * abs(cbw),
                 f"dispatch {i}: card {s} ({bw} GB/s) against CPU {cs} ({cbw} GB/s)")
            return i
    need(len(log) == len(cpu_log), "the card and the CPU dispatched different counts")
    return None


def trace_phase(stack, params, name, trace, cparams=None):
    log, recs, secs, stats, pred = trace_run(stack, params, trace, cparams)
    cpu_log, cpu_recs, cpu_secs, _, _ = trace_run(
        stack, on_cpu(params), trace, None if cparams is None else on_cpu(cparams))
    split = first_divergence(log, cpu_log)
    same = len(log) if split is None else split
    need([(r.job_id, r.t_admit, r.bw) for r in recs[:same]]
         == [(r.job_id, r.t_admit, r.bw) for r in cpu_recs[:same]],
         f"{name}: the card's admissions differ from the CPU's")
    n = len(log)
    us = lambda s: s / max(n, 1) * 1e6  # noqa: E731
    other = secs - stats.featurize_seconds - stats.infer_seconds - stats.scan_seconds
    rec = {"trace": name, "cluster": stack[0].name, "jobs": len(trace), "admissions": n,
           "mode": "analytic" if cparams is None else "learned",
           "identical_dispatches": same,
           "near_tie": None if split is None else {
               "dispatch": split, "card": log[split], "cpu": cpu_log[split]},
           "us_per_admission": us(secs), "cpu_us_per_admission": us(cpu_secs),
           "featurize_us": us(stats.featurize_seconds), "infer_us": us(stats.infer_seconds),
           "scan_us": us(stats.scan_seconds), "other_us": us(other),
           "model_calls": stats.n_model_calls, "descents": pred.n_descents,
           "graph_replays": pred.n_graph_replays, "scan_rounds": stats.n_scan_steps,
           "mean_gbe": float(np.mean([r.gbe for r in recs]))}
    print("dispatch_trace", json.dumps(rec), flush=True)
    need(pred.n_graph_replays == pred.n_descents, f"{name}: a descent was not a graph replay")
    need(cparams is not None or pred.n_descents > 0, f"{name}: no descent ran")
    return rec


def dispatch_phase():
    reset_counts()
    t0 = time.perf_counter()
    trained = {name: dispatch_train(name, steps) for name, steps in DISPATCH_CLUSTERS.items()}
    rec = {"train": [t[2] for t in trained.values()]}
    rec["scores"] = [score_check(stack, params) for stack, params, _ in trained.values()]
    rec["descent"] = [descent_phase(stack, params) for stack, params, _ in trained.values()]
    rec["fig1"] = fig1_phase(*trained["H100"][:2])
    rec["traces"] = []
    for name, (stack, params, _) in trained.items():
        cl = stack[0]
        k_choices = range(4, cl.n_gpus // 2 + 1)
        golden = core.poisson_trace(cl, 14, np.random.default_rng(7), mean_interarrival=1.0,
                                    mean_duration=6.0, k_choices=k_choices)
        poisson = core.poisson_trace(cl, 200, np.random.default_rng(11), mean_interarrival=1.0,
                                     mean_duration=8.0, k_choices=k_choices)
        rec["traces"].append(trace_phase(stack, params, "golden-14-fifo", golden))
        rec["traces"].append(trace_phase(stack, params, "poisson-200", poisson))
        if name == "H100":
            samples = core.build_contended_dataset(stack[1], 256, np.random.default_rng(2))
            cparams, cinfo = core.train_contended_surrogate(
                cl, stack[2], core.to_triples(cl, samples), core.TrainConfig(steps=300),
                base_params=params)
            rec["contended_train_s"] = cinfo["train_seconds"]
            rec["traces"].append(trace_phase(stack, params, "golden-14-fifo", golden, cparams))
            rec["traces"].append(trace_phase(stack, params, "poisson-200", poisson, cparams))
    rec["launches"] = counts()
    need(all(v == 0 for v in rec["launches"].values()), "a port kernel ran on the dispatch path")
    rec["seconds"] = time.perf_counter() - t0
    print(f"dispatch: {rec['seconds']:.1f} s", flush=True)
    return rec


# -- phase 13: BandPilot-placed training, a failure and the recovery -------------

# (b) against (a): the same fp32 masters, bf16 compute and batches, the step
# on a 1-rank mesh gathers and reduces nothing; restored state is exact
ELASTIC_RTOL = 1e-5


def coordinator_log(flow):
    """(c): ``run_elastic_training``'s events with no training, on the CPU."""
    cl = core.h100_cluster()
    sim = core.BandwidthSimulator(cl)
    disp = core.BandPilotDispatcher(cl, core.IntraHostTables(cl, sim),
                                    core.GroundTruthPredictor(sim))
    failures = [FailureEvent(step=flow.fail_at, failed_gpus=list(flow.failed_gpus))]

    def no_training(alloc, start):
        return min((f.step for f in failures if f.step > start), default=flow.steps), 0.0

    log = run_elastic_training(ElasticCoordinator(cl, disp, request_size=flow.request),
                               no_training, failures, flow.steps)
    return [e for e in log if e["event"] != "train"]


def elastic_phase():
    flow = launch_elastic.card_flow()
    cfg = flow.cfg
    need(cfg.n_groups_and_tail() == (1, 0) and cfg.d_model == 4096, "elastic: config")
    per_step = launch_counts(flash_wgmma=2, rglru=6)
    scaled = lambda n: {k: v * n for k, v in per_step.items()}  # noqa: E731

    # (a) uninterrupted
    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    data = flow.data()
    batches = [data.batch(i) for i in range(flow.steps)]
    events = []
    reset_counts()
    lm, state, hist = train_loop(model, lm, timed_batches(batches, events), flow.run_config(),
                                 log_every=1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    events.append(end)
    launches_a = counts()
    need(launches_a == scaled(flow.steps), f"elastic (a) launches {launches_a}")
    losses_a = [h["loss"] for h in hist]
    step_ms_a = [x.elapsed_time(y) for x, y in zip(events, events[1:])]
    del lm, state
    torch.cuda.empty_cache()

    # (b) through a failure; the checkpoint goes under the temporary directory
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_", dir=tempfile.gettempdir())
    need_bytes = (flow.keep + 1) * launch_elastic.checkpoint_bytes(cfg)
    free = shutil.disk_usage(ckpt_dir).free
    print(f"elastic: {free} bytes free under {tempfile.gettempdir()}, "
          f"{need_bytes} needed", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with process_group("cuda"):
            out = launch_elastic.run(flow, torch.device("cuda"), ckpt_dir, seed=SEED)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches_b = counts()
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    need(launches_b == scaled(flow.steps), f"elastic (b) launches {launches_b}")
    losses_b = [h["loss"] for h in out["history"]]
    need([h["step"] for h in out["history"]] == list(range(1, flow.steps + 1)),
         "elastic (b): a step was not logged")
    rel = [abs(x - y) / abs(y) for x, y in zip(losses_b, losses_a)]
    need(all(np.isfinite(losses_b)) and max(rel) <= ELASTIC_RTOL,
         f"elastic: resumed losses {losses_b} against {losses_a}")
    redispatch = out["log"][2]
    need(not set(redispatch["alloc"]) & set(flow.failed_gpus),
         f"elastic: {redispatch['alloc']} re-uses a GPU of the dead host")

    # (c) the coordinator on the CPU
    log_b = [e for e in out["log"] if e["event"] != "train"]
    log_c = coordinator_log(flow)
    need(json.dumps(log_b, default=float) == json.dumps(log_c, default=float),
         f"elastic: event log {log_b} on the card, {log_c} on the CPU")

    # the launcher: 2 steps of the sharded step on a 1-rank mesh
    reset_counts()
    res = launch_train.main(["--arch", "recurrentgemma-9b", "--steps", "2",
                             "--global-batch", "1", "--seq-len", "2048", "--log-every", "1",
                             "--seed", str(SEED)], cfg=cfg)
    launches_train = counts()
    need(res["opt_step"] == 2 and all(np.isfinite([h["loss"] for h in res["history"]])),
         f"launch.train: {res['history']}")
    need(launches_train == scaled(2), f"launch.train launches {launches_train}")

    saves = {s["step"]: s for s in out["saves"]}
    warm = [2, 5]  # (b)'s steps with no save in them, not the first after a (re)start
    step_ms_b = [out["step_ms"][i] for i in range(1, flow.steps + 1)]
    warm_a = float(np.median(step_ms_a[1:]))  # (a) saves nothing; its first step is cold
    warm_b = float(np.median([step_ms_b[i - 1] for i in warm]))
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "compute_dtype": "bfloat16", "master_dtype": "float32",
           "batch": flow.batch, "seq": flow.seq, "steps": flow.steps,
           "fail_at": flow.fail_at, "failed_gpus": list(flow.failed_gpus),
           "losses_a": losses_a, "losses_b": losses_b, "max_rel_err": max(rel),
           "tol": ELASTIC_RTOL, "bit_equal": losses_a == losses_b,
           "step_ms_a": step_ms_a, "step_ms_b": step_ms_b,
           "step_ms_b_includes_save": sorted(saves),
           "warm_steps_b": warm, "step_ms_a_median_warm": warm_a,
           "step_ms_b_median_warm": warm_b, "sharded_overhead_ms": warm_b - warm_a,
           "log": out["log"], "log_cpu": log_c, "allocations": out["allocations"],
           "checkpoint_bytes": out["checkpoint_bytes"], "free_bytes": free,
           "needed_bytes": need_bytes, "saves": out["saves"],
           "recover": out["recover"], "peak_mem_gib_b": peak_b,
           "launches_a": launches_a, "launches_b": launches_b,
           "launch_train": {"history": res["history"], "launches": launches_train,
                            "mesh": res["mesh"], "chosen": res["chosen"]}}
    rec = json.loads(json.dumps(rec, default=float))  # numpy scalars of the dispatcher
    print("elastic", json.dumps(rec), flush=True)
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
    dispatch = dispatch_phase()
    elastic = elastic_phase()
    elastic_launches = lambda name: {  # noqa: E731
        run: elastic[key][name] for run, key in (("a", "launches_a"), ("b", "launches_b"))}

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
                          "flash_attention_wgmma"],
                      launches_elastic=elastic_launches("flash_attention_wgmma")),
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
                      launches_elastic=elastic_launches("rglru_scan"),
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
               "rwkv6_train_check": rwkv6_train_check, "train_lm": train_lm_rec,
               "dispatch": dispatch, "elastic": elastic}
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
