"""Bandwidth surrogate models in PyTorch (Sec. 4.2): the port of
``repro/core/surrogate.py``.

Three models share one Transformer-encoder trunk:

* **hierarchical** (the paper's design): tokens are per-host feature tuples
  (Stage-1 intra-host bandwidth lookup, GPU count); a 6-layer, d_model=32
  encoder with a 3-layer MLP head predicts normalized end-to-end bandwidth.
  ~89k params ~= 356 KB fp32.
* **naive** (ablation baseline, Sec. 5.5.1): tokens are raw GPU identifiers
  passed through a learned embedding.
* **contended** (the learned-contention head): the same trunk, warm-started
  from the isolated surrogate, plus a zero-initialized bias-free context
  embedding over the ledger channels of
  :func:`repro_torch.core.features.featurize_contended_batch`.

A model is a :class:`Surrogate` module whose state-dict names are the
reference pytree's paths (``embed.w``, ``trunk.layers.0.qkv.w``,
``trunk.head.2.b``, ``ctx_embed.w``, ``id_embed``); dense weights keep the
reference's ``[d_in, d_out]`` layout (``x @ w + b``).
:func:`repro_torch.weights.surrogate_from_jax_params` loads a reference
pytree, :func:`repro_torch.weights.surrogate_to_jax_params` gives one back.

The predictors score on the device their parameters live on. The fused PTS
descent (:meth:`SurrogatePredictor.eliminate_to`) runs as one CUDA graph
replay per descent on the card, captured once per shape bucket, and eagerly
on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import features as feat_lib
from repro_torch.core.cluster import Cluster
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.core.predict_cache import PredictorStats, active_batcher
from repro_torch.device import DeviceLike, resolve_device

D_MODEL = 32
N_LAYERS = 6
N_HEADS = 4
D_FF = 128
HEAD_HIDDEN = 64

# The model regresses log-bandwidth: collective bandwidths span ~2.5 orders
# of magnitude across heterogeneous clusters, and the paper's accuracy
# metric (MAPE) is a *relative* error — log-space MSE optimizes it directly.
LOG_SCALE = 5.0

VARIANTS = ("hierarchical", "naive", "contended")


def encode_bw(bw_gbps) -> torch.Tensor:
    """GB/s -> normalized log-space target."""
    return torch.log1p(torch.as_tensor(bw_gbps)) / LOG_SCALE


def decode_bw(y: torch.Tensor) -> torch.Tensor:
    """normalized log-space prediction -> GB/s."""
    return torch.expm1(torch.clamp(y, 0.0, 2.0) * LOG_SCALE)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, device=device))
        if bias:
            self.b = nn.Parameter(torch.zeros(d_out, device=device))


class _LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, device=device))
        self.b = nn.Parameter(torch.zeros(d, device=device))


class _Layer(nn.Module):
    def __init__(self, d: int = D_MODEL, d_ff: int = D_FF, device=None):
        super().__init__()
        self.ln1 = _LayerNorm(d, device)
        self.qkv = _Dense(d, 3 * d, device=device)
        self.o = _Dense(d, d, device=device)
        self.ln2 = _LayerNorm(d, device)
        self.ff1 = _Dense(d, d_ff, device=device)
        self.ff2 = _Dense(d_ff, d, device=device)


class _Trunk(nn.Module):
    def __init__(self, d: int = D_MODEL, n_layers: int = N_LAYERS, device=None):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(d, device=device) for _ in range(n_layers))
        self.ln_f = _LayerNorm(d, device)
        self.head = nn.ModuleList([
            _Dense(d, HEAD_HIDDEN, device=device),
            _Dense(HEAD_HIDDEN, HEAD_HIDDEN, device=device),
            _Dense(HEAD_HIDDEN, 1, device=device),
        ])


class Surrogate(nn.Module):
    """The parameters of one surrogate: ``variant`` is ``"hierarchical"``,
    ``"naive"`` (needs ``n_gpus``) or ``"contended"``. Built with zero
    weights (layer norms at identity) that take no gradient; the ``init_*``
    functions draw them, and a trainer turns gradients on in its own copy.
    The forward passes are the ``apply_*`` functions below."""

    def __init__(self, variant: str = "hierarchical", n_gpus: Optional[int] = None,
                 device=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown surrogate variant {variant!r}")
        self.variant = variant
        if variant == "naive":
            if not n_gpus:
                raise ValueError("the naive surrogate needs n_gpus")
            self.id_embed = nn.Parameter(torch.zeros(n_gpus, D_MODEL, device=device))
        else:
            self.embed = _Dense(feat_lib.N_FEATURES, D_MODEL, device=device)
        if variant == "contended":
            self.ctx_embed = _Dense(feat_lib.N_LEDGER_FEATURES, D_MODEL, bias=False,
                                    device=device)
        self.trunk = _Trunk(device=device)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _normal_(p: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * scale)


def _init_trunk(trunk: _Trunk, gen: torch.Generator) -> None:
    for layer in trunk.layers:
        for dense in (layer.qkv, layer.o, layer.ff1, layer.ff2):
            _normal_(dense.w, gen, 1.0 / np.sqrt(dense.w.shape[0]))
    for dense in trunk.head:
        _normal_(dense.w, gen, 1.0 / np.sqrt(dense.w.shape[0]))


def init_hierarchical_params(gen: torch.Generator, device: DeviceLike = "cuda") -> Surrogate:
    """Weights drawn from ``gen`` (on its own device), then moved to
    ``device``: a generator on the CPU gives the same model on any device."""
    params = Surrogate("hierarchical", device=gen.device)
    _normal_(params.embed.w, gen, 1.0)
    # The per-host-type normalized channel (features.py channel 4) starts
    # inert: a zero embed row means an un-trained (or legacy-trained) model
    # is unaffected by it; training opts in where it helps.
    params.embed.w[feat_lib.N_FEATURES - 1] = 0.0
    _init_trunk(params.trunk, gen)
    return params.to(resolve_device(device))


def init_naive_params(gen: torch.Generator, n_gpus: int,
                      device: DeviceLike = "cuda") -> Surrogate:
    params = Surrogate("naive", n_gpus=n_gpus, device=gen.device)
    _normal_(params.id_embed, gen, 0.1)
    _init_trunk(params.trunk, gen)
    return params.to(resolve_device(device))


def init_contended_params(base_params: Surrogate) -> Surrogate:
    """ContendedSurrogate init: the isolated trunk + embed (warm start) plus
    a ZERO context embedding — so at init the contended model computes
    exactly the isolated prediction wherever the ledger channels are zero.
    Deterministic (no rng); on the base's device."""
    params = Surrogate("contended", device=base_params.device)
    params.embed.load_state_dict(base_params.embed.state_dict())
    params.trunk.load_state_dict(base_params.trunk.state_dict())
    return params


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def _dense(p: _Dense, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.w.t(), p.b)  # x @ w + b, one GEMM with the bias


def _layernorm(p: _LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # population variance, eps inside the root: the reference's formula
    return F.layer_norm(x, (x.shape[-1],), p.g, p.b, eps)


def _mha(p: _Layer, x: torch.Tensor, masked: torch.Tensor) -> torch.Tensor:
    """Masked multi-head self-attention.  x: [B,H,D]; masked: [B,1,1,H],
    True where a key is padding."""
    B, H, D = x.shape
    dh = D // N_HEADS
    # q|k|v split before the head reshape: [B,H,3D] -> 3 x [B,N_HEADS,H,dh]
    q, k, v = _dense(p.qkv, x).reshape(B, H, 3, N_HEADS, dh).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-1, -2) / np.sqrt(dh)
    # masked scores take the most negative float, not -inf (the reference's fill)
    scores = scores.masked_fill(masked, torch.finfo(scores.dtype).min)
    out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, H, D)
    return _dense(p.o, out)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _encoder(trunk: _Trunk, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pre-LN Transformer encoder + masked mean-pool + MLP head -> [B]."""
    masked = (mask <= 0)[:, None, None, :]
    for layer in trunk.layers:
        x = x + _mha(layer, _layernorm(layer.ln1, x), masked)
        h = _layernorm(layer.ln2, x)
        x = x + _dense(layer.ff2, _gelu(_dense(layer.ff1, h)))
    x = _layernorm(trunk.ln_f, x)
    denom = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
    pooled = (x * mask[..., None]).sum(dim=1) / denom  # [B, D]
    h = _gelu(_dense(trunk.head[0], pooled))
    h = _gelu(_dense(trunk.head[1], h))
    return _dense(trunk.head[2], h)[..., 0]


def apply_hierarchical(params: Surrogate, feats: torch.Tensor, mask: torch.Tensor):
    """feats: [B, H, F], mask: [B, H] -> normalized bandwidth [B]."""
    return _encoder(params.trunk, _dense(params.embed, feats), mask)


def apply_naive(params: Surrogate, ids: torch.Tensor, mask: torch.Tensor):
    """ids: [B, K] int GPU identifiers, mask: [B, K] -> normalized bw [B]."""
    return _encoder(params.trunk, params.id_embed[ids.long()], mask)


def apply_contended(params: Surrogate, feats: torch.Tensor, mask: torch.Tensor):
    """feats: [B, T, N_CONTENDED_FEATURES], mask: [B, T] -> normalized bw [B].

    The ledger channels enter through a bias-free context embedding added to
    the base-token embedding; with an all-zero context the forward pass is
    the isolated :func:`apply_hierarchical` of the embedded trunk."""
    base = feats[..., : feat_lib.N_FEATURES]
    ctx = feats[..., feat_lib.N_FEATURES:]
    x = _dense(params.embed, base) + ctx @ params.ctx_embed.w
    return _encoder(params.trunk, x, mask)


# Apply + decode, shared by every predictor and the inference batcher (the
# batcher groups requests by the identity of these functions).

@torch.no_grad()
def _apply_hierarchical_bw(params, feats, mask):
    return decode_bw(apply_hierarchical(params, feats, mask))


@torch.no_grad()
def _apply_naive_bw(params, ids, mask):
    return decode_bw(apply_naive(params, ids, mask))


@torch.no_grad()
def _apply_contended_bw(params, feats, mask):
    return decode_bw(apply_contended(params, feats, mask))


def _apply_np(fn, params: Surrogate, x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """One apply on the parameters' device: numpy in, float32 numpy out."""
    dev = params.device
    out = fn(params, torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev))
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Predictor: the deployable surrogate B̂(S)
# ---------------------------------------------------------------------------

def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# Fused elimination descent: the whole PTS descent as one device program
# ---------------------------------------------------------------------------
#
# The host PTS loop pays one featurize + one apply + one host<->device round
# trip per elimination round. ``_pts_scan`` runs the whole descent |S0| -> k
# as a fixed ``N0b - 1`` rounds of tensor code with no host sync: per-round
# child patching of ``features.featurize_children`` as gathers over the
# per-(host, bitmask) tables of :class:`features.DeviceTables`, Stage-1
# dispatch of single-host children, the Transformer apply on all children,
# the tabulated analytic contention cap and a first-wins argmax. A round
# after the descent reached ``k`` leaves the carry as it is (a ``where`` on
# "still above k" stands in for the reference's ``lax.cond``).
#
# On the card the program is captured as one CUDA graph per
# (N0b, H, mask_size, lattice) bucket (the reference's ``_SCAN_COMPILED``):
# a descent is one host-to-device copy of each of its two packed input
# buffers, one replay and one device-to-host copy of the packed outputs.
# The graph reads fixed addresses, so it owns a static copy of the model
# into which each replay first copies the calling predictor's parameters,
# and a lock serializes replays of one graph (the control plane searches
# from a thread pool). On the CPU the same function runs eagerly.
#
# Scores are float32, as in the reference; the per-round argmax over them
# matching the host loop's argmax over float64 scores is checked round by
# round in ``tests/test_torch_dispatch.py``, and ``pts_search`` keeps the
# host loop for any configuration the descent declines.

SCAN_MIN_SLOTS = 8    # slot-bucket floor: descent buckets are {8, 16, 32, 64}
SCAN_MAX_SLOTS = 64   # largest parent the scan path accepts
_SCAN_MAX_HOST_GPUS = 16   # gather tables are [H, 2**max_g]: bound them
_SCAN_MAX_LATTICE = 1 << 16  # cap-table bound (paper clusters: 9**4 = 6561)


@dataclasses.dataclass
class ScanResult:
    """One whole elimination descent ``|S0| -> k``.

    ``scores``/``sels``/``elims`` expose every round's internal state so the
    audit tests can compare each round against the host loop; ``sels[r]``
    marks the slots still live *entering* round ``r`` (slot i = the i-th
    element of the sorted parent), and ``scores[r]`` holds the f32 child
    scores at those slots (padding / eliminated slots carry mirror-parent
    garbage and are never selected)."""

    subset: List[int]          # the surviving k GPUs, ascending
    n_rounds: int              # active elimination rounds (= |S0| - k)
    n_capped: int              # live children whose cap bound (f32 compare)
    scores: np.ndarray         # [R, N0b] float32 per-round child scores
    sels: np.ndarray           # [R, N0b] bool pre-round live slots
    elims: np.ndarray          # [R] int32 slot eliminated per round


def _pts_scan(params, tok0, tok4, stage1, cap_tab, strides, slot_host,
              slot_bit, sel0, bits0, counts0, k, n_gpus_f) -> torch.Tensor:
    """The fused descent, ``N0b - 1`` rounds, no host sync.

    Returns the rounds' outputs packed as float32 ``[N0b - 1, 2 * N0b + 3]``:
    per round the child scores, the pre-round live slots, the eliminated
    slot, whether the round was active and its capped-child count (all
    small integers, exact in float32); an inactive round's row is zeros."""
    N0b = slot_host.shape[0]
    H = bits0.shape[0]
    dev = slot_host.device
    harange = torch.arange(H, device=dev)
    hidx = harange[None, :].expand(N0b, H)
    # per-slot one-hot host row / local bit, for child patching + elimination
    host_oh = (slot_host[:, None] == harange[None, :]).to(torch.int32)
    sub_bits = host_oh * slot_bit[:, None]
    slot_idx = torch.arange(N0b, device=dev)
    zero = torch.zeros((), device=dev)
    neg_inf = torch.full((), float("-inf"), device=dev)
    sel, bits, counts = sel0, bits0, counts0
    n = sel0.sum().to(torch.int32)
    rows = []
    for _ in range(N0b - 1):
        active = n > k
        # child i = parent minus slot i.  Eliminated/padded slots mirror the
        # parent itself and are excluded from the argmax below.
        bits_c = torch.where(sel[:, None], bits[None, :] - sub_bits, bits[None, :]).long()
        counts_c = torch.where(sel[:, None], counts[None, :] - host_oh, counts[None, :])
        part = counts_c > 0
        kc = (n - 1).to(torch.float32)
        cf = counts_c.to(torch.float32)
        # the five isolated channels of features._isolated_channels, as
        # where-gated gathers (never multiply-by-mask: NaN-safe)
        feats = torch.stack([
            torch.where(part, tok0[hidx, bits_c], zero),
            torch.where(part, cf / 8.0, zero),
            torch.where(part, cf / kc, zero),
            torch.where(part, kc / n_gpus_f, zero),
            torch.where(part, tok4[hidx, bits_c], zero),
        ], dim=-1)
        # pack participating tokens into the leading slots, hosts ascending
        # (the order features._pack_tokens scatters into)
        order = torch.argsort((~part).to(torch.int32), dim=1, stable=True)
        feats_p = torch.gather(feats, 1, order[..., None].expand(N0b, H, feats.shape[-1]))
        mask = torch.gather(part, 1, order).to(torch.float32)
        bw = decode_bw(apply_hierarchical(params, feats_p, mask))
        # Stage-1 dispatch: single-host children read the exact lookup
        h_star = torch.argmax(part.to(torch.int32), dim=1)
        s1 = stage1[h_star, bits_c[slot_idx, h_star]]
        iso = torch.where(part.sum(dim=1) == 1, s1, bw)
        # analytic contention cap: one gather on the count-vector lattice
        cap = cap_tab[(counts_c * strides[None, :]).sum(dim=1).long()]
        score = torch.minimum(iso, cap)
        n_capped = ((cap < iso) & sel).sum()
        elim = torch.argmax(torch.where(sel, score, neg_inf))
        at = elim[None]  # a tensor index: indexing by a 0-dim tensor would sync
        oh = (harange == slot_host[at]).to(torch.int32)
        rows.append(torch.cat([
            torch.where(active, score, zero),
            (sel & active).to(torch.float32),
            torch.stack([elim, torch.ones_like(elim), n_capped]).to(torch.float32) * active,
        ]))
        sel = torch.where(active, sel & (slot_idx != elim), sel)
        bits = torch.where(active, bits - oh * slot_bit[at], bits)
        counts = torch.where(active, counts - oh, counts)
        n = torch.where(active, n - 1, n)
    return torch.stack(rows)


def _scan_buffers(dt, cap_tab, slot_host, slot_bit, sel0, bits0, counts0, k,
                  host_norm) -> Tuple[np.ndarray, np.ndarray]:
    """A descent's inputs packed as one float32 and one int32 buffer — ONE
    code path for the graph's capture, its replays and the eager CPU run."""
    tok4 = dt.tok4 if host_norm else dt.tok4_zero
    f32 = np.concatenate([
        dt.tok0.ravel(), tok4.ravel(), dt.stage1.ravel(),
        np.asarray(cap_tab, np.float32), [dt.n_gpus_f],
    ]).astype(np.float32)
    i32 = np.concatenate([
        dt.strides, bits0, counts0, slot_host, slot_bit, sel0, [k],
    ]).astype(np.int32)
    return f32, i32


def _scan_from_buffers(params, key, f32: torch.Tensor, i32: torch.Tensor) -> torch.Tensor:
    N0b, H, W, L = key
    HW = H * W
    tok0, tok4, stage1 = (f32[i * HW:(i + 1) * HW].view(H, W) for i in range(3))
    cap_tab = f32[3 * HW:3 * HW + L]
    n_gpus_f = f32[3 * HW + L]
    strides, bits0, counts0 = (i32[i * H:(i + 1) * H] for i in range(3))
    o = 3 * H
    slot_host = i32[o:o + N0b]
    slot_bit = i32[o + N0b:o + 2 * N0b]
    sel0 = i32[o + 2 * N0b:o + 3 * N0b] > 0
    k = i32[o + 3 * N0b]
    with torch.no_grad():
        return _pts_scan(params, tok0, tok4, stage1, cap_tab, strides, slot_host,
                         slot_bit, sel0, bits0, counts0, k, n_gpus_f)


class _ScanGraph:
    """The descent of one shape bucket, captured as a CUDA graph.

    Owns static input buffers and a static copy of a hierarchical model;
    :meth:`replay` copies the caller's parameters and inputs into them,
    replays and copies the packed outputs back, under the graph's lock."""

    def __init__(self, key, device: torch.device, warm: Tuple[np.ndarray, np.ndarray]):
        t0 = time.time()
        self.key = key
        self.lock = threading.Lock()
        self.replays = 0
        self.params = Surrogate("hierarchical", device=device)
        self._static = list(self.params.parameters())
        self.f32 = torch.from_numpy(warm[0]).to(device)
        self.i32 = torch.from_numpy(warm[1]).to(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # lazy library set-up happens outside the capture
            _scan_from_buffers(self.params, key, self.f32, self.i32)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = _scan_from_buffers(self.params, key, self.f32, self.i32)
        torch.cuda.synchronize(device)
        self.capture_seconds = time.time() - t0

    def replay(self, params: Surrogate, f32: np.ndarray, i32: np.ndarray) -> np.ndarray:
        with self.lock, torch.no_grad():
            torch._foreach_copy_(self._static, list(params.parameters()))
            self.f32.copy_(torch.from_numpy(f32))
            self.i32.copy_(torch.from_numpy(i32))
            self.graph.replay()
            self.replays += 1
            return self.out.cpu().numpy()


# (N0b, H_all, 2**max_g, lattice_size, device) -> captured descent. Tables,
# parameters and scalars are copied in per replay, so e.g. H100 and Het-4Mix
# (both 4x8) share every bucket's graph, and so do every ledger state, k and
# model.
_SCAN_GRAPHS: Dict[Tuple, _ScanGraph] = {}
_SCAN_GRAPHS_LOCK = threading.Lock()


def _scan_graph(key, device: torch.device, warm) -> Tuple[_ScanGraph, float]:
    """Fetch (or capture) the graph of one bucket; returns (graph, seconds
    spent capturing it now)."""
    with _SCAN_GRAPHS_LOCK:
        graph = _SCAN_GRAPHS.get(key + (str(device),))
        if graph is not None:
            return graph, 0.0
        graph = _ScanGraph(key, device, warm)
        _SCAN_GRAPHS[key + (str(device),)] = graph
        return graph, graph.capture_seconds


def scan_graphs() -> List[Dict[str, Any]]:
    """Each captured bucket: its key, capture seconds and replay count."""
    with _SCAN_GRAPHS_LOCK:
        return [{"N0b": g.key[0], "H": g.key[1], "mask_size": g.key[2],
                 "lattice": g.key[3], "device": dev, "capture_seconds": g.capture_seconds,
                 "replays": g.replays}
                for (*_, dev), g in _SCAN_GRAPHS.items()]


class SurrogatePredictor:
    """Deployable B̂(S): Stage-1 exact lookup for single-host allocations,
    Stage-2 Transformer for multi-host ones (Fig. 4).

    Batched evaluation pads the batch to a power of two with sentinel rows;
    with ``bucket_shapes`` (the default) the *token* dimension is bucketed
    to the power-of-two cover of the batch's max participating-host count.
    ``vectorized=False`` falls back to the per-candidate loop featurizer.
    Scores are computed on the device the parameters live on.

    ``eliminate_to`` runs a whole PTS elimination descent as one fused
    device program (one CUDA graph replay on the card; ``use_scan=False``
    disables it); ``warm_scan`` captures the graphs of the cluster's slot
    buckets ahead of the first admission. ``n_descents`` counts descents
    run, ``n_graph_replays`` those that ran as a graph replay.
    """

    def __init__(
        self,
        cluster: Cluster,
        tables: IntraHostTables,
        params: Surrogate,
        naive: bool = False,
        max_k: Optional[int] = None,
        host_norm: bool = True,
        vectorized: bool = True,
        bucket_shapes: bool = True,
        use_scan: bool = True,
    ):
        self.cluster = cluster
        self.tables = tables
        self.params = params
        self.naive = naive
        self.host_norm = host_norm
        self.vectorized = vectorized
        self.bucket_shapes = bucket_shapes
        self.use_scan = use_scan
        self.max_k = max_k or cluster.n_gpus
        self.stats = PredictorStats()  # instrumentation for Fig. 8
        self.n_descents = 0
        self.n_graph_replays = 0
        self._apply = _apply_naive_bw if naive else _apply_hierarchical_bw

    # legacy instrumentation names (benchmarks read/reset these directly)
    @property
    def n_model_calls(self) -> int:
        return self.stats.n_model_calls

    @n_model_calls.setter
    def n_model_calls(self, v: int) -> None:
        self.stats.n_model_calls = v

    @property
    def predict_seconds(self) -> float:
        return self.stats.predict_seconds

    @predict_seconds.setter
    def predict_seconds(self, v: float) -> None:
        self.stats.predict_seconds = v

    # hierarchical stage dispatch --------------------------------------------

    def predict(self, subsets: Sequence[Sequence[int]]) -> np.ndarray:
        """B̂ for a batch of allocations (GB/s, denormalized)."""
        t0 = time.time()
        out = np.zeros((len(subsets),), np.float64)
        model_idx: List[int] = []
        model_subsets: List[Sequence[int]] = []
        for i, s in enumerate(subsets):
            if not self.naive and len(self.cluster.partition_by_host(s)) == 1:
                out[i] = self.tables.lookup_global(list(s))  # Stage-1: exact
            else:
                model_idx.append(i)
                model_subsets.append(s)
        if model_subsets:
            preds = self._predict_model(model_subsets)
            for i, p in zip(model_idx, preds):
                out[i] = p
        self.stats.predict_seconds += time.time() - t0
        return out

    def predict_one(self, subset: Sequence[int]) -> float:
        return float(self.predict([subset])[0])

    def predict_children(self, parent: Sequence[int]) -> np.ndarray:
        """Fused featurize+predict of one PTS elimination round: all
        ``|parent|`` remove-one children in parent order, with the child
        token batch assembled incrementally from the parent's per-host
        grids and single-host children answered by Stage-1 gathers.
        Predictions equal ``predict(children)``: same channels, same shape
        buckets."""
        parent = list(parent)
        n = len(parent)
        if self.naive or n < 2 or not self.vectorized:
            return self.predict(
                [parent[:i] + parent[i + 1:] for i in range(n)]
            )
        t0 = time.time()
        arrays = feat_lib.host_arrays(self.cluster, self.tables)
        bits, counts = feat_lib.child_bits_counts(arrays, parent)
        part = counts > 0
        n_part = part.sum(axis=1)
        out = np.zeros((n,), np.float64)
        for i in np.nonzero(n_part == 1)[0]:
            h = int(np.argmax(part[i]))
            out[i] = arrays.intra_bw[h, bits[i, h]]  # Stage-1: exact
        model = np.nonzero(n_part > 1)[0]
        if len(model):
            ks = np.full((len(model),), n - 1, np.int64)
            tokens = feat_lib._isolated_channels(
                arrays, bits[model], counts[model], ks, self.host_norm
            )
            feats, mask = feat_lib._pack_tokens(
                tokens, counts[model], self.cluster.n_hosts,
                feat_lib.N_FEATURES,
            )
            self.stats.featurize_seconds += time.time() - t0
            out[model] = self._apply_model(feats, mask)
        else:
            self.stats.featurize_seconds += time.time() - t0
        self.stats.predict_seconds += time.time() - t0
        return out

    # fused descent --------------------------------------------------------

    def _scan_envelope(self):
        """The (arrays, device tables) pair when this predictor/cluster is
        inside the scan envelope, else None."""
        if self.naive or not self.vectorized or not self.use_scan:
            return None
        arrays = feat_lib.host_arrays(self.cluster, self.tables)
        if arrays.max_host_gpus > _SCAN_MAX_HOST_GPUS:
            return None
        dt = feat_lib.device_tables(self.cluster, self.tables)
        if dt.lattice_size > _SCAN_MAX_LATTICE:
            return None
        return arrays, dt

    def eliminate_to(
        self,
        parent: Sequence[int],
        k: int,
        caps: Optional[np.ndarray] = None,
    ) -> Optional[ScanResult]:
        """Run the whole PTS elimination descent ``|parent| -> k`` as one
        fused device program (see the module section above).

        ``caps`` is a float32 ``[lattice_size]`` analytic-cap table (the
        contention wrapper builds one per ledger version); None means
        uncapped (isolated scoring).  Returns a :class:`ScanResult`, or
        None when the configuration is outside the scan envelope — the
        caller falls back to the host loop, which is always correct."""
        parent = sorted(parent)
        n0 = len(parent)
        t0 = time.time()
        inputs = self.scan_inputs(parent, k, caps)
        if inputs is None:
            return None
        key = inputs[0]
        N0b = key[0]
        out = self._run_scan(*inputs)
        scores = out[:, :N0b]
        sels = out[:, N0b:2 * N0b] > 0.5
        elims = out[:, 2 * N0b].astype(np.int32)
        actives = out[:, 2 * N0b + 1] > 0.5
        capped = out[:, 2 * N0b + 2].astype(np.int32)
        R = int(actives.sum())
        sel = np.zeros((N0b,), bool)
        sel[:n0] = True
        for r in range(R):
            sel[elims[r]] = False
        subset = [parent[i] for i in np.nonzero(sel[:n0])[0]]
        if R != n0 - k or len(subset) != k:
            return None  # never expected; host loop is the safe fallback
        self.stats.scan_seconds += time.time() - t0
        self.stats.n_scan_steps += R
        return ScanResult(
            subset=subset,
            n_rounds=R,
            n_capped=int(capped[:R].sum()),
            scores=scores[:R],
            sels=sels[:R],
            elims=elims[:R],
        )

    def scan_inputs(self, parent: Sequence[int], k: int,
                    caps: Optional[np.ndarray] = None):
        """``(bucket key, float32 buffer, int32 buffer)`` of the descent of
        the sorted ``parent`` to ``k``, or None where the descent declines:
        outside the envelope, ``k < 1``, ``|parent| <= k``, a single-host
        parent, or more than ``SCAN_MAX_SLOTS`` slots."""
        env = self._scan_envelope()
        if env is None:
            return None
        arrays, dt = env
        n0 = len(parent)
        if k < 1 or n0 <= k:
            return None
        if len(self.cluster.partition_by_host(parent)) < 2:
            return None  # single-host descent: Stage-1 host loop is exact
        N0b = max(_round_up_pow2(n0), SCAN_MIN_SLOTS)
        if N0b > SCAN_MAX_SLOTS:
            return None
        if caps is None:
            caps = dt.caps_inf()
        slot_host = np.zeros((N0b,), np.int32)
        slot_bit = np.zeros((N0b,), np.int32)
        slot_host[:n0] = arrays.gpu_host[parent]
        slot_bit[:n0] = arrays.gpu_bit[parent]
        sel0 = np.zeros((N0b,), bool)
        sel0[:n0] = True
        pbits, pcounts, _, _, _ = feat_lib._batch_bits_counts(
            arrays, [parent]
        )
        key = (N0b, pbits.shape[1], dt.mask_size, caps.shape[0])
        return (key,) + _scan_buffers(dt, caps, slot_host, slot_bit, sel0, pbits[0],
                                      pcounts[0], k, self.host_norm)

    def _run_scan(self, key, f32: np.ndarray, i32: np.ndarray) -> np.ndarray:
        """One descent: a graph replay on the card, eager on the CPU."""
        dev = self.params.device
        self.n_descents += 1
        if dev.type == "cuda":
            graph, _ = _scan_graph(key, dev, (f32, i32))
            out = graph.replay(self.params, f32, i32)
            self.n_graph_replays += 1
            return out
        return _scan_from_buffers(self.params, key, torch.from_numpy(f32),
                                  torch.from_numpy(i32)).numpy()

    def warm_scan(self, buckets: Optional[Sequence[int]] = None) -> float:
        """Capture the descent graphs of the cluster's slot buckets, so the
        first admission carries no capture spike.  Returns seconds spent;
        0.0 when every bucket was already captured (the graphs are
        process-wide and shared across same-shaped clusters) and on the CPU,
        where the descent runs eagerly."""
        env = self._scan_envelope()
        if env is None or self.params.device.type != "cuda":
            return 0.0
        _, dt = env
        if buckets is None:
            top = min(
                max(_round_up_pow2(self.cluster.n_gpus), SCAN_MIN_SLOTS),
                SCAN_MAX_SLOTS,
            )
            buckets = []
            b = SCAN_MIN_SLOTS
            while b <= top:
                buckets.append(b)
                b *= 2
        spent = 0.0
        H = self.cluster.n_hosts
        caps = dt.caps_inf()
        for N0b in buckets:
            # capture inputs: no live slot and k = 0, so every round is
            # inactive and every gather index is in range
            warm = _scan_buffers(
                dt, caps, np.zeros((N0b,), np.int32), np.zeros((N0b,), np.int32),
                np.zeros((N0b,), bool), np.zeros((H,), np.int32),
                np.zeros((H,), np.int32), 0, self.host_norm,
            )
            _, seconds = _scan_graph((N0b, H, dt.mask_size, caps.shape[0]),
                                     self.params.device, warm)
            spent += seconds
        return spent

    def _predict_model(self, subsets: Sequence[Sequence[int]]) -> np.ndarray:
        if self.naive:
            t0 = time.time()
            B = len(subsets)
            Bp = _round_up_pow2(max(B, 1))
            ids, mask = feat_lib.featurize_gpu_ids(self.cluster, subsets, self.max_k)
            ids = np.pad(ids, ((0, Bp - B), (0, 0)))
            mask_p = np.pad(mask, ((0, Bp - B), (0, 0)))
            mask_p[B:, 0] = 1.0  # keep padded rows non-degenerate
            self.stats.featurize_seconds += time.time() - t0
            t1 = time.time()
            preds = _apply_np(self._apply, self.params, ids, mask_p)
            self.stats.n_model_calls += B
            decoded = preds[:B]
            self.stats.infer_seconds += time.time() - t1
            return decoded
        t0 = time.time()
        featurize = (
            feat_lib.featurize_batch if self.vectorized
            else feat_lib.featurize_batch_loop
        )
        feats, mask = featurize(
            self.cluster, self.tables, subsets, host_norm=self.host_norm
        )
        self.stats.featurize_seconds += time.time() - t0
        return self._apply_model(feats, mask)

    def _apply_model(self, feats: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Bucket + pad + apply, shared by the batch and fused-round paths
        so the two produce identical floats for identical batches."""
        t1 = time.time()
        B = feats.shape[0]
        if self.bucket_shapes:
            used = int(mask.sum(axis=1).max()) if B else 1
            H = _round_up_pow2(max(used, 1))
            if H < feats.shape[1]:
                feats = feats[:, :H]
                mask = mask[:, :H]
        batcher = active_batcher()
        if batcher is not None:
            # cross-search fusion: the batcher performs the same B padding,
            # possibly alongside other searches' requests
            decoded = batcher.apply(self._apply, self.params, feats, mask)
            self.stats.n_model_calls += B
            self.stats.infer_seconds += time.time() - t1
            return decoded
        Bp = _round_up_pow2(max(B, 1))
        feats = np.pad(feats, ((0, Bp - B), (0, 0), (0, 0)))
        mask_p = np.pad(mask, ((0, Bp - B), (0, 0)))
        mask_p[B:, 0] = 1.0  # keep padded rows non-degenerate
        preds = _apply_np(self._apply, self.params, feats, mask_p)
        self.stats.n_model_calls += B
        decoded = preds[:B]
        self.stats.infer_seconds += time.time() - t1
        return decoded


# ---------------------------------------------------------------------------
# Contended predictor: the deployable B̂(S | L)
# ---------------------------------------------------------------------------

class ContendedSurrogatePredictor:
    """Deployable learned-contention B̂(S | L) (the ContendedSurrogate).

    Same two-stage dispatch as :class:`SurrogatePredictor`: single-host
    allocations never touch a NIC, so Stage-1 exact lookups answer them
    regardless of the ledger; multi-host allocations are featurized together
    with their ledger context and scored by the contended Transformer.

    ``predict(subsets, ledger)`` scores a batch against one live ledger (the
    search path); ``predict_pairs`` takes explicit (subset, ledger) pairs
    (the dataset-evaluation path, where every sample has its own ledger).
    """

    def __init__(
        self,
        cluster: Cluster,
        tables: IntraHostTables,
        params: Surrogate,
        max_tokens: Optional[int] = None,
        include_contenders: bool = True,
        host_norm: bool = True,
        vectorized: bool = True,
        bucket_shapes: bool = True,
    ):
        self.cluster = cluster
        self.tables = tables
        self.params = params
        self.max_tokens = max_tokens or feat_lib.default_max_tokens(cluster)
        self.include_contenders = include_contenders
        self.host_norm = host_norm
        self.vectorized = vectorized
        self.bucket_shapes = bucket_shapes
        self.stats = PredictorStats()
        self._apply = _apply_contended_bw

    @property
    def n_model_calls(self) -> int:
        return self.stats.n_model_calls

    @n_model_calls.setter
    def n_model_calls(self, v: int) -> None:
        self.stats.n_model_calls = v

    @property
    def predict_seconds(self) -> float:
        return self.stats.predict_seconds

    @predict_seconds.setter
    def predict_seconds(self, v: float) -> None:
        self.stats.predict_seconds = v

    def predict(self, subsets: Sequence[Sequence[int]], ledger) -> np.ndarray:
        """Contended B̂ for a batch of allocations against one live ledger."""
        return self.predict_pairs([(s, ledger) for s in subsets])

    def predict_one(self, subset: Sequence[int], ledger) -> float:
        return float(self.predict([subset], ledger)[0])

    def predict_pairs(self, pairs: Sequence[Tuple[Sequence[int], Any]]) -> np.ndarray:
        t0 = time.time()
        out = np.zeros((len(pairs),), np.float64)
        model_idx: List[int] = []
        model_pairs: List[Tuple[Sequence[int], Any]] = []
        for i, (s, ledger) in enumerate(pairs):
            if len(self.cluster.partition_by_host(s)) == 1:
                out[i] = self.tables.lookup_global(list(s))  # Stage-1: exact
            else:
                model_idx.append(i)
                model_pairs.append((s, ledger))
        if model_pairs:
            tf = time.time()
            B = len(model_pairs)
            Bp = _round_up_pow2(B)
            featurize = (
                feat_lib.featurize_contended_batch if self.vectorized
                else feat_lib.featurize_contended_batch_loop
            )
            feats, mask = featurize(
                self.cluster, self.tables, model_pairs,
                max_tokens=self.max_tokens,
                include_contenders=self.include_contenders,
                host_norm=self.host_norm,
            )
            if self.bucket_shapes:
                used = int(mask.sum(axis=1).max())
                T = _round_up_pow2(max(used, 1))
                if T < feats.shape[1]:
                    feats = feats[:, :T]
                    mask = mask[:, :T]
            self.stats.featurize_seconds += time.time() - tf
            ti = time.time()
            batcher = active_batcher()
            if batcher is not None:
                decoded = batcher.apply(self._apply, self.params, feats, mask)
            else:
                feats = np.pad(feats, ((0, Bp - B), (0, 0), (0, 0)))
                mask_p = np.pad(mask, ((0, Bp - B), (0, 0)))
                mask_p[B:, 0] = 1.0
                decoded = _apply_np(self._apply, self.params, feats, mask_p)[:B]
            self.stats.n_model_calls += B
            self.stats.infer_seconds += time.time() - ti
            for i, p in zip(model_idx, decoded):
                out[i] = p
        self.stats.predict_seconds += time.time() - t0
        return out
