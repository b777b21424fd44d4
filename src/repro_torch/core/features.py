"""Feature extraction for the hierarchical surrogate (Sec. 4.2.1, Fig. 4).

For an allocation S, the Transformer receives one token per *participating
host*: a feature tuple of (i) the Stage-1 measured intra-host bandwidth of
the GPUs selected on that host and (ii) the number of GPUs selected there.
Padding + mask make the representation batchable; the architecture itself is
size-agnostic (any number of hosts / any k).

Two featurizations live here:

* **Isolated** (``featurize_one`` / ``featurize_batch``): per-host tokens of
  ``N_FEATURES`` channels.  Channel 4 is the per-host-type *normalized*
  intra-host bandwidth: ``(log1p(intra) - log1p(rail_bw * n_h)) / 5`` —
  the intra bandwidth measured against the host type's NIC rail capacity
  at the selected count.  Mixed NVLink generations span ~2.5 decades in
  log-space, and the raw log channel leaves the model to recover each host
  class's operating point (and hence which of the intra/inter constraints
  binds — where the Het-VA errors concentrate, see ROADMAP) on its own;
  this channel hands it the normalized position directly.  The matching
  embed row is zero-initialized (``surrogate.init_hierarchical_params``) so
  an un-trained or legacy-trained model is unaffected.  ``host_norm=False``
  zeroes the channel (the ablation knob ``bench_surrogate_accuracy`` uses
  to report the delta).

* **Contended** (``featurize_contended_one`` / ``featurize_contended_batch``):
  the isolated channels plus ``N_LEDGER_FEATURES`` ledger-context channels
  per token — segment flag, rail-contender count ``c_h``, contender GPU
  demand on the host, and disjoint occupancy — and (optionally) one extra
  token per (contending job, shared host) pair carrying the contender's own
  intra-host features with the segment flag set.  Under an **empty ledger**
  the first ``N_FEATURES`` channels are bit-identical to the isolated
  featurization, every context channel is exactly zero, and no contender
  token is emitted (regression-pinned): the contended representation is a
  strict superset of the isolated one.

**Fast path.**  The batch featurizers are *array programs*: per-GPU host
indices and per-(host, local-subset-bitmask) Stage-1 bandwidths are
precomputed once per :class:`~repro.core.intra_host.IntraHostTables`
(:func:`host_arrays`) and every candidate's tokens are produced by numpy
gathers/scatters — no per-candidate Python loops over hosts.  The legacy
loop implementations are kept (``featurize_batch_loop`` /
``featurize_contended_batch_loop``) as the bit-identity reference
(``tests/test_fast_path.py`` pins exact array equality) and as the
before-side of ``benchmarks/bench_dispatch_throughput.py``.
:func:`featurize_children` is the incremental entry point for PTS: one
elimination round's candidates are the parent's token matrix with a patched
row per child (plus the two cheap k-dependent request-context channels
recomputed), skipping the per-GPU accumulation entirely.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bandwidth_sim import BW_SCALE, _jitter
from repro_torch.core.cluster import Cluster
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.core.tenancy import JobLedger

# Per-host token features.  The paper's tuple is (intra-host bandwidth from
# the Stage-1 lookup, GPU count on that host); we encode the bandwidth in
# log-space (it spans ~2.5 decades across heterogeneous hosts) and append
# two request-context features the dispatcher trivially knows — the host's
# share of the request (n_h/k) and the normalized request size — plus the
# per-host-type normalized bandwidth (see module docstring).
N_FEATURES = 5
_LOG_SCALE = 5.0  # keep in sync with surrogate.LOG_SCALE

# Ledger-context channels appended by the contended featurizer:
#   [segment flag, c_h / C_NORM, contender demand / 8, disjoint occupancy,
#    health degradation (1 - rail degrade factor; 0.0 on healthy fabric)]
# The health channel (failure domain) is exactly 0.0 for every healthy host, and
# the surrogate's ledger-context embedding is zero-initialized, so widening
# it leaves untrained and healthy-fabric predictions bit-identical.
N_LEDGER_FEATURES = 5
N_CONTENDED_FEATURES = N_FEATURES + N_LEDGER_FEATURES
_C_NORM = 4.0  # rail-contender count normalizer

def _host_token(
    cluster: Cluster,
    tables: IntraHostTables,
    hid: int,
    gpus: Sequence[int],
    k: int,
    host_norm: bool,
) -> np.ndarray:
    """The isolated feature tuple of one (host, selected GPUs) token."""
    host_type = cluster.hosts[hid].host_type
    intra = tables.lookup(hid, cluster.local_tuple(hid, gpus))
    out = np.zeros((N_FEATURES,), np.float32)
    out[0] = np.log1p(intra) / _LOG_SCALE
    out[1] = len(gpus) / 8.0
    out[2] = len(gpus) / k
    out[3] = k / max(cluster.n_gpus, 1)
    if host_norm:
        out[4] = (
            np.log1p(intra) - np.log1p(host_type.nic_rail_bw * len(gpus))
        ) / _LOG_SCALE
    return out


def featurize_one(
    cluster: Cluster,
    tables: IntraHostTables,
    subset: Sequence[int],
    max_hosts: int,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (feats [max_hosts, N_FEATURES] float32, mask [max_hosts] float32)."""
    by_host = cluster.partition_by_host(subset)
    if len(by_host) > max_hosts:
        raise ValueError(
            f"subset spans {len(by_host)} hosts > max_hosts={max_hosts}"
        )
    feats = np.zeros((max_hosts, N_FEATURES), np.float32)
    mask = np.zeros((max_hosts,), np.float32)
    k = len(subset)
    for i, (hid, gpus) in enumerate(sorted(by_host.items())):
        feats[i] = _host_token(cluster, tables, hid, gpus, k, host_norm)
        mask[i] = 1.0
    return feats, mask


# ---------------------------------------------------------------------------
# Precomputed host arrays (the vectorized featurizers' lookup substrate)
# ---------------------------------------------------------------------------

class HostArrays:
    """Dense per-GPU / per-host arrays derived once from the Stage-1 tables.

    ``intra_bw[hid, bitmask]`` is the exact Stage-1 lookup value for the
    local subset encoded by ``bitmask`` (NaN for combinations the tables do
    not hold, i.e. the empty mask) — the same float64 objects the dict
    holds, so gathers reproduce ``tables.lookup`` bit-for-bit.
    """

    def __init__(self, cluster: Cluster, tables: IntraHostTables):
        self.cluster = cluster
        n_hosts = cluster.n_hosts
        max_g = max(h.n_gpus for h in cluster.hosts)
        self.max_host_gpus = max_g
        self.gpu_host = np.asarray(cluster.gpu_host, np.int64)
        self.gpu_bit = np.asarray(
            [np.int64(1) << cluster.gpu_local[g] for g in range(cluster.n_gpus)],
            np.int64,
        )
        self.intra_bw = np.full((n_hosts, 1 << max_g), np.nan, np.float64)
        for hid in range(n_hosts):
            for sub, bw in tables.tables[hid].items():
                m = 0
                for i in sub:
                    m |= 1 << i
                self.intra_bw[hid, m] = bw
        self.host_n_gpus = np.asarray(
            [h.n_gpus for h in cluster.hosts], np.int64
        )
        rail = np.asarray(
            [h.host_type.nic_rail_bw for h in cluster.hosts], np.float64
        )
        self.nic_rail_bw = rail
        # log1p(rail_bw * n) for n = 0..max_g (n = 0 is never gathered)
        self.log_rail = np.log1p(
            rail[:, None] * np.arange(max_g + 1, dtype=np.float64)[None, :]
        )
        # ledger uid -> (version, _LedgerArrays): the contended featurizer's
        # per-occupancy-state snapshot, reused across the ~20 predict
        # batches one admission issues against an unchanged ledger.  Bounded:
        # training/dataset paths materialize a FRESH ledger per sample (new
        # uid each), which would otherwise retain dense arrays forever.
        self.ledger_cache: Dict[int, Tuple[int, object]] = {}
        self.max_ledger_entries = 64


def host_arrays(cluster: Cluster, tables: IntraHostTables) -> HostArrays:
    """The (cached) :class:`HostArrays` of one tables instance."""
    arrays = getattr(tables, "_host_arrays", None)
    if arrays is None or arrays.cluster is not cluster:
        arrays = HostArrays(cluster, tables)
        tables._host_arrays = arrays
    return arrays


def _batch_bits_counts(
    arrays: HostArrays, subsets: Sequence[Sequence[int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-(candidate, host) local bitmasks and GPU counts for a batch.

    -> (bits [B, H_all] int64, counts [B, H_all] int64, ks [B] int64,
        rows [sum k] int64, flat [sum k] int64) — ``rows``/``flat`` are the
    flattened (candidate index, GPU id) pairs, reusable by callers needing
    another scatter over the same batch (e.g. busy-GPU overlap counts).
    """
    B = len(subsets)
    n_hosts = len(arrays.host_n_gpus)
    lens = np.asarray([len(s) for s in subsets], np.int64)
    if B:
        flat = np.concatenate(
            [np.asarray(s, np.int64) for s in subsets]
        ) if lens.sum() else np.zeros((0,), np.int64)
    else:
        flat = np.zeros((0,), np.int64)
    rows = np.repeat(np.arange(B, dtype=np.int64), lens)
    hosts = arrays.gpu_host[flat]
    bits = np.zeros((B, n_hosts), np.int64)
    counts = np.zeros((B, n_hosts), np.int64)
    np.add.at(bits, (rows, hosts), arrays.gpu_bit[flat])
    np.add.at(counts, (rows, hosts), 1)
    return bits, counts, lens, rows, flat


def _isolated_channels(
    arrays: HostArrays,
    bits: np.ndarray,
    counts: np.ndarray,
    ks: np.ndarray,
    host_norm: bool,
) -> np.ndarray:
    """[B, H_all, N_FEATURES] float64 token grid (garbage where count==0).

    Channel math is the elementwise float64 program of :func:`_host_token`,
    so a cast to float32 lands on identical bits.
    """
    B, n_hosts = counts.shape
    hid_grid = np.arange(n_hosts, dtype=np.int64)[None, :]
    intra = arrays.intra_bw[hid_grid, bits]            # NaN where count == 0
    with np.errstate(invalid="ignore"):
        log_intra = np.log1p(intra)
        tokens = np.zeros((B, n_hosts, N_FEATURES), np.float64)
        tokens[..., 0] = log_intra / _LOG_SCALE
        tokens[..., 1] = counts / 8.0
        tokens[..., 2] = counts / ks[:, None]
        tokens[..., 3] = (ks / max(arrays.cluster.n_gpus, 1))[:, None]
        if host_norm:
            safe = np.minimum(counts, arrays.max_host_gpus)
            tokens[..., 4] = (
                log_intra - arrays.log_rail[hid_grid, safe]
            ) / _LOG_SCALE
    return tokens


def _pack_tokens(
    tokens: np.ndarray,
    counts: np.ndarray,
    max_hosts: int,
    n_channels: int,
    extra: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter the participating-host rows of a [B, H_all, F] grid into the
    leading token slots of a zero-padded [B, max_hosts, n_channels] batch
    (hosts ascending — the order ``sorted(by_host.items())`` produces)."""
    B = counts.shape[0]
    part = counts > 0
    n_part = part.sum(axis=1)
    if n_part.size and int(n_part.max()) > max_hosts:
        b = int(np.argmax(n_part))
        raise ValueError(
            f"subset spans {int(n_part[b])} hosts > max_tokens={max_hosts}"
            if extra is not None else
            f"subset spans {int(n_part[b])} hosts > max_hosts={max_hosts}"
        )
    feats = np.zeros((B, max_hosts, n_channels), np.float32)
    mask = np.zeros((B, max_hosts), np.float32)
    b_idx, h_idx = np.nonzero(part)
    pos = np.cumsum(part, axis=1)[b_idx, h_idx] - 1
    feats[b_idx, pos, : tokens.shape[-1]] = tokens[b_idx, h_idx]
    if extra is not None:
        feats[b_idx, pos, tokens.shape[-1]:] = extra[b_idx, h_idx]
    mask[b_idx, pos] = 1.0
    return feats, mask


def featurize_batch(
    cluster: Cluster,
    tables: IntraHostTables,
    subsets: Sequence[Sequence[int]],
    max_hosts: int | None = None,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (feats [B, H, F], mask [B, H]) for a batch of allocations.

    Vectorized: one numpy program over the precomputed :func:`host_arrays`,
    bit-identical to :func:`featurize_batch_loop` (regression-pinned).
    """
    if max_hosts is None:
        max_hosts = cluster.n_hosts
    arrays = host_arrays(cluster, tables)
    bits, counts, ks, _, _ = _batch_bits_counts(arrays, subsets)
    tokens = _isolated_channels(arrays, bits, counts, ks, host_norm)
    return _pack_tokens(tokens, counts, max_hosts, N_FEATURES)


def featurize_batch_loop(
    cluster: Cluster,
    tables: IntraHostTables,
    subsets: Sequence[Sequence[int]],
    max_hosts: int | None = None,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Legacy per-candidate loop featurizer (the vectorized path's bit-
    identity reference and the throughput bench's before-side)."""
    if max_hosts is None:
        max_hosts = cluster.n_hosts
    B = len(subsets)
    feats = np.zeros((B, max_hosts, N_FEATURES), np.float32)
    mask = np.zeros((B, max_hosts), np.float32)
    for b, subset in enumerate(subsets):
        feats[b], mask[b] = featurize_one(
            cluster, tables, subset, max_hosts, host_norm=host_norm
        )
    return feats, mask


def child_bits_counts(
    arrays: HostArrays, parent: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(child, host) local bitmasks and GPU counts for every single-GPU
    elimination of ``parent`` (child i = parent minus its i-th element).

    THE incremental child-patching step: the parent's grids repeated, with
    one (host, bit) subtraction per child.  Shared by
    :func:`featurize_children` and ``SurrogatePredictor.predict_children``
    so the two can never drift apart on the bit-identity contract.
    """
    parent = list(parent)
    n = len(parent)
    if n < 2:
        raise ValueError("parent needs >=2 GPUs to have elimination children")
    pbits, pcounts, _, _, flat = _batch_bits_counts(arrays, [parent])
    hosts = arrays.gpu_host[flat]                      # host of each element
    bits = np.repeat(pbits, n, axis=0)                 # [n, H_all]
    counts = np.repeat(pcounts, n, axis=0)
    child_idx = np.arange(n)
    bits[child_idx, hosts] -= arrays.gpu_bit[flat]
    counts[child_idx, hosts] -= 1
    return bits, counts


def featurize_children(
    cluster: Cluster,
    tables: IntraHostTables,
    parent: Sequence[int],
    max_hosts: int | None = None,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Featurize every single-GPU elimination of ``parent`` (the PTS round).

    Child i is ``parent`` minus its i-th element (parent order).  A child
    differs from its parent in exactly one host token — plus the two cheap
    k-dependent request-context channels — so the whole [|S|, H, F] round
    batch is assembled from the parent's per-host grids with one patched
    (host, bitmask) gather per child, skipping the per-GPU accumulation of
    :func:`featurize_batch`.  Bit-identical to featurizing the children
    list directly (regression-pinned).
    """
    if max_hosts is None:
        max_hosts = cluster.n_hosts
    arrays = host_arrays(cluster, tables)
    bits, counts = child_bits_counts(arrays, parent)
    n = bits.shape[0]
    ks = np.full((n,), n - 1, np.int64)
    tokens = _isolated_channels(arrays, bits, counts, ks, host_norm)
    return _pack_tokens(tokens, counts, max_hosts, N_FEATURES)


# ---------------------------------------------------------------------------
# Contended featurization: (subset, ledger) -> tokens with context channels
# ---------------------------------------------------------------------------

def default_max_tokens(cluster: Cluster) -> int:
    """Token budget for the contended featurizer: every candidate host plus
    up to two contender tokens per host (overflow is truncated; the count
    and demand *channels* still carry the dropped contenders)."""
    return 3 * cluster.n_hosts


def featurize_contended_one(
    cluster: Cluster,
    tables: IntraHostTables,
    subset: Sequence[int],
    ledger: Optional[JobLedger],
    max_tokens: int,
    include_contenders: bool = True,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (feats [max_tokens, N_CONTENDED_FEATURES], mask [max_tokens]).

    Candidate host tokens come first (segment flag 0) with their isolated
    channels computed by the *same* code path as :func:`featurize_one`;
    contender tokens (one per contending job per shared host, segment flag
    1) follow in deterministic (host, job id) order and are truncated at
    ``max_tokens``.
    """
    by_host = cluster.partition_by_host(subset)
    feats = np.zeros((max_tokens, N_CONTENDED_FEATURES), np.float32)
    mask = np.zeros((max_tokens,), np.float32)
    k = len(subset)
    sset = set(subset)
    busy = ledger.busy() if ledger is not None else set()

    hosts = sorted(by_host.items())
    if len(hosts) > max_tokens:
        raise ValueError(
            f"subset spans {len(hosts)} hosts > max_tokens={max_tokens}"
        )
    # One ledger traversal per host: the contender jobs drive both the
    # context channels and the contender tokens (this is the hot path —
    # learned-mode search featurizes hundreds of candidates per admission).
    jobs_by_host = {
        hid: (
            ledger.cross_host_jobs_on(hid, against=subset)
            if ledger is not None else []
        )
        for hid, _ in hosts
    }
    hd = (
        ledger.host_degrade
        if ledger is not None and getattr(ledger, "health_active", False)
        else None
    )
    ctx_by_host = {}
    for hid, _ in hosts:
        jobs = jobs_by_host[hid]
        host = cluster.hosts[hid]
        on_host = {
            a.job_id: [g for g in a.gpus if cluster.gpu_host[g] == hid]
            for a in jobs
        }
        occ = sum(
            1 for g in host.gpu_ids if g in busy and g not in sset
        ) / host.n_gpus if ledger is not None else 0.0
        demand = sum(len(g) for g in on_host.values())
        health = 1.0 - hd(hid) if hd is not None else 0.0
        ctx_by_host[hid] = (len(jobs) / _C_NORM, demand / 8.0, occ, health)
        jobs_by_host[hid] = [(a, on_host[a.job_id]) for a in jobs]
    for i, (hid, gpus) in enumerate(hosts):
        feats[i, :N_FEATURES] = _host_token(
            cluster, tables, hid, gpus, k, host_norm
        )
        feats[i, N_FEATURES + 1:] = ctx_by_host[hid]  # segment stays 0
        mask[i] = 1.0
    n = len(hosts)
    if include_contenders and ledger is not None and len(hosts) > 1:
        for hid, _ in hosts:
            for alloc, on_host in jobs_by_host[hid]:
                if n >= max_tokens:
                    return feats, mask  # truncate; channels keep the counts
                feats[n, :N_FEATURES] = _host_token(
                    cluster, tables, hid, on_host, alloc.k, host_norm
                )
                feats[n, N_FEATURES] = 1.0  # segment: contender token
                feats[n, N_FEATURES + 1:] = ctx_by_host[hid]
                mask[n] = 1.0
                n += 1
    return feats, mask


class _LedgerArrays:
    """Per-ledger dense view the vectorized contended featurizer consumes:
    cross-host allocations as membership masks and per-host GPU demands."""

    def __init__(self, cluster: Cluster, arrays: HostArrays, ledger: JobLedger):
        n_hosts = cluster.n_hosts
        cross = ledger.cross_jobs_by_host()
        order: Dict[str, int] = {}
        allocs = []
        for hid in sorted(cross):
            for a in cross[hid]:         # already sorted by job id per host
                if a.job_id not in order:
                    order[a.job_id] = len(allocs)
                    allocs.append(a)
        nJ = len(allocs)
        self.allocs = allocs
        self.occ = np.zeros((nJ, cluster.n_gpus), np.int64)
        self.onhost_count = np.zeros((nJ, n_hosts), np.int64)
        self.onhost_bits = np.zeros((nJ, n_hosts), np.int64)
        self.alloc_k = np.asarray([a.k for a in allocs], np.int64)
        for j, a in enumerate(allocs):
            gs = np.asarray(a.gpus, np.int64)
            self.occ[j, gs] = 1
            np.add.at(self.onhost_count[j], arrays.gpu_host[gs], 1)
            np.add.at(self.onhost_bits[j], arrays.gpu_host[gs],
                      arrays.gpu_bit[gs])
        # host -> contender indices in job-id order (cross_host_jobs_on order)
        self.jobs_on_host: List[List[int]] = [
            sorted(
                (j for j in range(nJ) if self.onhost_count[j, hid] > 0),
                key=lambda j: allocs[j].job_id,
            )
            for hid in range(n_hosts)
        ]
        busy = np.zeros((cluster.n_gpus,), np.int64)
        for g in ledger.busy():
            busy[g] = 1
        self.busy = busy
        self.busy_per_host = np.zeros((n_hosts,), np.int64)
        np.add.at(self.busy_per_host, arrays.gpu_host[busy.nonzero()[0]], 1)


def _contender_token_rows(
    arrays: HostArrays, led: "_LedgerArrays", host_norm: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Base features of every (contender job, host) token, plus the dense
    (job, host) -> row index map (-1 where the job has no GPUs there)."""
    j_idx, h_idx = np.nonzero(led.onhost_count)
    cnt = led.onhost_count[j_idx, h_idx]
    intra = arrays.intra_bw[h_idx, led.onhost_bits[j_idx, h_idx]]
    log_intra = np.log1p(intra)
    kj = led.alloc_k[j_idx]
    rowsf = np.zeros((len(j_idx), N_FEATURES), np.float64)
    rowsf[:, 0] = log_intra / _LOG_SCALE
    rowsf[:, 1] = cnt / 8.0
    rowsf[:, 2] = cnt / kj
    rowsf[:, 3] = kj / max(arrays.cluster.n_gpus, 1)
    if host_norm:
        rowsf[:, 4] = (log_intra - arrays.log_rail[h_idx, cnt]) / _LOG_SCALE
    index = np.full(led.onhost_count.shape, -1, np.int64)
    index[j_idx, h_idx] = np.arange(len(j_idx))
    return rowsf.astype(np.float32), index


def _featurize_contended_group(
    cluster: Cluster,
    arrays: HostArrays,
    ledger: Optional[JobLedger],
    subsets: Sequence[Sequence[int]],
    max_tokens: int,
    include_contenders: bool,
    host_norm: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized contended featurization of one ledger's candidate batch."""
    B = len(subsets)
    bits, counts, ks, rows, flat = _batch_bits_counts(arrays, subsets)
    tokens = _isolated_channels(arrays, bits, counts, ks, host_norm)
    n_hosts = counts.shape[1]
    if ledger is None or len(ledger) == 0:
        ctx = np.zeros((B, n_hosts, N_LEDGER_FEATURES), np.float64)
        led = None
        disjoint = None
    else:
        cached = arrays.ledger_cache.get(ledger.uid)
        if cached is not None and cached[0] == ledger.version:
            led = cached[1]
        else:
            led = _LedgerArrays(cluster, arrays, ledger)
            if len(arrays.ledger_cache) >= arrays.max_ledger_entries:
                # oldest-first eviction (insertion order): single-use
                # ledgers from dataset generation must not accumulate.
                # pop() tolerates a concurrent joint-order thread having
                # already evicted the same uid.
                for uid in list(arrays.ledger_cache)[
                        : arrays.max_ledger_entries // 2]:
                    arrays.ledger_cache.pop(uid, None)
            arrays.ledger_cache[ledger.uid] = (ledger.version, led)
        M = np.zeros((B, cluster.n_gpus), np.int64)
        M[rows, flat] = 1
        disjoint = (M @ led.occ.T) == 0 if led.occ.shape[0] else \
            np.zeros((B, 0), bool)
        dj = disjoint.astype(np.int64)
        c = dj @ (led.onhost_count > 0).astype(np.int64)      # [B, H_all]
        demand = dj @ led.onhost_count
        overlap = np.zeros((B, n_hosts), np.int64)
        np.add.at(overlap, (rows, arrays.gpu_host[flat]), led.busy[flat])
        occ = (led.busy_per_host[None, :] - overlap) / arrays.host_n_gpus
        ctx = np.zeros((B, n_hosts, N_LEDGER_FEATURES), np.float64)
        ctx[..., 1] = c / _C_NORM
        ctx[..., 2] = demand / 8.0
        ctx[..., 3] = occ
    # Health channel — filled in BOTH branches (a degraded-but-empty ledger
    # must still expose its perturbed fabric, or the loop and vectorized
    # paths would diverge).
    if ledger is not None and getattr(ledger, "health_active", False):
        degv = np.asarray(
            [ledger.host_degrade(h.host_id) for h in cluster.hosts],
            np.float64,
        )
        ctx[..., 4] = (1.0 - degv)[None, :]
    feats, mask = _pack_tokens(
        tokens, counts, max_tokens, N_CONTENDED_FEATURES, extra=ctx
    )
    if led is None or not include_contenders or not led.allocs:
        return feats, mask
    # Contender tokens: per candidate, (host ascending, job id ascending),
    # truncated at max_tokens — all feature math precomputed above; the
    # remaining per-candidate work is index assembly over <= max_tokens rows.
    memo = getattr(led, "ctok_memo", None)
    if memo is None:
        memo = led.ctok_memo = {}
    if host_norm not in memo:
        memo[host_norm] = _contender_token_rows(arrays, led, host_norm)
    ctok, index = memo[host_norm]
    ctx32 = ctx.astype(np.float32)
    part = counts > 0
    for b in range(B):
        hids = np.nonzero(part[b])[0]
        if len(hids) <= 1:
            continue
        n = len(hids)
        for hid in hids:
            for j in led.jobs_on_host[hid]:
                if not disjoint[b, j]:
                    continue
                if n >= max_tokens:
                    break
                feats[b, n, :N_FEATURES] = ctok[index[j, hid]]
                feats[b, n, N_FEATURES] = 1.0
                feats[b, n, N_FEATURES + 1:] = ctx32[b, hid, 1:]
                mask[b, n] = 1.0
                n += 1
            if n >= max_tokens:
                break
    return feats, mask


def featurize_contended_batch(
    cluster: Cluster,
    tables: IntraHostTables,
    pairs: Sequence[Tuple[Sequence[int], Optional[JobLedger]]],
    max_tokens: Optional[int] = None,
    include_contenders: bool = True,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (feats [B, T, N_CONTENDED_FEATURES], mask [B, T]) for a batch of
    (subset, ledger) pairs; ``ledger=None`` means isolated.

    Vectorized per ledger group: the search path (every pair sharing one
    live ledger) runs as a single array program; mixed-ledger training
    batches fall back to per-group programs.  Bit-identical to
    :func:`featurize_contended_batch_loop` (regression-pinned).
    """
    if max_tokens is None:
        max_tokens = default_max_tokens(cluster)
    arrays = host_arrays(cluster, tables)
    B = len(pairs)
    feats = np.zeros((B, max_tokens, N_CONTENDED_FEATURES), np.float32)
    mask = np.zeros((B, max_tokens), np.float32)
    groups: Dict[int, List[int]] = {}
    ledgers: Dict[int, Optional[JobLedger]] = {}
    for i, (_, ledger) in enumerate(pairs):
        key = id(ledger) if ledger is not None else -1
        groups.setdefault(key, []).append(i)
        ledgers[key] = ledger
    for key, idx in groups.items():
        f, m = _featurize_contended_group(
            cluster, arrays, ledgers[key], [pairs[i][0] for i in idx],
            max_tokens, include_contenders, host_norm,
        )
        feats[idx] = f
        mask[idx] = m
    return feats, mask


def featurize_contended_batch_loop(
    cluster: Cluster,
    tables: IntraHostTables,
    pairs: Sequence[Tuple[Sequence[int], Optional[JobLedger]]],
    max_tokens: Optional[int] = None,
    include_contenders: bool = True,
    host_norm: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Legacy per-pair loop featurizer (bit-identity reference)."""
    if max_tokens is None:
        max_tokens = default_max_tokens(cluster)
    B = len(pairs)
    feats = np.zeros((B, max_tokens, N_CONTENDED_FEATURES), np.float32)
    mask = np.zeros((B, max_tokens), np.float32)
    for b, (subset, ledger) in enumerate(pairs):
        feats[b], mask[b] = featurize_contended_one(
            cluster, tables, subset, ledger, max_tokens,
            include_contenders=include_contenders, host_norm=host_norm,
        )
    return feats, mask


# ---------------------------------------------------------------------------
# Device tables: the on-device elimination scan's gather substrate
# ---------------------------------------------------------------------------

class _CapLattice:
    """Geometry of the per-host GPU-count lattice the analytic contention
    cap is tabulated over (see :class:`DeviceTables`)."""

    def __init__(self, counts, part, n_part, ks, jitter):
        self.counts = counts    # [L, H_all] int64 per-host count vectors
        self.part = part        # [L, H_all] bool  count > 0
        self.n_part = n_part    # [L] participating-host count
        self.ks = ks            # [L] subset size
        self.jitter = jitter    # [L] deterministic fabric jitter factor


class DeviceTables:
    """Float32 gather tables for the fused on-device PTS scan.

    The scan body re-expresses :func:`featurize_children` as pure gathers:
    channels 0 and 4 of a token depend only on ``(host, local bitmask)``, so
    both are precomputed here as ``[H_all, 2**max_g]`` tables — evaluated in
    the *same float64 program* as :func:`_isolated_channels` and cast to
    float32 once, so a device gather lands on exactly
    ``np.float32(host-path value)``.  ``stage1`` is the raw Stage-1 lookup
    (the single-host dispatch branch).

    For the analytic contention cap, observe that once the candidate is
    GPU-disjoint from every live job (always true for PTS over free GPUs),
    the cap depends only on the candidate's per-host GPU-count vector.
    Those vectors live on a mixed-radix lattice (radix ``n_gpus_h + 1`` per
    host, |L| = 6561 on the paper's 4x8 clusters), so any ledger's cap
    function is a ``[L]`` table built in microseconds of numpy
    (:meth:`cap_lattice` holds the ledger-independent geometry and the
    per-point fabric jitter, computed once per cluster).
    """

    def __init__(self, cluster: Cluster, tables: IntraHostTables):
        self.cluster = cluster
        arrays = host_arrays(cluster, tables)
        self.arrays = arrays
        n_hosts = cluster.n_hosts
        max_g = arrays.max_host_gpus
        W = 1 << max_g
        self.mask_size = W
        with np.errstate(invalid="ignore"):
            log_intra = np.log1p(arrays.intra_bw)          # [H, W], NaN at 0
            self.tok0 = (log_intra / _LOG_SCALE).astype(np.float32)
            pop = np.asarray(
                [bin(m).count("1") for m in range(W)], np.int64
            )
            safe = np.minimum(pop, max_g)
            self.tok4 = (
                (log_intra - arrays.log_rail[:, safe]) / _LOG_SCALE
            ).astype(np.float32)
        self.tok4_zero = np.zeros_like(self.tok4)          # host_norm=False
        self.stage1 = arrays.intra_bw.astype(np.float32)   # [H, W]
        self.rail_bw = arrays.nic_rail_bw                  # [H] float64
        radix = arrays.host_n_gpus + 1
        strides = np.ones((n_hosts,), np.int64)
        for h in range(1, n_hosts):
            strides[h] = strides[h - 1] * radix[h - 1]
        self.strides = strides
        self.lattice_size = int(strides[-1] * radix[-1])
        self.n_gpus_f = np.float32(max(cluster.n_gpus, 1))
        self._lattice: Optional[_CapLattice] = None
        self._caps_inf: Optional[np.ndarray] = None

    def cap_lattice(self) -> _CapLattice:
        """Lazy per-cluster lattice geometry + per-point fabric jitter.

        The jitter key of an inter-host candidate is its sorted
        ``(host, count)`` participation tuple — a pure function of the
        lattice point and the cluster name, never of the ledger — so it is
        evaluated once here and reused by every per-ledger cap table."""
        if self._lattice is None:
            L = self.lattice_size
            n_hosts = len(self.strides)
            radix = self.arrays.host_n_gpus + 1
            idx = np.arange(L, dtype=np.int64)
            counts = np.stack(
                [(idx // self.strides[h]) % radix[h] for h in range(n_hosts)],
                axis=1,
            )
            part = counts > 0
            n_part = part.sum(axis=1)
            ks = counts.sum(axis=1)
            jitter = np.ones((L,), np.float64)
            name = self.cluster.name
            for i in np.nonzero(n_part > 1)[0]:
                key = tuple(
                    (int(h), int(counts[i, h]))
                    for h in np.nonzero(part[i])[0]
                )
                jitter[i] = _jitter(name, "inter", key)
            self._lattice = _CapLattice(counts, part, n_part, ks, jitter)
        return self._lattice

    def caps_inf(self) -> np.ndarray:
        """The capless (isolated / empty-ledger) cap table: all +inf."""
        if self._caps_inf is None:
            self._caps_inf = np.full(
                (self.lattice_size,), np.inf, np.float32
            )
        return self._caps_inf


def device_tables(cluster: Cluster, tables: IntraHostTables) -> DeviceTables:
    """The (cached) :class:`DeviceTables` of one tables instance."""
    dt = getattr(tables, "_device_tables", None)
    if dt is None or dt.cluster is not cluster:
        dt = DeviceTables(cluster, tables)
        tables._device_tables = dt
    return dt


def featurize_gpu_ids(
    cluster: Cluster, subsets: Sequence[Sequence[int]], max_k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Raw-identifier featurization for the *naive* baseline (Sec. 5.5.1):
    one token per GPU, feature = global GPU id (embedded by the model).
    -> (ids [B, max_k] int32, mask [B, max_k])."""
    B = len(subsets)
    ids = np.zeros((B, max_k), np.int32)
    mask = np.zeros((B, max_k), np.float32)
    for b, subset in enumerate(subsets):
        for i, g in enumerate(sorted(subset)):
            ids[b, i] = g
            mask[b, i] = 1.0
    return ids, mask
