"""Surrogate training: offline initialization + online adaptation (Sec. 4.1.2),
the port of ``repro/core/training.py``.

The paper trains the hierarchical Transformer on a deliberately sparse set of
inter-host measurements (250 samples in the headline results) and keeps it
fresh by fine-tuning on bandwidths observed from live jobs.  Both paths share
one AdamW loop (``repro_torch.train.optimizer``, shared with the LM trainer
as in the reference).

The learned-contention subsystem adds a third trainee: the
**ContendedSurrogate** (`train_contended_surrogate`), fitted on (subset,
ledger, contended-bandwidth) triples — synthetic ones from
:mod:`repro_torch.core.contended_dataset` or live ones from its telemetry
harvester (`online_finetune_contended`).  The curriculum mixes isolated
(empty-ledger) and contended samples so the model keeps its isolated
accuracy while absorbing the rail split.

Training runs on the card unless the caller passes ``device="cpu"``; the
fine-tunes run where the given parameters live. A trainer returns a new
model and leaves the one it started from as it was. Minibatch indices come
from the reference's numpy stream (``default_rng(seed).integers`` per
step), so a port run and a reference run from the same weights see the same
batches; random inits are drawn on the CPU from ``torch.Generator(seed)``,
so they are the same on every device.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import features as feat_lib
from repro_torch.core import surrogate as surr
from repro_torch.core.bandwidth_sim import BandwidthSimulator
from repro_torch.core.cluster import Cluster
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.optimizer import AdamWConfig, adamw, cosine_schedule

# One contended-training sample: (subset, ledger-or-None, bandwidth GB/s).
# ``ledger`` duck-types JobLedger (the featurizer reads contender_demands /
# cross_host_jobs_on / busy); None means isolated.
ContendedTriple = Tuple[Sequence[int], Any, float]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 3000
    batch_size: int = 64
    lr: float = 3e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    seed: int = 0
    log_every: int = 0  # 0 = silent


def _mse_loss(apply_fn, params, x, mask, y):
    pred = apply_fn(params, x, mask)
    return torch.mean(torch.square(pred - y))


def _fit(
    apply_fn,
    params: surr.Surrogate,
    x: torch.Tensor,
    mask: torch.Tensor,
    targets: torch.Tensor,
    config: TrainConfig,
) -> Tuple[surr.Surrogate, Dict[str, Any]]:
    """The shared AdamW loop: minibatch MSE on normalized log-bandwidth.

    Trains a copy of ``params`` on the device of ``x`` (``mask`` and
    ``targets`` lie there too). ``info["loss_curve"]`` holds every step's
    loss; the host reads the losses once, after the last step."""
    params = copy.deepcopy(params).to(x.device).requires_grad_(True)
    named = dict(params.named_parameters())
    n = int(x.shape[0])
    opt_cfg = AdamWConfig(
        lr=config.lr, weight_decay=config.weight_decay, grad_clip_norm=1.0
    )
    opt_init, opt_update = adamw(
        opt_cfg, cosine_schedule(config.steps, config.warmup_steps)
    )
    opt_state = opt_init(named)

    # the reference's stream, one draw per step, uploaded in one copy
    rng = np.random.default_rng(config.seed)
    bs = min(config.batch_size, n)
    idx_all = np.zeros((config.steps, bs), np.int64)
    for i in range(config.steps):
        idx_all[i] = rng.integers(0, n, size=bs)
    idx_all = torch.from_numpy(idx_all).to(x.device)
    t0 = time.time()
    losses: List[torch.Tensor] = []
    for i in range(config.steps):
        idx = idx_all[i]
        loss = _mse_loss(apply_fn, params, x[idx], mask[idx], targets[idx])
        grads = torch.autograd.grad(loss, list(named.values()))
        _, opt_state, _ = opt_update(dict(zip(named, grads)), opt_state, named)
        losses.append(loss.detach())
        if config.log_every and (i + 1) % config.log_every == 0:
            print(f"  surrogate step {i + 1}/{config.steps} loss={float(loss):.5f}")
    curve = torch.stack(losses).cpu().numpy() if losses else np.zeros((0,), np.float32)
    params.requires_grad_(False)
    info = {
        "train_seconds": time.time() - t0,
        "final_loss": float(curve[-1]) if len(curve) else float("inf"),
        "n_samples": n,
        "param_bytes": surr.param_bytes(params),
        "loss_curve": curve,
    }
    return params, info


def _on(device: torch.device, *arrays) -> List[torch.Tensor]:
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def train_surrogate(
    cluster: Cluster,
    tables: IntraHostTables,
    dataset: Sequence[Tuple[Sequence[int], float]],
    config: TrainConfig = TrainConfig(),
    naive: bool = False,
    init_params: Optional[surr.Surrogate] = None,
    host_norm: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[surr.Surrogate, Dict[str, Any]]:
    """Train hierarchical (or naive) surrogate on (allocation, bandwidth) pairs.

    Returns (params, info) where info records wall time and final loss.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    subsets = [list(s) for s, _ in dataset]
    targets = surr.encode_bw(
        np.asarray([bw for _, bw in dataset], np.float32)
    ).numpy()

    if naive:
        x, mask = feat_lib.featurize_gpu_ids(cluster, subsets, cluster.n_gpus)
        apply_fn = surr.apply_naive
        params = init_params or surr.init_naive_params(gen, cluster.n_gpus, device=dev)
    else:
        x, mask = feat_lib.featurize_batch(
            cluster, tables, subsets, host_norm=host_norm
        )
        apply_fn = surr.apply_hierarchical
        params = init_params or surr.init_hierarchical_params(gen, device=dev)

    return _fit(apply_fn, params, *_on(dev, x, mask, targets), config)


def online_finetune(
    cluster: Cluster,
    tables: IntraHostTables,
    params: surr.Surrogate,
    new_measurements: Sequence[Tuple[Sequence[int], float]],
    steps: int = 200,
    lr: float = 5e-4,
    seed: int = 1,
) -> surr.Surrogate:
    """Online adaptation: a few low-LR steps on freshly observed bandwidths
    (Sec. 4.2.2), where ``params`` live.  No architecture change, no full
    retraining."""
    cfg = TrainConfig(steps=steps, lr=lr, warmup_steps=0, seed=seed)
    params, _ = train_surrogate(
        cluster, tables, new_measurements, cfg, init_params=params,
        device=params.device,
    )
    return params


# ---------------------------------------------------------------------------
# ContendedSurrogate training (the learned-contention subsystem)
# ---------------------------------------------------------------------------

def train_contended_surrogate(
    cluster: Cluster,
    tables: IntraHostTables,
    dataset: Sequence[ContendedTriple],
    config: TrainConfig = TrainConfig(),
    base_params: Optional[surr.Surrogate] = None,
    init_params: Optional[surr.Surrogate] = None,
    include_contenders: bool = True,
    max_tokens: Optional[int] = None,
    host_norm: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[surr.Surrogate, Dict[str, Any]]:
    """Fit the ContendedSurrogate on (subset, ledger, bandwidth) triples.

    ``base_params`` (the trained isolated surrogate) warm-starts the trunk;
    without it a fresh isolated init is used.  ``init_params`` resumes an
    existing contended model (the online fine-tune path).  The dataset is
    the curriculum: :func:`repro_torch.core.contended_dataset.build_contended_dataset`
    mixes isolated (empty-ledger) and contended samples so the model's
    zero-context behaviour stays anchored to the isolated one.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    pairs = [(list(s), led) for s, led, _ in dataset]
    targets = surr.encode_bw(
        np.asarray([bw for _, _, bw in dataset], np.float32)
    ).numpy()
    x, mask = feat_lib.featurize_contended_batch(
        cluster, tables, pairs, max_tokens=max_tokens,
        include_contenders=include_contenders, host_norm=host_norm,
    )
    if init_params is None:
        init_params = surr.init_contended_params(
            base_params
            if base_params is not None
            else surr.init_hierarchical_params(gen, device=dev)
        )
    return _fit(surr.apply_contended, init_params, *_on(dev, x, mask, targets), config)


def online_finetune_contended(
    cluster: Cluster,
    tables: IntraHostTables,
    params: surr.Surrogate,
    new_samples: Sequence[ContendedTriple],
    steps: int = 200,
    lr: float = 5e-4,
    seed: int = 1,
    **featurize_kwargs,
) -> surr.Surrogate:
    """Online adaptation under tenancy: a few low-LR steps on contended
    bandwidths harvested from live admissions (telemetry harvester), where
    ``params`` live."""
    cfg = TrainConfig(steps=steps, lr=lr, warmup_steps=0, seed=seed)
    params, _ = train_contended_surrogate(
        cluster, tables, new_samples, cfg, init_params=params,
        device=params.device, **featurize_kwargs,
    )
    return params


# ---------------------------------------------------------------------------
# Accuracy metrics (Sec. 5.2): R^2 and MAPE
# ---------------------------------------------------------------------------

def _accuracy(y: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    resid = y - pred
    ss_res = float(np.sum(resid**2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    mape = float(np.mean(np.abs(resid) / np.maximum(np.abs(y), 1e-9))) * 100.0
    return {"r2": r2, "mape": mape, "n": len(y)}


def evaluate_surrogate(
    predictor: "surr.SurrogatePredictor",
    dataset: Sequence[Tuple[Sequence[int], float]],
) -> Dict[str, float]:
    subsets = [list(s) for s, _ in dataset]
    y = np.asarray([bw for _, bw in dataset], np.float64)
    return _accuracy(y, predictor.predict(subsets))


def evaluate_contended_predictor(
    predictor,
    dataset: Sequence[ContendedTriple],
) -> Dict[str, float]:
    """R^2 / MAPE of a contended predictor over (subset, ledger, bw)
    triples.  ``predictor`` must expose ``predict_pairs`` (the
    ContendedSurrogate): each sample is scored against its *own* ledger.
    For the analytic even-split baseline use :func:`evaluate_analytic_cap`
    — a plain ``predict(subsets)`` wrapper reads only the single ledger it
    wraps and would silently mis-score a per-sample-ledger dataset."""
    if not hasattr(predictor, "predict_pairs"):
        raise TypeError(
            "evaluate_contended_predictor needs a predict_pairs predictor; "
            "for the analytic cap baseline use evaluate_analytic_cap"
        )
    y = np.asarray([bw for _, _, bw in dataset], np.float64)
    pred = predictor.predict_pairs([(list(s), led) for s, led, _ in dataset])
    return _accuracy(y, np.asarray(pred, np.float64))


def evaluate_analytic_cap(
    cluster: Cluster,
    base_predictor,
    dataset: Sequence[ContendedTriple],
) -> Tuple[np.ndarray, Dict[str, float]]:
    """The analytic baseline over (subset, ledger, bw) triples:
    ``min(B̂_iso(S), even-split cap(S, L))`` with each sample's own ledger.
    One batched isolated predict; the caps are closed-form (no model
    calls).  Returns (predictions, accuracy dict)."""
    from repro_torch.core.contention import contended_inter_cap

    subsets = [list(s) for s, _, _ in dataset]
    preds = np.asarray(base_predictor.predict(subsets), np.float64).copy()
    for i, (s, ledger, _) in enumerate(dataset):
        if ledger is not None and len(ledger) > 0:
            cap = contended_inter_cap(cluster, ledger, s)
            if cap < preds[i]:
                preds[i] = cap
    y = np.asarray([bw for _, _, bw in dataset], np.float64)
    return preds, _accuracy(y, preds)


def make_train_test_split(
    sim: BandwidthSimulator,
    n_train: int,
    test_mult: int = 5,
    seed: int = 0,
) -> Tuple[List, List]:
    """Paper protocol: test set is 5x the training set, all inter-host, and
    disjoint from the training allocations."""
    rng = np.random.default_rng(seed)
    total = sim.build_dataset(n_train * (test_mult + 1), rng, noisy=True)
    train = total[:n_train]
    # test targets are *noiseless* ground truth: we grade the model against
    # reality, not against one noisy measurement of it.
    test = [(s, sim.true_bandwidth(s)) for s, _ in total[n_train:]]
    return train, test
