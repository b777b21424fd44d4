"""Training step factory + loop.

Counterpart of ``repro/train/train_loop.py``. ``make_train_step`` builds
(lm, opt_state, batch) -> (lm, opt_state, metrics): the forward in
``compute_dtype`` over fp32 master parameters (bf16 by default), remat-able
layer groups, AdamW with global-norm clipping, and optional gradient
accumulation over equal slices of the batch. Parameters are made trainable
here (``requires_grad_``); serving never needs their gradients.

``TrainRunConfig`` has the reference's fields except ``kernel_backend`` and
``scan_unroll``, which are XLA knobs: the port picks its kernels by device
(``ops.py`` of each kernel) and runs eagerly.

With a :class:`~repro_torch.parallel.fsdp.ShardedModel` for ``model`` the
same step trains an LM whose parameters are DTensors on a mesh
(``parallel/fsdp.py``): the model's loss splits the batch, gathers the
weights and averages the loss over the global batch, and the gradients come
back from autograd already reduced to each parameter's placement.

``REPRO_GRAD_SYNC_BF16=1`` round-trips the gradients through bf16 before
the optimizer, as the reference does (on a mesh, the reduced gradients).
The reference's other cross-shard knobs
(``REPRO_CAST_BARRIER``, ``REPRO_SP_GATHER``) come with tensor-parallel
compute (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import LM
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw, cosine_schedule

Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainRunConfig:
    optimizer: AdamWConfig = AdamWConfig(lr=3e-4, weight_decay=0.1)
    total_steps: int = 1000
    warmup_steps: int = 100
    remat_policy: Optional[str] = "nothing"
    compute_dtype: Optional[torch.dtype] = torch.bfloat16
    grad_accum: int = 1


def _on_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model: Union[Model, ShardedModel], run: TrainRunConfig
                    ) -> Tuple[Callable, Callable[[LM], AdamWState]]:
    """Returns (train_step, opt_init)."""
    init, update = adamw(run.optimizer, cosine_schedule(run.total_steps, run.warmup_steps))
    grad_sync_bf16 = os.environ.get("REPRO_GRAD_SYNC_BF16", "0") == "1"

    def opt_init(lm: LM) -> AdamWState:
        return init(dict(lm.named_parameters()))

    def loss_and_grads(lm: LM, params, batch):
        loss, metrics = model.loss(lm, batch, remat_policy=run.remat_policy,
                                   compute_dtype=run.compute_dtype)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def train_step(lm: LM, opt_state: AdamWState, batch: Batch):
        lm.requires_grad_(True)
        params = dict(lm.named_parameters())
        batch = _on_device(batch, next(iter(params.values())).device)
        n = run.grad_accum
        if n > 1:
            # equal slices of the batch's leading dim; losses and gradients
            # summed, then divided by n
            size = next(iter(batch.values())).shape[0] // n
            loss, grads = None, None
            for i in range(n):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_i, _, g_i = loss_and_grads(lm, params, mb)
                if grads is None:
                    loss, grads = l_i, g_i
                else:
                    loss = loss + l_i
                    for name, g in g_i.items():
                        grads[name].add_(g)
                del g_i
            for g in grads.values():
                g.div_(n)
            loss = loss / n
            metrics = {"xent": loss}
        else:
            loss, metrics, grads = loss_and_grads(lm, params, batch)
        if grad_sync_bf16:
            for g in grads.values():
                g.copy_(g.to(torch.bfloat16))
        _, opt_state, om = update(grads, opt_state, params)
        return lm, opt_state, {"loss": loss, **metrics, **om}

    return train_step, opt_init


def train_loop(model: Model, params: LM, batches: Iterable[Batch], run: TrainRunConfig,
               *, log_every: int = 10, checkpointer=None, checkpoint_every: int = 0,
               start_step: int = 0, opt_state: Optional[AdamWState] = None
               ) -> Tuple[LM, AdamWState, List[dict]]:
    """Single-process training loop; ``params`` (the LM) is trained in place."""
    train_step, opt_init = make_train_step(model, run)
    if opt_state is None:
        opt_state = opt_init(params)
    history = []
    t0 = time.time()
    for step, batch in enumerate(batches, start=start_step):
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if log_every and (step + 1) % log_every == 0:
            loss = float(metrics["loss"])  # waits for the step to finish
            dt = (time.time() - t0) / log_every
            history.append({"step": step + 1, "loss": loss, "s_per_step": dt})
            print(f"step {step + 1}: loss={loss:.4f} ({dt:.2f}s/step)")
            t0 = time.time()
        if checkpointer and checkpoint_every and (step + 1) % checkpoint_every == 0:
            checkpointer.save(step + 1, {"params": params, "opt": opt_state})
    return params, opt_state, history
