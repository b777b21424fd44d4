"""AdamW, global-norm clipping and learning-rate schedules.

Counterpart of ``repro/train/optimizer.py``, which the LM trainer and the
dispatcher's surrogate trainer share. Parameters, gradients and moments are
dicts of tensors keyed by state-dict names; the update writes the
parameters and moments in place under ``torch.no_grad()``.

Not ``torch.optim.AdamW``: the reference's semantics differ from it in three
places, and the port keeps the reference's:
  * weight decay is added to the step inside ``lr`` (``delta + wd * p``), on
    every parameter, norms and biases included;
  * the clip divides by ``norm + 1e-12``;
  * the step counter is raised to 1 before the schedule is read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class AdamWState(NamedTuple):
    step: int    # updates taken
    mu: Tensors  # first moment, keyed as the parameters
    nu: Tensors  # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    # dtype for the moments; fp32 master-style by default.
    state_dtype: torch.dtype = torch.float32


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    leaves = list(tensors.values())
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tensors: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every tensor by min(1, max_norm / (norm + 1e-12)), in place."""
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    for t in tensors.values():
        t.mul_(scale.to(t.dtype))
    return tensors, norm


def adamw(config: AdamWConfig, schedule: Optional[Schedule] = None):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params) -> (params, new_state, metrics); it
    updates ``params`` and the moments in place and may scale ``grads`` in
    place (the clip)."""

    def init_fn(params: Tensors) -> AdamWState:
        def zeros():
            return {n: torch.zeros(p.shape, dtype=config.state_dtype, device=p.device)
                    for n, p in params.items()}
        return AdamWState(step=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update_fn(grads: Tensors, state: AdamWState, params: Tensors):
        step = state.step + 1
        lr = config.lr * (schedule(step) if schedule is not None else 1.0)
        metrics = {}
        if config.grad_clip_norm is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, config.grad_clip_norm)
        b1, b2 = config.b1, config.b2
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        for name, p in params.items():
            g = grads[name].to(config.state_dtype)
            m, v = state.mu[name], state.nu[name]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(config.eps))
            p32 = p.to(config.state_dtype)  # p itself when already in that dtype
            if config.weight_decay:
                delta.add_(p32, alpha=config.weight_decay)
            delta.mul_(lr)
            if p32 is p:
                p.sub_(delta)
            else:
                p.copy_(p32.sub_(delta))
        metrics["lr"] = lr
        return params, AdamWState(step, state.mu, state.nu), metrics

    return init_fn, update_fn


# -- LR schedules -------------------------------------------------------------

def cosine_schedule(total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.0) -> Schedule:
    def fn(step: int) -> float:
        warm = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * prog))
        return warm * (final_frac + (1.0 - final_frac) * cos)

    return fn


def constant_schedule() -> Schedule:
    return lambda step: 1.0
