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

Leaves of at most ``SMALL_LEAF`` elements are updated together by
multi-tensor (``torch._foreach_*``) kernels: a model of many small leaves,
as the dispatcher's surrogate, is otherwise bound by kernel launches.
Larger leaves take one plain kernel per operation, which streams a large
tensor faster than the multi-tensor kernels do. Both make the same
operations on each element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]

SMALL_LEAF = 1 << 16  # elements: one multi-tensor kernel block's chunk


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
    small: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors.values():
        if t.numel() <= SMALL_LEAF:
            small.setdefault(t.dtype, []).append(t)
        else:
            t.mul_(scale.to(t.dtype))
    for dtype, group in small.items():
        torch._foreach_mul_(group, scale.to(dtype))
    return tensors, norm


def adamw(config: AdamWConfig, schedule: Optional[Schedule] = None):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params) -> (params, new_state, metrics); it
    updates ``params`` and the moments in place and may scale ``grads`` in
    place (the clip)."""

    def init_fn(params: Tensors) -> AdamWState:
        def zeros():  # a DTensor parameter's moments are DTensors of its placement
            return {n: torch.zeros_like(p, dtype=config.state_dtype, requires_grad=False)
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
        sd = config.state_dtype
        small = [n for n, p in params.items() if p.numel() <= SMALL_LEAF]
        if small:
            g = [grads[n].to(sd) for n in small]
            m = [state.mu[n] for n in small]
            v = [state.nu[n] for n in small]
            p32 = [params[n].to(sd) for n in small]  # the parameter itself when in sd
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            delta = torch._foreach_div(m, bc1)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, config.eps)
            torch._foreach_div_(delta, den)
            if config.weight_decay:
                torch._foreach_add_(delta, p32, alpha=config.weight_decay)
            torch._foreach_mul_(delta, lr)
            torch._foreach_sub_(p32, delta)
            for n, q in zip(small, p32):
                if q is not params[n]:
                    params[n].copy_(q)
        for name, p in params.items():
            if p.numel() <= SMALL_LEAF:
                continue
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
