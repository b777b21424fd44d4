"""Checkpointing: atomic save/restore of parameters and optimizer state.

Counterpart of ``repro/checkpoint/ckpt.py``, with its contract: one
``arrays.npz`` of flattened arrays and a ``meta.json`` holding the step, both
written to a temp dir that is atomically renamed, so a crash mid-save never
corrupts the latest checkpoint; the latest ``keep`` are kept; with
``async_save`` a background thread writes, one save in flight at a time.

Keys are state-dict paths joined by ``/`` instead of the reference's
``jax.tree_util.keystr`` paths. A tree is a nested dict whose leaves are
tensors, numpy arrays or ints; an ``nn.Module`` stands for its state dict and
an ``AdamWState`` for ``{"step", "mu", "nu"}``. So ``{"params": lm, "opt":
state}`` saves ``params/<name>``, ``opt/step``, ``opt/mu/<name>`` and
``opt/nu/<name>``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.train.optimizer import AdamWState

Tree = Any

_SEP = "/"


def _children(tree: Tree) -> Optional[Dict[str, Any]]:
    """The named children of an inner node, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return tree.state_dict(keep_vars=True)
    if isinstance(tree, AdamWState):
        return tree._asdict()
    if isinstance(tree, dict):
        return tree
    return None


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            # a copy: training goes on updating the tensor in place while an
            # async save writes. bf16 goes as fp32 (numpy has no bf16).
            t = tree.detach().cpu()
            t = t.float() if t.dtype == torch.bfloat16 else t
            return {prefix: t.numpy().copy()}
        return {prefix: np.asarray(tree)}
    flat = {}
    for name, sub in kids.items():
        flat.update(_flatten(sub, f"{prefix}{_SEP}{name}" if prefix else str(name)))
    return flat


def _restore(template: Tree, data, prefix: str = "") -> Tree:
    """``template``'s structure with each leaf read from ``data``. Tensors are
    written in place (on their device, in their dtype), so a module
    template comes back loaded; other leaves are scalars."""
    kids = _children(template)
    if kids is None:
        arr = data[prefix]
        shape = tuple(template.shape) if hasattr(template, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {prefix}: ckpt {arr.shape} vs "
                             f"template {shape}")
        if isinstance(template, torch.Tensor):
            with torch.no_grad():
                template.copy_(torch.from_numpy(np.array(arr)))
            return template
        return type(template)(arr)  # a scalar such as the optimizer's step
    out = {name: _restore(sub, data, f"{prefix}{_SEP}{name}" if prefix else str(name))
           for name, sub in kids.items()}
    if isinstance(template, AdamWState):
        return AdamWState(**out)
    return template if isinstance(template, nn.Module) else out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Tree, metadata: Optional[dict] = None):
        # copy to host memory *before* handing to the writer thread
        flat = _flatten(tree)
        if self.async_save:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, metadata or {}))
            self._thread.start()
        else:
            self._write(step, flat, metadata or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], metadata: dict):
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time(), **metadata}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.directory)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: Optional[int] = None) -> Tuple[int, Tree]:
        """Restore into the structure of ``template`` (shapes must match)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}", "arrays.npz")
        with np.load(path) as data:
            return step, _restore(template, data)
