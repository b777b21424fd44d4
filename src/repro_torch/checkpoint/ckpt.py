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

A tree of DTensors (the sharded trainer's parameters and moments) is saved
whole: each is gathered (a collective: every rank of its mesh calls
``save``), the mesh's first rank writes, and the others wait for it, so any
rank can restore right after. Such a save is synchronous whatever
``async_save`` says. A DTensor template restores into its own placements,
each rank reading its block of the whole array: a checkpoint from one mesh
(or from one process) restores into another.
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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

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


def _leaves(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for name, sub in kids.items():
        flat.update(_leaves(sub, f"{prefix}{_SEP}{name}" if prefix else str(name)))
    return flat


def _host_copy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # one copy: training goes on updating the tensor in place while an
        # async save writes. bf16 goes as fp32 (numpy has no bf16).
        t = leaf.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` has reached this point: a barrier along each
    mesh dim in turn."""
    for dim in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(dim))


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
            # np.load gives a fresh array; a read-only one is copied
            whole = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
            dst = template
            if isinstance(template, DTensor):  # this rank's block, no communication
                whole = distribute_tensor(whole, template.device_mesh, template.placements,
                                          src_data_rank=None).to_local()
                dst = template.to_local()
            with torch.no_grad():
                dst.copy_(whole)
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
        leaves = _leaves(tree)
        mesh = next((v.device_mesh for v in leaves.values() if isinstance(v, DTensor)), None)
        if mesh is not None:
            writer = int(mesh.mesh.flatten()[0]) == dist.get_rank()
            flat = {}
            for name, leaf in leaves.items():
                whole = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
                if writer:
                    flat[name] = _host_copy(whole)
            if writer:
                self._write(step, flat, metadata or {})
            _mesh_barrier(mesh)
            return
        flat = {k: _host_copy(v) for k, v in leaves.items()}
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
