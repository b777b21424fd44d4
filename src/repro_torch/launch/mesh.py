"""Mesh construction over ``torch.distributed`` ranks (+ BandPilot-ordered
device selection).

Counterpart of ``repro/launch/mesh.py``. A device is a rank of the process
group: one card a rank (NCCL), or one CPU process (gloo). Rank i stands for
cluster GPU id i, as the reference's launcher keeps ``devices[i]``.

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group): single-pod (16, 16) = 256 ranks with ("data", "model")
axes, or multi-pod (2, 16, 16) = 512 ranks with ("pod", "data", "model").
The fastest fabric carries the "model" (TP/EP) axis, "data" runs FSDP, and
the slowest fabric carries the "pod" axis (pure DP / optional pipeline).

``bandpilot_mesh`` is the framework integration of the paper: given a device
pool and a request size, BandPilot selects *which* devices form the mesh
(balanced across hosts to maximize collective bandwidth) and orders them
host-major so the mesh's fastest-changing axis stays intra-host.

Building a ``DeviceMesh`` creates process groups collectively: every rank
of the world calls these functions, also a rank the dispatch left out (its
``mesh.get_coordinate()`` is None and it sits the run out).
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


@contextlib.contextmanager
def process_group(device_type: str, rank: int = 0, world: int = 1,
                  store: Optional[str] = None) -> Iterator[None]:
    """``torch.distributed``'s default group for the body: gloo on the CPU,
    NCCL on the card (rank r on card r), meeting through the ``file://``
    store ``store`` (for a world of one, a fresh temporary file). The port
    never moves to the CPU on its own: "cuda" without a card raises."""
    tmp = None
    if store is None:
        if world != 1:
            raise ValueError("a world of several ranks needs a shared store file")
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store = os.path.join(tmp, "store")
    kw = {}
    if device_type == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank, world_size=world, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of "
            f"{math.prod(shape)} ranks, one a device; this process group has {world}")
    return make_mesh_from_devices(range(world), shape, axes, device_type)


def make_mesh_from_devices(devices: Sequence[int], shape: Tuple[int, ...],
                           axes: Tuple[str, ...], device_type: str = "cuda") -> DeviceMesh:
    """Build a mesh over an explicit (BandPilot-ordered) list of ranks."""
    ranks = torch.tensor(list(devices), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def bandpilot_device_order(dispatcher, avail_ids: Sequence[int], k: int) -> List[int]:
    """Dispatch k device ids via BandPilot and order them host-major.

    The returned order is used to lay out the mesh so that consecutive mesh
    columns (the highest-traffic axis) stay on the same host where possible.
    """
    subset = dispatcher.dispatch(list(avail_ids), k)
    cluster = dispatcher.cluster
    return sorted(subset, key=lambda g: (cluster.gpu_host[g], cluster.gpu_local[g]))


def bandpilot_mesh(dispatcher, devices: Sequence[int], k: int, shape: Tuple[int, ...],
                   axes: Tuple[str, ...], avail_ids: Optional[Sequence[int]] = None,
                   device_type: str = "cuda") -> Tuple[DeviceMesh, List[int]]:
    """Select + order k devices with BandPilot, then build the mesh.

    ``devices[i]`` is the rank that stands for cluster GPU id ``i``. Takes
    the first k devices if the dispatcher is None."""
    if avail_ids is None:
        avail_ids = range(len(devices))
    if dispatcher is None:
        chosen = list(avail_ids)[:k]
    else:
        chosen = bandpilot_device_order(dispatcher, avail_ids, k)
    dev_list = [devices[i] for i in chosen]
    return make_mesh_from_devices(dev_list, shape, axes, device_type), chosen
