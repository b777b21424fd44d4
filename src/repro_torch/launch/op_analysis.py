"""Per-rank op analysis of a traced step: FLOPs, HBM bytes, collectives, memory.

Counterpart of ``repro/launch/hlo_analysis.py``. The reference parses the
HLO text of a compiled SPMD module; eager PyTorch has no HLO, so
:class:`OpCounter`, a ``TorchDispatchMode``, records every op a step runs
on this rank instead -- on ``meta`` tensors in the dry run (no storage, no
card), or on real ones:

* FLOPs: ``torch.utils.flop_counter``'s formulas (those ``FlopCounterMode``
  uses), flash attention's registered by its ``ops.py``;
* HBM bytes: every op's tensor inputs plus outputs, counted as if nothing
  were fused. Eager PyTorch on the card runs one kernel an op, so this is
  the port's own traffic, not a bound on it. Views, allocations without a
  write and collectives move nothing here;
* collectives: every ``_c10d_functional`` op (all-gather, all-reduce,
  reduce-scatter, all-to-all), its bytes and its group's ranks: DTensor's
  weight gathers and redistributions (among them a training step's sums
  over ``model`` of the gradients of weights read in part), and the
  tensor-parallel path's own (``parallel/tensor_parallel.py``: the sums
  over ``model`` after the row-parallel products and the lookup, and in a
  backward before the column-parallel ones -- where a training stream's
  sequence splits, reduce-scatters and all-gathers along it --, the
  vocab-parallel cross-entropy's max and sum, the decode step's q gather
  and log-sum-exp merge, the prefill's all-to-all of K and V). Bytes follow
  the reference's convention: the output for all-gather and all-to-all, the
  operand for the others (so an all-reduce of X counts X, and the
  all-gather and reduce-scatter pair that replaces it counts 2X, though a
  ring moves the same bytes for both);
* memory: every storage alive at each op boundary, rounded up to the CUDA
  caching allocator's 512 bytes, and the peak split by category
  (:meth:`OpCounter.peak_by_category`).

An op on DTensor arguments is handed back to DTensor (``NotImplemented``), so
the counter sees the local ops it runs and the collectives of any implicit
redistribution; DTensor's sharding propagation runs on ``FakeTensor``s,
which are skipped.

:func:`split_by_fabric` replaces the reference's pod split (ICI against
DCN) by the H100 cluster's host split: a group whose ranks lie on more than
one host of ``gpus_per_host`` ranks (host = rank // gpus_per_host) crosses
the NIC; the others stay on NVLink.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

ALLOC_GRANULE = 512  # bytes: the CUDA caching allocator's smallest block
GPUS_PER_HOST = 8    # an H100 host (HGX): the NVLink domain

COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}
# functional-collective ops that move nothing themselves
_COLLECTIVE_BOOKKEEPING = ("wait_tensor", "_wrap_tensor_autograd")
_BYTES_OF_OUTPUT = ("all-gather", "all-to-all")
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
               torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default,
               torch.ops.aten.empty_like.default}
CATEGORIES = ("parameters", "gradients", "optimizer", "activations", "temporaries", "inputs")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes: int
    name: str
    ranks: Tuple[int, ...]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    return out


def _writes(func) -> bool:
    """Whether ``func`` writes into an argument (in place or ``out=``)."""
    return any(r.alias_info is not None and r.alias_info.is_write for r in func._schema.returns)


def split_by_fabric(ops: Iterable[CollectiveOp], gpus_per_host: int = GPUS_PER_HOST
                    ) -> Tuple[int, int, Dict[str, int]]:
    """-> (nvlink_bytes, nic_bytes, by_kind). A group whose ranks span more
    than one host (rank // gpus_per_host) rides the NIC; otherwise NVLink."""
    nvlink = nic = 0
    by_kind: Dict[str, int] = {}
    for op in ops:
        by_kind[op.kind] = by_kind.get(op.kind, 0) + op.bytes
        if len({r // gpus_per_host for r in op.ranks}) > 1:
            nic += op.bytes
        else:
            nvlink += op.bytes
    return nvlink, nic, by_kind


def collective_summary(ops: Sequence[CollectiveOp], gpus_per_host: int = GPUS_PER_HOST
                       ) -> Dict:
    nvlink, nic, by_kind = split_by_fabric(ops, gpus_per_host)
    return {
        "n_collectives": len(ops),
        "total_bytes": nvlink + nic,
        "nvlink_bytes": nvlink,
        "nic_bytes": nic,
        "by_kind": by_kind,
    }


def _group_ranks(args) -> Tuple[int, ...]:
    """The ranks of a functional collective's group (its last str argument)."""
    name = [a for a in args if isinstance(a, str)][-1]
    group = dist.distributed_c10d._resolve_process_group(name)
    return tuple(dist.get_process_group_ranks(group))


@dataclasses.dataclass
class _Alloc:
    bytes: int
    category: str  # a CATEGORIES entry, or the phase "forward" / "backward" / "after"
    start: int     # op index of the allocation
    end: float = math.inf  # op index of the free, plus a half


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside it on this rank (see the module docstring).

    Register the step's pre-existing tensors with :meth:`track` before
    entering; any other storage an op reads that was not seen before is
    counted from then on as an input."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives: List[CollectiveOp] = []
        self._allocs: List[_Alloc] = []
        self._live: Dict[int, int] = {}  # storage key -> index into _allocs
        self._now = 0        # live bytes
        self.peak_bytes = 0
        self._peak_at = 0
        self._backward_seen = False
        self._backward_end: Optional[int] = None
        self._writes: Dict = {}  # func -> _writes(func)

    # -- storages -----------------------------------------------------------

    def _storage(self, t: torch.Tensor, category: str) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, FakeTensor) or t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        size = -(-st.nbytes() // ALLOC_GRANULE) * ALLOC_GRANULE
        self._live[key] = len(self._allocs)
        self._allocs.append(_Alloc(size, category, self.n_ops))
        self._now += size
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        i = self._live.pop(key, None)
        if i is not None:  # between this op and the next
            self._allocs[i].end = self.n_ops + 0.5
            self._now -= self._allocs[i].bytes

    def track(self, tensors: Iterable, category: str) -> "OpCounter":
        """Count the storages of ``tensors`` (any nesting) as ``category``."""
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._storage(t, category)
        self.peak_bytes = max(self.peak_bytes, self._now)
        return self

    def peak_by_category(self) -> Dict[str, int]:
        """Bytes live at the peak, by category: a storage made in the forward
        is an activation; one made in the backward is a gradient if it outlives
        the backward, else a temporary; one made after it (the optimizer's
        update) is a temporary."""
        out = dict.fromkeys(CATEGORIES, 0)
        at = self._peak_at
        end = math.inf if self._backward_end is None else self._backward_end
        for a in self._allocs:
            if not a.start <= at < a.end:
                continue
            cat = a.category
            if cat == "forward":
                cat = "activations"
            elif cat == "backward":
                cat = "gradients" if a.end > end else "temporaries"
            elif cat == "after":
                cat = "temporaries"
            out[cat] += a.bytes
        return out

    # -- the dispatch -------------------------------------------------------

    def _phase(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            self._backward_seen = True
            return "backward"
        if self._backward_seen:
            if self._backward_end is None:
                self._backward_end = self.n_ops
            return "after"
        return "forward"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = _tensors(kwargs, _tensors(args, []))
        if any(isinstance(t, DTensor) for t in flat_in):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        flat_out = _tensors(out, [])
        if any(isinstance(t, FakeTensor) for t in flat_in + flat_out):
            return out  # DTensor's sharding propagation
        self.n_ops += 1
        phase = self._phase()
        for t in flat_in:  # storages made before the counter saw them
            self._storage(t, "inputs")
        in_keys = {t.untyped_storage()._cdata for t in flat_in if t.layout == torch.strided}
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional":
            name = packet.__name__
            if name not in COLLECTIVE_KINDS and name not in _COLLECTIVE_BOOKKEEPING:
                raise NotImplementedError(f"op_analysis: collective {name} is not counted")
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                moved = flat_out if kind in _BYTES_OF_OUTPUT else flat_in
                self.collectives.append(CollectiveOp(
                    kind, sum(_nbytes(t) for t in moved), name, _group_ranks(args)))
        else:
            writes = self._writes.get(func)
            if writes is None:
                writes = self._writes[func] = _writes(func)
            view = not writes and all(t.untyped_storage()._cdata in in_keys
                                      for t in flat_out if t.layout == torch.strided)
            if func not in _NO_TRAFFIC and not view:
                self.bytes += sum(_nbytes(t) for t in flat_in + flat_out)
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        for t in flat_out:
            self._storage(t, phase)
        if self._now > self.peak_bytes:
            self.peak_bytes, self._peak_at = self._now, self.n_ops
        return out

    def summary(self, gpus_per_host: int = GPUS_PER_HOST) -> Dict:
        coll = collective_summary(self.collectives, gpus_per_host)
        return {"flops": self.flops, "bytes": self.bytes, "n_ops": self.n_ops,
                "nvlink": coll["nvlink_bytes"], "nic": coll["nic_bytes"],
                "by_kind": coll["by_kind"], "n_collectives": coll["n_collectives"],
                "peak_bytes": self.peak_bytes, "peak_by_category": self.peak_by_category()}
