"""Logical-axis sharding rules -> DTensor placements on a ``DeviceMesh``.

Counterpart of ``repro/parallel/sharding.py``. Every parameter leaf and
activation carries *logical* axis names; a rule table maps them to mesh
axes; a divisibility-aware resolver turns them into a spec against the
active mesh (axes that do not divide evenly fall back to replication, which
keeps one rule table valid across every architecture -- MQA's single KV
head cannot shard 16-way and replicates).

A spec is a plain tuple, one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of names (the ``PartitionSpec`` counterpart).
:func:`placements` turns it into DTensor placements, one per mesh dim:
``Shard(d)`` where tensor dim ``d`` lists that axis, else ``Replicate()``.
A dim sharded over several axes lists them in mesh order, and DTensor then
splits it over them left to right: the row-major order over the named axes
that JAX gives it.

A "mesh" here is a ``DeviceMesh`` with named dims, or any mapping of axis
name to size (the spec functions need no ranks, so a (2, 16, 16) mesh can be
resolved in one process).

The port keeps each layer as its own module (``layers.{i}``) where the
reference stacks a pattern position's layers on a leading ``"layers"`` axis,
so a port leaf has one dim fewer and its spec is the reference's without
that entry (``None`` in every strategy). Leaf names are the last part of the
state-dict name, which the port's modules keep equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

MeshAxes = Union[None, str, Tuple[str, ...]]
Mesh = Union[DeviceMesh, Mapping[str, int]]
Spec = Tuple[MeshAxes, ...]


# ---------------------------------------------------------------------------
# Rule tables (logical axis -> mesh axes).  These are *strategies*: the
# dry-run/perf loop selects one by name; custom dicts may override entries.
# ---------------------------------------------------------------------------

def _rules_fsdp_tp() -> Dict[str, MeshAxes]:
    """Default: FSDP(data) x TP(model), pod = DP, Megatron-style sequence
    sharding of the residual stream (saved activations live seq-sharded on
    the model axis -- the memory lever for deep train shapes)."""
    return {
        # activations
        "batch": ("pod", "data"),
        "seq": "model",           # residual-stream sequence sharding (SP)
        "act_embed": None,
        "act_heads": "model",
        "act_ff": "model",
        "act_vocab": "model",
        # decode caches
        "seq_cache": "model",
        # weights
        "embed": "data",          # FSDP axis for the d_model dim of weights
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "rnn": "model",
        "conv": None,
        "blocks": None,           # per-head block-diagonal gates (rglru)
        "lora": None,
        "layers": None,           # stacked scan axis
    }


def _rules_fsdp_tp_noseq() -> Dict[str, MeshAxes]:
    # ablation: no sequence sharding of the residual stream
    r = _rules_fsdp_tp()
    r["seq"] = None
    return r


def _rules_tp_only() -> Dict[str, MeshAxes]:
    r = _rules_fsdp_tp()
    r["embed"] = None
    return r


def _rules_fsdp_tp_pod_fsdp() -> Dict[str, MeshAxes]:
    # beyond-paper variant: extend the FSDP axis across pods too
    r = _rules_fsdp_tp()
    r["embed"] = ("pod", "data")
    return r


def _rules_serve_2d() -> Dict[str, MeshAxes]:
    """Decode-optimized: weight-stationary 2D TP.

    FSDP is an anti-pattern for single-token decode -- the per-step weight
    all-gather moves the entire (bf16) model for one token. Here weights
    stay sharded over BOTH axes (embed dim on "data", heads/ff/vocab on
    "model") and never move; the per-layer collectives become tiny
    activation all-reduces. The batch is kept OFF the "data" axis so it
    cannot conflict with the weights' embed dim (a conflict that forces
    weight gathering); the KV cache spreads its sequence axis over
    ("data", "model") so long caches fit per device.
    """
    return {
        "batch": "pod",
        "seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_ff": "model",
        "act_vocab": "model",
        "seq_cache": ("data", "model"),
        "embed": "data",
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "rnn": ("data", "model"),
        "conv": None,
        "blocks": None,
        "lora": None,
        "layers": None,
    }


STRATEGIES = {
    "fsdp_tp": _rules_fsdp_tp,
    "fsdp_tp_noseq": _rules_fsdp_tp_noseq,
    "tp_only": _rules_tp_only,
    "fsdp_tp_pod_fsdp": _rules_fsdp_tp_pod_fsdp,
    "serve_2d": _rules_serve_2d,
}


# ---------------------------------------------------------------------------
# Meshes, specs and placements
# ---------------------------------------------------------------------------

def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def placements(mesh: Mesh, spec: Spec) -> Tuple[Placement, ...]:
    """DTensor placements, one per mesh dim, of a spec."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not in mesh "
                             f"order {tuple(names)}; DTensor splits a dim over mesh "
                             "dims left to right")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: Mesh
    spec: Spec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.mesh, self.spec)


# ---------------------------------------------------------------------------
# Active sharding context (mesh + rules)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingContext:
    mesh: Mesh
    rules: Dict[str, MeshAxes]


_CTX = threading.local()


def set_context(ctx: Optional[ShardingContext]) -> None:
    _CTX.value = ctx


def get_context() -> Optional[ShardingContext]:
    return getattr(_CTX, "value", None)


class use_sharding:
    """``with use_sharding(mesh, rules): ...`` -- enables activation
    constraints (:func:`shard_activation`)."""

    def __init__(self, mesh: Mesh, rules: Optional[Dict[str, MeshAxes]] = None,
                 strategy: str = "fsdp_tp"):
        if rules is None:
            rules = STRATEGIES[strategy]()
        self.ctx = ShardingContext(mesh, rules)

    def __enter__(self):
        set_context(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        set_context(None)
        return False


# ---------------------------------------------------------------------------
# Spec resolution with divisibility fallback
# ---------------------------------------------------------------------------

def _axis_size(sizes: Dict[str, int], axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def resolve_spec(mesh: Mesh, rules: Dict[str, MeshAxes],
                 logical: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
    """logical axis names + concrete shape -> spec.

    Drops mesh axes that are not in the mesh, are already used by an earlier
    dim, or do not divide the dim (trailing axes first)."""
    sizes = axis_sizes(mesh)
    spec = []
    used: set = set()
    for name, dim in zip(logical, shape):
        axes = rules.get(name) if name else None
        if axes is None:
            spec.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        while axes and dim % _axis_size(sizes, axes) != 0:
            axes = axes[:-1]
        if not axes:
            spec.append(None)
        else:
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
    return tuple(spec)


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def coordinate(mesh: Mesh, coord: Optional[Mapping[str, int]] = None) -> Dict[str, int]:
    """This rank's index along each mesh axis: ``coord`` where given (a mesh
    of axis sizes has no ranks), else the ``DeviceMesh``'s own."""
    if coord is not None:
        return dict(coord)
    if not isinstance(mesh, DeviceMesh):
        raise ValueError("a mesh given by its axis sizes needs the rank's coordinate")
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, c))


class Split(NamedTuple):
    """A dim of a leaf split over mesh axes: the dim, the axes (in mesh order)
    and this rank's block ``[lo, hi)`` along it."""

    dim: int
    axes: Tuple[str, ...]
    lo: int
    hi: int


def dim_split(mesh: Mesh, spec: Spec, dim: int, shape: Sequence[int],
              coord: Optional[Mapping[str, int]] = None) -> Optional[Split]:
    """Dim ``dim`` of a leaf laid out by the resolved ``spec``: None where no
    axis splits it, else this rank's block, the axes taken row-major as
    DTensor splits a dim over several (:func:`placements`)."""
    axes = _axes(spec[dim]) if dim < len(spec) else ()
    if not axes:
        return None
    sizes, at = axis_sizes(mesh), coordinate(mesh, coord)
    index, n = 0, 1
    for a in axes:
        index, n = index * sizes[a] + at[a], n * sizes[a]
    step = shape[dim] // n
    return Split(dim, axes, index * step, (index + 1) * step)


def model_split(mesh: Mesh, spec: Spec, shape: Sequence[int],
                coord: Optional[Mapping[str, int]] = None) -> Optional[Split]:
    """Which dim of a parameter or cache leaf the ``model`` axis splits, and
    this rank's block along it; None where it splits none. ``spec`` is the
    resolved one (:func:`resolve_spec`), so a dim the axis does not divide is
    reported unsplit, as the reference replicates it."""
    for dim, entry in enumerate(spec):
        if "model" in _axes(entry):
            return dim_split(mesh, spec, dim, shape, coord)
    return None


def embed_split(mesh: Mesh, rules: Dict[str, MeshAxes], name: str, shape: Sequence[int],
                coord: Optional[Mapping[str, int]] = None) -> Optional[Split]:
    """The ``embed`` dim (``d_model``) of parameter ``name`` laid out by its
    resolved spec: this rank's block along it, or None where the leaf has
    no ``embed`` dim or no axis splits it (a ``d_model`` the axes do not
    divide resolves to whole)."""
    logical = logical_for_leaf(_leaf_name(name), len(shape))
    if "embed" not in logical:
        return None
    spec = resolve_spec(mesh, rules, logical, shape)
    return dim_split(mesh, spec, logical.index("embed"), shape, coord)


STREAM_LOGICAL = ("batch", "seq", "act_embed")  # the residual stream [B, S', d]


def stream_split(mesh: Mesh, rules: Dict[str, MeshAxes], shape: Sequence[int],
                 coord: Optional[Mapping[str, int]] = None) -> Optional[Split]:
    """The residual stream's sequence split in training: the rank's block of
    positions ``[lo, hi)`` of the global stream ``shape`` (B, S', d), where
    ``S' = P + S`` with a prefix, resolved as the reference constrains the
    stream (``shard_activation(x, "batch", "seq", "act_embed")``). None where
    ``model`` does not split it: a rule without ``seq`` (``fsdp_tp_noseq``,
    ``serve_2d``), an S' the axis does not divide (the resolver replicates),
    or a ``model`` axis of one rank, which splits nothing. Only a split over
    ``model`` alone is ported."""
    if axis_sizes(mesh).get("model", 1) == 1:
        return None
    spec = resolve_spec(mesh, rules, STREAM_LOGICAL, shape)
    if "model" not in _axes(spec[1]):
        return None
    if _axes(spec[1]) != ("model",):
        raise NotImplementedError(f"the stream's sequence splits over {spec[1]}; only a "
                                  "split over model alone is ported")
    return dim_split(mesh, spec, 1, shape, coord)


def shard_activation(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay an activation out by its logical axes: a no-op without a context,
    and for a plain (local) tensor, which is what the port's compute runs on
    (sharded serving splits the ``model`` axis through explicit hooks,
    ``parallel/tensor_parallel.py``, not through activation layouts); a
    DTensor is redistributed to the resolved spec
    (``with_sharding_constraint``)."""
    ctx = get_context()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(ctx.mesh, ctx.rules, logical, x.shape)
    return x.redistribute(ctx.mesh, placements(ctx.mesh, spec))


# ---------------------------------------------------------------------------
# Parameter sharding: leaf-name -> logical axes
# ---------------------------------------------------------------------------

# Maps the *leaf key name* in the params pytree to logical axes of its
# non-stacked shape.  Stacked variants (scan-over-layers) are detected by
# ndim and get a leading "layers" axis.
PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "pos_embed": ("seq", "embed"),
    # attention
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "q_norm": (None,),
    "k_norm": (None,),
    # dense mlp
    "w_gate": ("embed", "ff"),
    "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    # moe (expert-stacked, detected by ndim)
    "router": ("embed", None),
    # rglru
    "w_in_rec": ("embed", "rnn"),
    "w_in_gate": ("embed", "rnn"),
    "w_out": ("rnn", "embed"),
    "conv_w": ("conv", "rnn"),
    "conv_b": ("rnn",),
    "gate_a": ("blocks", None, None),
    "gate_a_b": ("blocks", None),
    "gate_x": ("blocks", None, None),
    "gate_x_b": ("blocks", None),
    "lam": ("rnn",),
    # rwkv
    "mu_r": (None,), "mu_k": (None,), "mu_v": (None,), "mu_w": (None,),
    "mu_g": (None,),
    "w_r": ("embed", "ff"),
    "w_k": ("embed", "ff"),
    "w_v": ("ff", "embed"),
    "w_g": ("embed", "ff"),
    "decay_base": (None,),
    "decay_a": ("embed", "lora"),
    "decay_b": ("lora", "embed"),
    "bonus": (None, None),
    "out_norm": (None,),
}

# MoE expert weights share leaf names with dense MLP; their base logical
# shapes get an "experts" prefix when a leading expert dim is present.
_MOE_LEAVES = {"w_gate": ("experts", "embed", "ff"),
               "w_up": ("experts", "embed", "ff"),
               "w_down": ("experts", "ff", "embed")}


def logical_for_leaf(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    base = PARAM_LOGICAL.get(name)
    if base is None:
        return (None,) * ndim  # norms, scalars: replicate
    if name in _MOE_LEAVES and ndim >= 3:
        base = _MOE_LEAVES[name]
    if ndim == len(base) + 1:
        return ("layers",) + base
    if ndim == len(base) + 2:  # stacked MoE inside scanned blocks
        return ("layers",) + _MOE_LEAVES.get(name, base)
    if ndim != len(base):
        return (None,) * ndim
    return base


def _leaf_name(name: str) -> str:
    """The last part of a state-dict name: ``layers.3.attn.wq`` -> ``wq``."""
    return name.rsplit(".", 1)[-1]


def _named_shapes(params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, Tuple[int, ...]]:
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {n: tuple(p.shape) for n, p in items}


def param_specs(mesh: Mesh, rules: Dict[str, MeshAxes],
                params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, Spec]:
    """Spec of each parameter of a module (or of a name -> tensor mapping),
    keyed by state-dict name. Shapes only: a module on the ``meta`` device
    will do."""
    return {n: resolve_spec(mesh, rules, logical_for_leaf(_leaf_name(n), len(shape)), shape)
            for n, shape in _named_shapes(params).items()}


def param_shardings(mesh: Mesh, rules: Dict[str, MeshAxes],
                    params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(mesh, spec) for n, spec in param_specs(mesh, rules, params).items()}


# Decode-cache leaves (see repro_torch/models/*: init_kv_cache / init_*_state).
CACHE_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "seq_cache", "kv_heads", "head_dim"),
    "v": ("batch", "seq_cache", "kv_heads", "head_dim"),
    "h": ("batch", "rnn"),
    "conv": ("batch", None, "rnn"),
    "tm_shift": ("batch", "rnn"),
    "wkv": ("batch", "heads", None, None),
    "cm_shift": ("batch", "rnn"),
    "pos": (),
}


def cache_shardings(mesh: Mesh, rules: Dict[str, MeshAxes], cache: Any) -> Any:
    """A decode cache's structure (``{"layers": [per-layer dict], "pos": int}``)
    with each leaf's :class:`NamedSharding`."""

    def walk(name: str, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(name, v) for v in node]
        shape = tuple(getattr(node, "shape", ()))
        base = CACHE_LOGICAL.get(name, (None,) * len(shape))
        return NamedSharding(mesh, resolve_spec(mesh, rules, base[: len(shape)], shape))

    return walk("", cache)


def batch_specs(mesh: Mesh, rules: Dict[str, MeshAxes], batch: Mapping[str, Any]
                ) -> Dict[str, Spec]:
    """Input batch: [B, S] / [B, S, d] arrays shard batch (+seq if SP)."""

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        logical = ("batch", "seq") + (None,) * (len(shape) - 2)
        return resolve_spec(mesh, rules, logical[: len(shape)], shape)

    return {k: spec_for(v) for k, v in batch.items()}
