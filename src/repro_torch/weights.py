"""Weights for the port's models: carried across from the reference, or drawn.

``from_jax_params`` takes the reference's parameter pytree (nested dicts and
lists of numpy arrays, as ``repro.models.transformer.init_lm_params`` builds
it) and loads it into an :class:`~repro_torch.models.transformer.LM`:
``params["blocks"][i]`` holds pattern position ``i`` stacked over groups, so
its entry ``g`` is layer ``g * len(pattern) + i``; ``params["tail"][j]`` is
layer ``n_groups * len(pattern) + j``. Leaf names are module attribute names.
For an encoder-decoder config it takes ``repro.models.encdec``'s pytree into
an :class:`~repro_torch.models.encdec.EncDec`: ``enc_blocks`` and
``dec_blocks`` hold their layers stacked on axis 0 (``jax.vmap`` at init),
so entry ``i`` is ``enc_blocks.{i}`` / ``dec_blocks.{i}``; a LayerNorm is
``{g, b}``.

``jax_params_to_state_dict`` maps any pytree of that layout, not only
parameters: a reference gradient pytree (``jax.grad`` of ``model.loss``)
through it gives fp32 tensors keyed by the state-dict names, which is how
the port's gradients are held against the reference's.

``init_params`` draws full-width weights on the device from a seeded
``torch.Generator``, with the reference's statistics (not its bits).

``surrogate_from_jax_params`` loads the dispatcher's surrogate pytree (any
of the three variants of ``repro.core.surrogate``: dicts and lists of
arrays) into a :class:`~repro_torch.core.surrogate.Surrogate`, whose
state-dict names are the pytree's paths; ``surrogate_to_jax_params`` gives
the numpy pytree back, so the reference can score a model the port trained.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.surrogate import Surrogate
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

Params = Union[LM, EncDec]


def _flatten(prefix: str, tree: Any, index, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(f"{prefix}.{key}", sub, index, out)
        return
    arr = np.asarray(tree, dtype=np.float32)
    if index is not None:
        arr = arr[index]
    out[prefix] = torch.from_numpy(np.array(arr))  # a writable copy


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for sub in tree.values() for leaf in _leaves(sub)]
    return [tree]


def _encdec_state_dict(cfg: ModelConfig, params: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    stacks = {"enc_blocks": cfg.n_encoder_layers, "dec_blocks": cfg.n_layers}
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        n = stacks.get(name)
        if n is None:
            _flatten(name, sub, None, sd)
            continue
        if any(np.shape(leaf)[0] != n for leaf in _leaves(sub)):
            raise ValueError(f"{name}: leaves are not stacked over {n} layers")
        for i in range(n):
            _flatten(f"{name}.{i}", sub, i, sd)
    return sd


def jax_params_to_state_dict(cfg: ModelConfig, params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The reference pytree as an fp32 CPU state dict of :class:`LM`, or of
    :class:`EncDec` for an encoder-decoder config."""
    if cfg.is_encoder_decoder:
        return _encdec_state_dict(cfg, params)
    n_groups, n_tail = cfg.n_groups_and_tail()
    p = len(cfg.mixer_pattern)
    if len(params["blocks"]) != p or len(params["tail"]) != n_tail:
        raise ValueError("parameter tree does not match the config's layer layout")
    sd: Dict[str, torch.Tensor] = {}
    for name in ("embed", "final_norm", "unembed"):
        if name in params:
            _flatten(name, params[name], None, sd)
    for i, stacked in enumerate(params["blocks"]):
        for g in range(n_groups):
            _flatten(f"layers.{g * p + i}", stacked, g, sd)
    for j, tail in enumerate(params["tail"]):
        _flatten(f"layers.{n_groups * p + j}", tail, None, sd)
    return sd


def new_module(cfg: ModelConfig, device: torch.device, dtype: torch.dtype) -> Params:
    """The port's uninitialized module for ``cfg``: an EncDec or an LM."""
    return (EncDec if cfg.is_encoder_decoder else LM)(cfg, device, dtype)


def from_jax_params(cfg: ModelConfig, params: Dict[str, Any],
                    device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.float32) -> Params:
    """Load the reference's parameter pytree into the port's modules."""
    model = new_module(cfg, resolve_device(device), dtype)
    model.load_state_dict(jax_params_to_state_dict(cfg, params), strict=True)
    return model


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights drawn on ``device`` from ``torch.Generator(seed)``."""
    dev = resolve_device(device)
    model = new_module(cfg, dev, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return model


def _tree_to_state_dict(prefix: str, tree: Any, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = torch.from_numpy(np.array(tree, dtype=np.float32))
        return
    for key, sub in items:
        _tree_to_state_dict(f"{prefix}.{key}" if prefix else str(key), sub, out)


def surrogate_from_jax_params(params: Dict[str, Any],
                              device: DeviceLike = "cuda") -> Surrogate:
    """Load a reference surrogate pytree; the variant follows its keys."""
    dev = resolve_device(device)
    if "id_embed" in params:
        model = Surrogate("naive", n_gpus=int(np.shape(params["id_embed"])[0]))
    else:
        model = Surrogate("contended" if "ctx_embed" in params else "hierarchical")
    sd: Dict[str, torch.Tensor] = {}
    _tree_to_state_dict("", params, sd)
    model.load_state_dict(sd, strict=True)
    return model.to(dev)


def surrogate_to_jax_params(model: Surrogate) -> Dict[str, Any]:
    """The model as the reference's pytree of float32 numpy arrays (lists
    where the reference has lists: ``trunk.layers``, ``trunk.head``)."""
    tree: Dict[str, Any] = {}
    for name, tensor in model.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor.detach().cpu().numpy().copy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(key.isdigit() for key in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {key: lists(sub) for key, sub in node.items()}

    return lists(tree)
