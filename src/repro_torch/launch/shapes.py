"""Assigned input-shape cells and their input specs as ``meta`` tensors.

Counterpart of ``repro/launch/shapes.py`` (a copy of its cell table). Four
LM shapes x ten architectures = 40 cells. ``train_*``/``prefill_*`` build
the training/prefill step; ``decode_*``/``long_*`` the serve step (one token
against a seq_len cache). ``long_500k`` requires sub-quadratic sequence
mixing and therefore only runs for the SSM/hybrid archs (skips are explicit,
with reasons, so the cell table accounts for all 40).

Where the reference returns ``jax.ShapeDtypeStruct``s, the spec functions
here return tensors on the ``meta`` device: a shape and a dtype, no storage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model_zoo import build_model
from repro_torch.weights import Params, new_module

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic sequence mixing is required at 500k; these families qualify.
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "recurrentgemma-9b")


def cell_skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return (
            "pure full-attention backbone: 500k-token decode needs a "
            "sub-quadratic mixer (see DESIGN.md §Arch-applicability)"
        )
    return None


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if cell_skip_reason(a, s) is None]


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    B, S = cell.global_batch, cell.seq_len
    batch = {
        "tokens": _spec((B, S), torch.int32),
        "labels": _spec((B, S), torch.int32),
    }
    if cfg.is_encoder_decoder:
        # audio backbone: the "sequence" is the encoder frame axis (stub
        # frontend supplies embeddings); decoder sees the token stream.
        dec_len = min(S, cfg.max_seq_len)
        batch = {
            "frames": _spec((B, S, cfg.d_model), torch.bfloat16),
            "tokens": _spec((B, dec_len), torch.int32),
            "labels": _spec((B, dec_len), torch.int32),
        }
    elif cfg.frontend:
        batch["prefix_embeds"] = _spec((B, cfg.frontend_seq_len, cfg.d_model), torch.bfloat16)
    return batch


def prefill_input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """The prefill step's batch: frames for the encoder-decoder, else the
    prompt tokens and, with a frontend, its prefix."""
    B, S = cell.global_batch, cell.seq_len
    if cfg.is_encoder_decoder:
        return {"frames": _spec((B, S, cfg.d_model), torch.bfloat16)}
    batch = {"tokens": _spec((B, S), torch.int32)}
    if cfg.frontend:
        batch["prefix_embeds"] = _spec((B, cfg.frontend_seq_len, cfg.d_model), torch.bfloat16)
    return batch


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int, dtype) -> Dict:
    """``Model.init_cache`` on the meta device: the port's cache structure."""
    return build_model(cfg, device=META).init_cache(batch, cache_len, dtype)


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell, cache_dtype=torch.bfloat16
                       ) -> Tuple[Dict, torch.Tensor]:
    """-> (cache_specs, token_specs) for the serve step."""
    B, S = cell.global_batch, cell.seq_len
    return cache_specs(cfg, B, S, cache_dtype), _spec((B, 1), torch.int32)


def memory_specs(cfg: ModelConfig, cell: ShapeCell) -> Optional[torch.Tensor]:
    """Encoder memory for enc-dec decode cells."""
    if not cfg.is_encoder_decoder:
        return None
    return _spec((cell.global_batch, cfg.frontend_seq_len, cfg.d_model), torch.bfloat16)


def param_specs_shapes(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """The model's parameters on the meta device (shapes and dtype only)."""
    return new_module(cfg, META, dtype)
