"""Step builders for train / prefill / serve over a mesh.

Counterpart of ``repro/launch/steps.py``. The reference jits each step with
in/out shardings and lowers it on ``ShapeDtypeStruct``s; here a step is a
callable over a :class:`~repro_torch.parallel.fsdp.ShardedModel` and its
arguments, built on the ``meta`` device (shapes only: the dry run traces
it, ``launch/dryrun.py``) or on a real one (seeded weights and inputs: the
same step runs). A :class:`Step` holds the callable, its arguments and the
mesh.

What the port shards is what ``parallel/fsdp.py`` shards: parameters,
AdamW's moments and decode caches at rest by the strategy's rules, the batch
by its ``batch`` rule; every rank computes its own rows. Every step splits
the compute along ``model`` (``parallel/tensor_parallel.py``): attention by
query heads, the dense MLP by ``d_ff``, the RG-LRU by its recurrent
channels, the embedding and the head by vocabulary, the MoE by experts; the
train step with the vocab-parallel cross-entropy, the gradient sums over
``model`` of its backward and the residual stream's sequence split over
``model`` where the rules say so, the decode step with attention over the
cache where it lies and the RG-LRU state where it lies; every step splits
the RWKV-6 time mix by heads (in decode and prefill its WKV state read and
written where it lies; in training the chunked twin on the rank's heads)
and the channel mix by ``d_ff``. The
encoder-decoder's steps are sharded too: its frames and tokens split by
rows, each block's self-attention, cross-attention and MLP along ``model``,
its streams along their sequence over ``model`` where the rules say so (the
reference's ``seq`` constraint): the train step's encoder and decoder
streams, the prefill's encoder stream. The prefill is the encode; it
returns the memory laid out as the reference's ``build_serve_step`` takes
it, ``("batch", "seq", None)``. The serve step reads the self caches where
they lie and takes the memory in that layout (``ShardedModel.memory``),
gathered along ``model`` once a step where its frames split.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import shapes as shp
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, make_train_step


@dataclasses.dataclass
class Step:
    kind: str
    arch: str
    shape: str
    strategy: str
    fn: Callable
    args: Tuple
    mesh: DeviceMesh
    # category -> the tensors (any nesting) that exist before the step runs
    state: Dict[str, Any]

    def __call__(self):
        return self.fn(*self.args)


def _model(cfg: ModelConfig, mesh: DeviceMesh, strategy: str,
           rules_override: Optional[Dict], device: torch.device) -> ShardedModel:
    rules = rules_override or shd.STRATEGIES[strategy]()
    return ShardedModel(build_model(cfg, device), mesh, rules)


def _params(model: ShardedModel, cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
            seed: int):
    """Seeded weights (shapes only on meta), sharded."""
    params = (shp.param_specs_shapes(cfg, dtype) if device.type == "meta"
              else model.model.init(seed, dtype))
    return model.shard(params)


def _fill(specs: Dict[str, torch.Tensor], cfg: ModelConfig, device: torch.device,
          seed: int) -> Dict[str, torch.Tensor]:
    """Inputs of the specs' shapes and dtypes on ``device``: seeded tokens
    below the vocabulary and normal embeddings (the specs themselves on meta)."""
    if device.type == "meta":
        return specs
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, s in specs.items():
        if s.dtype.is_floating_point:
            out[k] = torch.randn(s.shape, generator=g, device=device).to(s.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, s.shape, generator=g, device=device,
                                   dtype=s.dtype)
    return out


def build_train_step(
    cfg: ModelConfig,
    cell: shp.ShapeCell,
    mesh: DeviceMesh,
    strategy: str = "fsdp_tp",
    remat_policy: str = "nothing",
    rules_override: Optional[Dict] = None,
    grad_accum: int = 1,
    device: DeviceLike = "meta",
    seed: int = 0,
) -> Step:
    """AdamW (lr 3e-4, wd 0.1) over fp32 masters, bf16 compute, as the
    reference's step; one call is one optimizer step."""
    device = resolve_device(device)
    model = _model(cfg, mesh, strategy, rules_override, device)
    run = TrainRunConfig(
        optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
        remat_policy=remat_policy,
        compute_dtype=torch.bfloat16,
        grad_accum=grad_accum,
    )
    params = _params(model, cfg, torch.float32, device, seed)
    train_step, opt_init = make_train_step(model, run)
    opt_state = opt_init(params)
    batch = _fill(shp.train_input_specs(cfg, cell), cfg, device, seed)
    return Step("train", cfg.name, cell.name, strategy, train_step,
                (params, opt_state, batch), mesh,
                {"parameters": list(params.parameters()),
                 "optimizer": [opt_state.mu, opt_state.nu], "inputs": batch})


def build_prefill_step(
    cfg: ModelConfig,
    cell: shp.ShapeCell,
    mesh: DeviceMesh,
    strategy: str = "fsdp_tp",
    rules_override: Optional[Dict] = None,
    device: DeviceLike = "meta",
    seed: int = 0,
    cache_len: Optional[int] = None,
) -> Step:
    """Inference prefill: forward over the full prompt, emit cache + logits
    (the encoder pass for the encoder-decoder). ``cache_len`` defaults to
    the cell's sequence length, as in the reference."""
    device = resolve_device(device)
    model = _model(cfg, mesh, strategy, rules_override, device)
    params = _params(model, cfg, torch.bfloat16, device, seed)
    batch = _fill(shp.prefill_input_specs(cfg, cell), cfg, device, seed)
    cache = model.init_cache(cell.global_batch, cache_len or cell.seq_len, torch.bfloat16)

    @torch.no_grad()
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)

    return Step("prefill", cfg.name, cell.name, strategy, prefill, (params, batch, cache), mesh,
                {"parameters": list(params.parameters()), "inputs": [batch, cache]})


def build_serve_step(
    cfg: ModelConfig,
    cell: shp.ShapeCell,
    mesh: DeviceMesh,
    strategy: str = "fsdp_tp",
    rules_override: Optional[Dict] = None,
    device: DeviceLike = "meta",
    seed: int = 0,
) -> Step:
    """One-token decode against a seq_len cache (and the encoder's memory)."""
    device = resolve_device(device)
    model = _model(cfg, mesh, strategy, rules_override, device)
    params = _params(model, cfg, torch.bfloat16, device, seed)
    cache = model.init_cache(cell.global_batch, cell.seq_len, torch.bfloat16)
    tokens = _fill({"tokens": shp._spec((cell.global_batch, 1), torch.int32)}, cfg, device,
                   seed)["tokens"]
    args: Tuple = (params, cache, tokens)
    if cfg.is_encoder_decoder:
        memory = _fill({"memory": shp.memory_specs(cfg, cell)}, cfg, device, seed)["memory"]
        args = args + (model.memory(memory),)

    @torch.no_grad()
    def serve_step(params, cache, tokens, *memory):
        return model.decode_step(params, cache, tokens, *memory)

    return Step("decode", cfg.name, cell.name, strategy, serve_step, args, mesh,
                {"parameters": list(params.parameters()), "inputs": list(args[1:])})


def build_step(
    cfg: ModelConfig,
    cell: shp.ShapeCell,
    mesh: DeviceMesh,
    strategy: str = "fsdp_tp",
    remat_policy: str = "nothing",
    rules_override: Optional[Dict] = None,
    grad_accum: int = 1,
    device: DeviceLike = "meta",
    seed: int = 0,
) -> Step:
    if cell.kind == "train":
        return build_train_step(cfg, cell, mesh, strategy, remat_policy, rules_override,
                                grad_accum, device, seed)
    if cell.kind == "prefill":
        return build_prefill_step(cfg, cell, mesh, strategy, rules_override, device, seed)
    return build_serve_step(cfg, cell, mesh, strategy, rules_override, device, seed)
