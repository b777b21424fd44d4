"""Predict, from parameter shapes alone, the weight all-gather bytes over
``data`` a rank of the 16 x 16 mesh moves in one ``fsdp_tp`` train step of
each LM, and what ``REPRO_CAST_BARRIER=1`` (bf16 in place of fp32 on the
wire) takes off.

    PYTHONPATH=src python3 scripts/predict_cast_barrier.py

No step is built or traced. :func:`weight_gathers` is the shape rule;
``tests/test_torch_perf.py`` holds a traced step's gathers to it.
"""

from typing import Dict

import torch

from repro_torch.configs import ARCHS
from repro_torch.launch import shapes as shp
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

GIB = 2 ** 30


def weight_gathers(cfg, mesh, strategy: str = "fsdp_tp") -> Dict[str, int]:
    """Elements a rank receives in one train step's weight all-gathers (remat
    "nothing"), by the mesh axis each gathers over.

    A weight whose compute splits along ``model`` (``tp.splits_compute``)
    and lies on ``model`` is gathered over its other axis to its ``model``
    block; any other weight is gathered whole over the one axis it lies on.
    The layers of the pattern groups are gathered twice (the forward and
    remat's recompute); the tail layers (``cfg.n_groups_and_tail``), which
    run outside remat, the embedding, final norm and head once."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    n_groups, _ = cfg.n_groups_and_tail()
    in_groups = n_groups * len(cfg.mixer_pattern)
    params = shp.param_specs_shapes(cfg, torch.float32)
    specs = shd.param_specs(mesh, shd.STRATEGIES[strategy](), params)
    out: Dict[str, int] = {}
    for name, p in params.named_parameters():
        axes = [a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        split = tp.splits_compute(name) and "model" in axes
        over = [a for a in axes if a != "model"] if split else axes
        if not over:
            continue
        assert len(over) == 1, f"{name}: a whole weight on {axes}"
        parts = name.split(".")
        times = 2 if parts[0] == "layers" and int(parts[1]) < in_groups else 1
        block = p.numel() // sizes["model"] if split else p.numel()
        out[over[0]] = out.get(over[0], 0) + times * block
    return out


def main():
    with fake_world(256):
        mesh = make_production_mesh()
        for arch, cfg in ARCHS.items():
            if cfg.is_encoder_decoder:
                continue  # the barrier is lm_loss's
            data = weight_gathers(cfg, mesh).get("data", 0)
            print(f"{arch:<22} train_4k: weight all-gathers over data fp32 "
                  f"{4 * data / GIB:9.4f} GiB -> bf16 {2 * data / GIB:9.4f} GiB "
                  f"(-{2 * data / GIB:.4f})")


if __name__ == "__main__":
    main()
