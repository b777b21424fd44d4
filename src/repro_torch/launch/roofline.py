"""Roofline model for the dry run: three terms per (arch x shape x mesh).

Counterpart of ``repro/launch/roofline.py``, with NVIDIA H100 SXM constants
in place of the TPU's (NVIDIA's data sheet, dense rates, at the 700 W
limit):
  peak compute   989 TFLOP/s bf16 per GPU (67 TFLOP/s fp32 off the tensor cores)
  HBM bandwidth  3.35 TB/s per GPU
  NVLink 4       450 GB/s per GPU per direction (900 GB/s both ways)
  NIC            50 GB/s per GPU: the 400 Gb/s rail of the H100 host type
                 (``core/cluster.py``, ``HOST_TYPES["H100"].nic_rail_bw``)

Terms (seconds, per step, per rank -- the counts of ``op_analysis`` are
rank 0's):
  compute    = op FLOPs / 989e12
  memory     = op bytes  / 3.35e12
  collective = NVLink bytes / 450e9  +  NIC bytes / 50e9

plus MODEL_FLOPS = 6 N D (train) or 2 N D (forward only) per rank (MoE:
active N), and the usefulness ratio MODEL_FLOPS / op FLOPs, which shows
remat's recompute and the compute the ``model`` split leaves whole (an
RG-LRU layer whose gate blocks the axis does not divide, an RWKV-6 mixer
it does not divide, the RWKV-6 mixes' ``mu_*`` passes over the whole
input, the MoE router), the ranks along it repeating each other's work
there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import HOST_TYPES

PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_FLOPS = PEAK_OPS_PER_S[torch.bfloat16]       # bf16 per GPU
HBM_BW = 3.35e12                                  # bytes/s per GPU
NVLINK_BW = 450e9                                 # bytes/s per GPU, one direction
NIC_BW = HOST_TYPES["H100"].nic_rail_bw * 1e9     # bytes/s per GPU across hosts


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str
    n_chips: int
    op_flops: float
    op_bytes: float
    nvlink_bytes: float
    nic_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    peak_memory_bytes: Optional[float] = None
    by_kind: Optional[Dict[str, int]] = None

    @property
    def step_time_s(self) -> float:
        """Optimistic no-overlap-needed estimate: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute / step-time vs peak: how close to roofline."""
        if self.step_time_s <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.step_time_s

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "kind": self.kind, "chips": self.n_chips,
            "compute_ms": 1e3 * self.compute_s,
            "memory_ms": 1e3 * self.memory_s,
            "collective_ms": 1e3 * self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_frac": self.roofline_fraction,
            "peak_mem_gb": (self.peak_memory_bytes or 0) / 2**30,
        }


def model_flops_per_step(cfg: ModelConfig, batch: int, seq: int, kind: str,
                         n_chips: int) -> float:
    """6*N*D (train) or 2*N*D (forward-only) per chip; MoE uses active N.

    Encoder-decoder: the encoder processes the frame sequence while the
    decoder processes only its (much shorter) token stream, so N*D splits
    per stack — 6*(N_enc*D_frames + N_dec*D_dec) with D_dec bounded by the
    decoder's native context.
    """
    mult = 6.0 if kind == "train" else 2.0
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    if cfg.is_encoder_decoder:
        d, ff = cfg.d_model, cfg.d_ff
        attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        gates = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        mlp = gates * d * ff
        n_enc = cfg.n_encoder_layers * (attn + mlp)
        n_dec = cfg.n_layers * (2 * attn + mlp) + cfg.vocab_size * d
        if kind == "decode":
            return mult * n_dec * batch / n_chips
        dec_tokens = batch * min(seq, cfg.max_seq_len)
        return mult * (n_enc * tokens + n_dec * dec_tokens) / n_chips
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    return mult * n * tokens / n_chips


def analyze_from_costs(
    arch: str,
    cfg: ModelConfig,
    shape_name: str,
    kind: str,
    mesh_name: str,
    n_chips: int,
    costs: Dict,
    peak_memory_bytes: Optional[float],
    batch_global: int,
    seq_len: int,
) -> RooflineReport:
    """``costs``: {"flops", "bytes", "nvlink", "nic", "by_kind"} of one rank."""
    flops = costs["flops"]
    byts = costs["bytes"]
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = costs["nvlink"] / NVLINK_BW + costs["nic"] / NIC_BW
    mf = model_flops_per_step(cfg, batch_global, seq_len, kind, n_chips)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, kind=kind,
        n_chips=n_chips, op_flops=flops, op_bytes=byts,
        nvlink_bytes=float(costs["nvlink"]), nic_bytes=float(costs["nic"]),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, useful_ratio=(mf / flops if flops else 0.0),
        bottleneck=bottleneck, peak_memory_bytes=peak_memory_bytes,
        by_kind=costs.get("by_kind", {}),
    )


def format_table(reports) -> str:
    header = (
        f"{'arch':<22} {'shape':<12} {'mesh':<10} {'chips':>5} "
        f"{'compute':>9} {'memory':>9} {'collect':>9} {'bound':>10} "
        f"{'useful':>7} {'roofl%':>7} {'mem/chip':>9}"
    )
    lines = [header, "-" * len(header)]
    for r in reports:
        row = r.row()
        lines.append(
            f"{row['arch']:<22} {row['shape']:<12} {row['mesh']:<10} "
            f"{row['chips']:>5} {row['compute_ms']:>8.1f}ms "
            f"{row['memory_ms']:>8.1f}ms {row['collective_ms']:>8.1f}ms "
            f"{row['bottleneck']:>10} {row['useful_ratio']:>7.2f} "
            f"{100 * row['roofline_frac']:>6.1f}% {row['peak_mem_gb']:>8.2f}G"
        )
    return "\n".join(lines)
