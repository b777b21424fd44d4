"""Assigned architecture configs (+ the paper's cluster configs).

Every config cites its public source; values follow the assignment sheet.
``get_config(name)`` resolves by arch id; ``ARCHS`` lists all ten.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.recurrentgemma_9b import CONFIG as recurrentgemma_9b
from repro_torch.configs.qwen3_moe_235b import CONFIG as qwen3_moe_235b
from repro_torch.configs.phi35_moe_42b import CONFIG as phi35_moe_42b
from repro_torch.configs.qwen15_110b import CONFIG as qwen15_110b
from repro_torch.configs.mistral_nemo_12b import CONFIG as mistral_nemo_12b
from repro_torch.configs.gemma_7b import CONFIG as gemma_7b
from repro_torch.configs.gemma2_9b import CONFIG as gemma2_9b
from repro_torch.configs.internvl2_76b import CONFIG as internvl2_76b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b

ARCHS = {
    "whisper-medium": whisper_medium,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "qwen1.5-110b": qwen15_110b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "gemma-7b": gemma_7b,
    "gemma2-9b": gemma2_9b,
    "internvl2-76b": internvl2_76b,
    "rwkv6-7b": rwkv6_7b,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ARCHS", "get_config"]
