"""internvl2-76b [vlm]: InternViT frontend (stubbed to patch embeddings) +
Llama-3-70B-class backbone: 80L d_model=8192 64H (kv=8) d_ff=28672,
vocab=128256.
[arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    frontend="vision",
    frontend_seq_len=256,    # 256 visual tokens per image tile
    max_seq_len=8192,
    source="arXiv:2404.16821",
)
