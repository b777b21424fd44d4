"""recurrentgemma-9b [hybrid]: Griffin — RG-LRU + local attention, 2:1.

38 blocks, pattern (rglru, rglru, attn_local); d_model=4096 16H (kv=1,
head_dim=256) d_ff=12288 GeGLU, vocab=256000, window=2048, lru_width=4096.
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mixer_pattern=("rglru", "rglru", "attn_local"),
    window=2048,
    mlp_type="geglu",
    rnn_width=4096,
    conv_width=4,
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=8192,
    source="arXiv:2402.19427",
)
