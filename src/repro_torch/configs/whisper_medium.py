"""whisper-medium [audio]: enc-dec, conv frontend stubbed to frame embeds.

24L (per stack) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    use_rope=False,
    qkv_bias=True,
    tie_embeddings=True,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    frontend="audio",
    frontend_seq_len=1500,   # 30s of audio at 50 Hz after conv stride-2
    max_seq_len=448,
    source="arXiv:2212.04356",
)
