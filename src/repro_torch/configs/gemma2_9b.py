"""gemma2-9b [dense]: 42L d_model=3584 16H (kv=8) head_dim=256 d_ff=14336
GeGLU, vocab=256000, alternating local(4096)/global attention, logit
softcaps (attn 50, final 30).
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    mixer_pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=8192,
    source="arXiv:2408.00118",
)
