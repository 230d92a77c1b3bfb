"""qwen3-0.6b [hf:Qwen/Qwen3-8B; hf]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, qk_norm, head_dim 128,
SwiGLU, full global attention every layer."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151_936,
    attn_pattern=("global",),
    mlp="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    scan_group=2,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
