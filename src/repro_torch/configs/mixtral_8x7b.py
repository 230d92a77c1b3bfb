"""mixtral-8x7b [arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts top-2,
SWA window 4096 (mistral lineage), head_dim 128."""

from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32_000,
    attn_pattern=("local",),
    window=4096,
    mlp="swiglu",
    moe=MoECfg(n_experts=8, top_k=2, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    scan_group=2,
    source="[arXiv:2401.04088; hf]",
)
