"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192, MoE 128 experts top-1 interleaved
with dense layers (llama4's "interleaved MoE"; period 2), vocab 202048,
iRoPE-style 3 local(8192):1 global pattern, head_dim 128.  "Early fusion" is
a modality-frontend property; this config is the text backbone."""

from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    attn_pattern=("local", "local", "local", "global"),
    window=8192,
    mlp="swiglu",
    moe=MoECfg(n_experts=128, top_k=1, capacity_factor=1.25, period=2),
    rope_theta=500_000.0,
    tie_embeddings=False,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
