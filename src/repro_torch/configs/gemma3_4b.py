"""gemma3-4b [hf:google/gemma-3-1b-pt; unverified]

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, 5:1 local:global
interleaving (window 1024), head_dim 256, GeGLU, RoPE theta 1M on global
layers (we use a single theta; noted adaptation)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262_144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    mlp="geglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    # 8 q-heads don't divide the 16-way model axis: the reference replicates
    # the attention weights (a sharding knob; one card shards nothing)
    attn_sharding="replicate",
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
