"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base; hf]

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155, SwiGLU, full attention."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49_155,
    attn_pattern=("global",),
    mlp="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scan_group=2,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf]",
)
