"""gemma2-27b [arXiv:2408.00118; hf]

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, local(4096):global
alternation, attn softcap 50, final logit softcap 30, head_dim 128, GeGLU."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256_000,
    attn_pattern=("local", "global"),
    window=4096,
    mlp="geglu",
    attn_softcap=50.0,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="[arXiv:2408.00118; hf]",
)
