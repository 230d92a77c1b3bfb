"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
SWA 4096, head_dim 128.  Anyres tiling is a stub: the batch carries 2880
precomputed patch embeddings (5 tiles x 576; ``data.tokens.synthetic_batch``)
fused at the front of the token sequence through a learned projector."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
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
    vlm_image_tokens=2880,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    scan_group=2,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)
