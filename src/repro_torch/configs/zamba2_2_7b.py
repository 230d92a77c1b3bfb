"""zamba2-2.7b [arXiv:2411.15242; hf]

54 Mamba2 blocks d_model=2560 (d_inner 5120, headdim 64, state 64) plus a
*shared* full-attention+MLP block (32H MHA kv=32, d_ff=10240) applied every 6
mamba blocks with tied weights -- the zamba2 topology.  vocab 32000."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32_000,
    block_type="mamba2",
    ssm_state=64,
    ssm_heads=80,            # d_inner 5120 / headdim 64
    hybrid_shared_attn_every=6,
    mlp="gelu_mlp",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scan_group=6,
    source="[arXiv:2411.15242; hf]",
)
