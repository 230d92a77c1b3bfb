"""rwkv6-3b (Finch) [arXiv:2404.05892; hf]

32L d_model=2560 attn-free, d_ff=8960 channel-mix, vocab=65536,
data-dependent per-channel decay, head size 64 (40 heads)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads = d_model / 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65_536,
    block_type="rwkv6",
    mlp="rwkv_channel_mix",
    tie_embeddings=True,
    scan_group=2,
    source="[arXiv:2404.05892; hf]",
)
