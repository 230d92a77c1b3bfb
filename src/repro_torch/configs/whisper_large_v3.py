"""whisper-large-v3 [arXiv:2212.04356; unverified]

Enc-dec, 32+32L d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
Conv frontend is a stub: the batch carries the precomputed 1500-frame
embeddings (``data.tokens.synthetic_batch``).  seq_len in shapes refers to the decoder;
the encoder is fixed at 1500 frames.  Adaptations: rmsnorm+gelu
in place of layernorm+gelu, RoPE in place of learned/sinusoidal positions."""

from .base import ArchConfig, EncoderCfg

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51_866,
    attn_pattern=("global",),
    mlp="gelu_mlp",
    encoder=EncoderCfg(n_layers=32, seq=1500),
    rope_theta=10_000.0,
    tie_embeddings=True,
    scan_group=2,
    source="[arXiv:2212.04356; unverified]",
)
