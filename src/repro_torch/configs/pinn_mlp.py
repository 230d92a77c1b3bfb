"""The paper's own architecture: tanh MLP for PINN training (3x24 default).

The Burgers trainer (``repro_torch.pinn.trainer.train``) builds this net:
``PINNRunConfig(width=24, depth=3)`` with d_in = d_out = 1."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pinn-mlp",
    family="pinn",
    n_layers=3,
    d_model=24,          # width
    n_heads=1,
    n_kv_heads=1,
    head_dim=1,
    d_ff=24,
    vocab=1,             # d_in = d_out = 1 (self-similar Burgers profile)
    attn_pattern=("global",),
    dtype="float64",
    source="[paper section IV: 3 hidden layers x 24 neurons, tanh]",
)
