"""PDE-operator PINN architecture: the multi-PDE scenario surface
(heat / wave / KdV / Allen-Cahn / 2-D Poisson / advection-diffusion /
Navier-Stokes streamfunction / Gray-Scott; mixed partials up to the 4th-order
psi_xxyy are served by polarization, and Gray-Scott trains one d_out=2
network against a stacked two-equation residual).

Wider than the paper's 3x24 Burgers net because the 2-D manufactured
solutions carry more structure.  The training-side knobs live on
``repro_torch.pinn.OperatorRunConfig``: ``engine`` takes a derivative-engine
spec ("ntp", "ntp/cuda", "autodiff") and ``network`` a registered
architecture built on the jet-module layer ("dense", "mlp", "residual",
"fourier", "transformer" -- see ``repro_torch.core.network``); transformer
extras ride
``net_kwargs`` (``{"n_heads": 2, "mlp_ratio": 2, "mask": None}``; ``mask``
accepts ``None``/"none", ``"causal"``, or ``("local", W)`` and flows to
``SelfAttention`` -- every variant runs through the same single-launch
flash-jet kernel under ``ntp/cuda``; the attention trunk tokenizes the
d_in input coordinates, so n_heads/head_dim below describe the default
attention shape, not a sequence model).  d_in follows the operator
(2 for the (t, x) PDEs, 3 for advection-diffusion's (t, x, y))."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pinn-pde",
    family="pinn",
    n_layers=3,
    d_model=32,          # width (d_model for network="transformer")
    n_heads=2,           # transformer trunk default (width % n_heads == 0)
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,             # transformer feed-forward = mlp_ratio(2) * width
    vocab=2,             # d_in = 2 (t, x) or (x, y); d_out follows op.d_out
    attn_pattern=("global",),
    dtype="float64",
    source="[operator subsystem default: 3 hidden layers x 32 neurons, tanh;"
           " transformer trunk: 2 heads, mlp_ratio 2 over coordinate tokens]",
)
