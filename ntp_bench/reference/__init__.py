"""The plain reference: Taylor-mode arithmetic in plain PyTorch, written
from the recurrences of the power series, the networks of the
configurations, their derivative tables and the training objectives.
Nothing here imports ``jax``, the JAX package or the port (``repro_torch``):
it takes the seeded inputs and weights and works everything else out
again."""
