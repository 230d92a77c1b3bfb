"""Data pipelines: PINN collocation sampling and synthetic LM token batches."""

from . import collocation, tokens
