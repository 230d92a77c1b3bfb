"""Data pipelines: PINN collocation sampling."""

from . import collocation
