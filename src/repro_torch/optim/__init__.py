"""Optimizers: Adam/AdamW and strong-Wolfe L-BFGS, the reference's own."""

from .adam import AdamState, adam_init, adam_update
from .lbfgs import LBFGSResult, lbfgs
