"""The port's configuration record for the PINN architectures.

The reference describes every model, its LLM pool included, with one large
``ArchConfig`` (``configs/base.py``).  The port runs only the two PINN
architectures so far, so it keeps a small record with the fields those two
set, under the reference's field names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int                     # width (d_model for the transformer)
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int                       # PINN nets: d_in (coordinates)
    head_dim: int = 0                # 0 -> d_model // n_heads
    attn_pattern: Tuple[str, ...] = ("global",)
    dtype: str = "float32"
    source: str = ""
