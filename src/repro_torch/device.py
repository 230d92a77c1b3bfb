"""Device resolution shared by every entry point of the port.

The port runs on the CUDA device by default.  ``device=None`` means "the
card": it resolves to ``cuda`` when one is present and raises otherwise, so
a missing GPU is never papered over by a silent CPU run.  Callers that want
the CPU (the tests) say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)`` unchanged."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
