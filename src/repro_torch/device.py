"""Device resolution shared by every entry point of the port.

The port runs on the CUDA device by default.  ``device=None`` means "the
card": it resolves to ``cuda`` when one is present and raises otherwise, so
a missing GPU is never papered over by a silent CPU run.  Callers that want
the CPU (the tests) say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> the current CUDA device; anything else ->
    ``torch.device(device)`` unchanged.  Either way a CUDA device raises
    when there is none."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return device if device is not None else torch.device("cuda", torch.cuda.current_device())
