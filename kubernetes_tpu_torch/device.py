"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller names another device.
Without a CUDA device they raise rather than carry on on the CPU: a
result computed on the CPU must never be reported as the card's.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist, and a bare
    ``cuda`` becomes the current one (``cuda:N``), so devices compare
    equal to those of the tensors made on them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
