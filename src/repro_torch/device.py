"""Device resolution for the port's entry points.

Every public constructor and driver takes ``device=`` and defaults to
``"cuda"``. A machine without a card raises instead of quietly running on
the CPU: the CPU path exists for the tests and must be asked for by name.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device`` with the card's
    index filled in; raises when a CUDA device is asked for and none is
    available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run the plain PyTorch path on "
                "the CPU")
        if dev.index is None:  # "cuda" means the current card, as tensors say
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
