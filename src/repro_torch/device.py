"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card: it raises when CUDA is absent, so the CPU
    runs only when a caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def wait_for(t: torch.Tensor) -> torch.Tensor:
    """Wait until ``t``'s card has finished the work queued so far, if
    ``t`` lies on one (a wall-clock timing then covers the device work);
    returns ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t
