"""LR schedules, pure functions of the step counter (counterpart of
``repro.train.schedule``), computed in f32 tensors as the reference's
are, not in Python floats."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000, floor: float = 0.1):
    # step+1: the first optimizer step must not be a zero-LR no-op
    s = _f32(step) + 1.0
    w = torch.clamp(s / max(warmup, 1), max=1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return w * cos


def constant(step, **_):
    return torch.tensor(1.0, dtype=torch.float32,
                        device=step.device if torch.is_tensor(step) else None)


def inv_sqrt(step, *, warmup: int = 100, **_):
    s = torch.clamp(_f32(step), min=1.0)
    return torch.minimum(s / max(warmup, 1),
                         torch.sqrt(torch.tensor(float(max(warmup, 1)), dtype=torch.float32,
                                                 device=s.device) / s))


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant, "inv_sqrt": inv_sqrt}
