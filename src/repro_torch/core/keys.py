"""Key encoding: uint64 keys as sign-flipped int64 on the device.

PyTorch's ``uint64`` dtype supports neither ``searchsorted`` nor
comparisons on every device, so keys are stored as ``int64`` with the
sign bit flipped (``k ^ (1 << 63)``).  The map is a bijection that keeps
the order: ``a <= b`` as unsigned exactly when ``enc(a) <= enc(b)`` as
signed, so the kernels compare keys with one signed 64-bit compare.
"""

from __future__ import annotations

import numpy as np
import torch

#: int64 with only the sign bit set; ``x ^ SIGN`` flips between encodings
SIGN = -(1 << 63)
_SIGN_NP = np.int64(SIGN)


def encode_np(keys_u64) -> np.ndarray:
    """uint64 keys -> sign-flipped int64 (host)."""
    return np.asarray(np.asarray(keys_u64, dtype=np.uint64).view(np.int64) ^ _SIGN_NP)


def decode_np(keys_i64) -> np.ndarray:
    """Sign-flipped int64 -> uint64 keys (host)."""
    return np.asarray(np.asarray(keys_i64, dtype=np.int64) ^ _SIGN_NP).view(np.uint64)


def encode(keys_u64, device) -> torch.Tensor:
    """uint64 keys (numpy) -> sign-flipped int64 tensor on ``device``."""
    return torch.from_numpy(encode_np(keys_u64)).to(device)


def decode(keys: torch.Tensor) -> np.ndarray:
    """Sign-flipped int64 tensor -> uint64 numpy keys."""
    return decode_np(keys.detach().cpu().numpy())


def as_keys(x, device) -> torch.Tensor:
    """Keys as an encoded tensor on ``device``: a numpy/list input is read
    as uint64 and encoded; a tensor must already be encoded int64."""
    if torch.is_tensor(x):
        if x.dtype != torch.int64:
            raise TypeError(f"key tensors must be sign-flipped int64, got {x.dtype}")
        return x.to(device).contiguous()
    return encode(np.asarray(x, dtype=np.uint64), device)


def to_f64(keys: torch.Tensor) -> torch.Tensor:
    """The uint64 value of each encoded key as float64, correctly rounded
    (equal to numpy's ``astype(np.float64)`` on the uint64 keys).

    The two 32-bit halves convert exactly; ``hi * 2**32`` is exact, so
    the one rounding is the final add, which IEEE rounds to nearest."""
    u = keys ^ SIGN
    hi = ((u >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (u & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + lo


def unit_f32(keys: torch.Tensor, kmin: torch.Tensor, inv_span: torch.Tensor) -> torch.Tensor:
    """The kernels' CDF coordinate ``u = clip((q - kmin) * inv_span, 0, 1)``,
    computed in float64 and rounded once to float32 (the reference's
    ``impls._rmi_pallas`` expression)."""
    u = (to_f64(keys) - kmin) * inv_span
    return torch.clamp(u, 0.0, 1.0).to(torch.float32)
