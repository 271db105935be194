"""Greedy ε-corridor scan — the sequential recurrence of the device fits
(CUDA source: ``csrc/corridor_scan.cu``).

The reference runs it as a ``lax.scan`` of a step function:
``repro/core/cdf.py:chunked_corridor_scan`` (the exact fit, one carry
through the whole table) and ``blocked_corridor_scan`` (the fast fit's
vmapped blocks, each re-anchored at its first element), over
``repro/core/pgm.py:_pgm_corridor_step`` (PGM's anchored cone) and
``repro/core/radix_spline.py:_rs_corridor_step`` (RadixSpline's
GreedySplineCorridor).  It is no Pallas kernel there; here it has to be
one, because PyTorch has no scan and a step in eager code is ~15 launches.

:func:`corridor_scan` takes a stack of f64 key rows, one ε a row and, for
PGM, an optional live count a row on the device; one launch covers every
table and every block.  Each thread of the kernel walks one row (a whole
table, or a block of ``chunk`` elements) through the recurrence with the
reference's f64 arithmetic, max/min propagating NaN as ``jnp.maximum``/
``jnp.minimum`` do.  :func:`corridor_scan_twin` is the same recurrence as
a loop over the elements, vectorised over the rows: the CPU path and the
yardstick of the kernel on the card.

Bound on the H100: a thread's serial steps, not the bytes: the exact
form is ``length`` steps in series, each with two f64 divisions, a max,
a min, a compare and the selects (``corridor_bench.py`` times it).
"""

from __future__ import annotations

import torch

from . import cuda_lib

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0

#: the recurrences and their kernel mode numbers
RECURRENCES = {"pgm": 0, "rs": 1}


def _pgm_step(carry, x, r, v, eps):
    """One PGM anchored-cone step over a column of rows (the reference's
    ``_pgm_corridor_step``): returns the new carry and the flags."""
    x0, s, lo, hi = carry
    dx = x - x0
    dy = r - s
    new_lo = torch.maximum(lo, (dy - eps) / dx)
    new_hi = torch.minimum(hi, (dy + eps) / dx)
    bad = (new_lo > new_hi) | (s < 0.0)
    nxt = (torch.where(bad, x, x0), torch.where(bad, r, s),
           torch.where(bad, 0.0, new_lo), torch.where(bad, float("inf"), new_hi))
    return tuple(torch.where(v, a, b) for a, b in zip(nxt, carry)), bad & v


def _rs_step(carry, xi, xp, r, v, eps):
    """One GreedySplineCorridor step over a column of rows (the
    reference's ``_rs_corridor_step``)."""
    x0, y0, lo, hi = carry
    slope = (r - y0) / (xi - x0)
    bad = (slope < lo) | (slope > hi)
    x0n = torch.where(bad, xp, x0)
    y0n = torch.where(bad, r - 1.0, y0)
    dx = xi - x0n
    dy = r - y0n
    lo_b = (dy - eps) / dx
    hi_b = (dy + eps) / dx
    nxt = (x0n, y0n, torch.where(bad, lo_b, torch.maximum(lo, lo_b)),
           torch.where(bad, hi_b, torch.minimum(hi, hi_b)))
    return tuple(torch.where(v, a, b) for a, b in zip(nxt, carry)), bad & v


def corridor_scan_twin(keys, eps, *, recurrence: str, length: int, chunk: int, count=None):
    """The kernel's recurrence in plain PyTorch, on any device: ``(N,
    length)`` bool flags of the rows of ``keys`` (``(N, stride)`` f64),
    every ``chunk`` elements a fresh row (``chunk >= length``: one row a
    table).  Elements past ``length`` or the row's ``count`` leave the
    carry as it is and flag False, the reference's validity input."""
    n_tables, dev = keys.shape[0], keys.device
    n_blocks = -(-length // chunk)
    padded = n_blocks * chunk
    idx = torch.arange(padded, device=dev)
    valid = (idx < length)[None, :].expand(n_tables, padded)
    if count is not None:
        valid = valid & (idx[None, :] < count[:, None])
    pad = padded - length

    def blocks(a):
        return torch.nn.functional.pad(a, (0, pad)).reshape(n_tables * n_blocks, chunk)

    v = valid.reshape(n_tables * n_blocks, chunk)
    e = eps.to(torch.float64).repeat_interleave(n_blocks)
    rows = n_tables * n_blocks
    if recurrence == "pgm":
        x = blocks(keys[:, :length])
        r = blocks(idx[:length].to(torch.float64).expand(n_tables, length))
        zero = torch.zeros(rows, dtype=torch.float64, device=dev)
        carry = (zero, zero - 1.0, zero, zero + float("inf"))
    elif recurrence == "rs":
        xi, xp = blocks(keys[:, 1:length + 1]), blocks(keys[:, :length])
        r = blocks((idx[:length] + 1).to(torch.float64).expand(n_tables, length))
        inf = torch.full((rows,), float("inf"), dtype=torch.float64, device=dev)
        carry = (xp[:, 0], r[:, 0] - 1.0, -inf, inf)
    else:
        raise ValueError(f"unknown recurrence {recurrence!r}; choose from {tuple(RECURRENCES)}")
    flags = torch.zeros((rows, chunk), dtype=torch.bool, device=dev)
    for j in range(chunk):
        if recurrence == "pgm":
            carry, flags[:, j] = _pgm_step(carry, x[:, j], r[:, j], v[:, j], e)
        else:
            carry, flags[:, j] = _rs_step(carry, xi[:, j], xp[:, j], r[:, j], v[:, j], e)
    return flags.reshape(n_tables, padded)[:, :length]


def corridor_scan(keys, eps, *, recurrence: str, length: int, chunk: int, count=None):
    """``(N, length)`` bool flags of the corridor recurrence over each row
    of ``keys`` (contiguous ``(N, stride)`` f64), one launch for every
    row: segment starts for ``recurrence="pgm"`` (element ``j`` is key
    ``j``), knots for ``"rs"`` (element ``j`` is the point ``j + 1`` seen
    from ``j``, so ``length <= stride - 1``).  A fresh carry starts every
    ``chunk`` elements; ``eps`` holds one f64 a row and ``count``, when
    given, one int64 a row: the live prefix, read on the device.  CPU
    tensors take :func:`corridor_scan_twin`; CUDA tensors launch the
    kernel."""
    dev = keys.device
    if recurrence not in RECURRENCES:
        raise ValueError(f"unknown recurrence {recurrence!r}; choose from {tuple(RECURRENCES)}")
    n_tables = keys.shape[0] if keys.dim() == 2 else -1
    cuda_lib.require_rows(keys, "keys", torch.float64, dev, n_tables)
    cuda_lib.require(eps, "eps", torch.float64, dev, n_tables)
    if count is not None:
        cuda_lib.require(count, "count", torch.int64, dev, n_tables)
    stride = keys.shape[1]
    reach = length + (1 if recurrence == "rs" else 0)
    if length < 0 or reach > stride or chunk < 1 or n_tables >= 2**31:
        raise ValueError(f"need 0 <= length (+1 for rs) <= {stride} keys and chunk >= 1, got "
                         f"length={length}, chunk={chunk}")
    if dev.type == "cpu":
        return corridor_scan_twin(keys, eps, recurrence=recurrence, length=length, chunk=chunk,
                                  count=count)
    if dev.type != "cuda":
        raise ValueError(f"corridor_scan runs on cuda or cpu tensors, not {dev}")
    out = torch.zeros((n_tables, length), dtype=torch.bool, device=dev)
    if n_tables == 0 or length == 0:
        return out
    cuda_lib.launch(
        "corridor_scan_launch", dev, keys.data_ptr(), stride, n_tables, length, min(chunk, length),
        RECURRENCES[recurrence], eps.data_ptr(), None if count is None else count.data_ptr(),
        out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1
    return out
