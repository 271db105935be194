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

Both entry points take a stack of f64 key rows, one ε a row and, for PGM,
an optional live count a row on the device; one launch covers every
table.  The arithmetic is the reference's f64, max/min propagating NaN as
``jnp.maximum``/``jnp.minimum`` do.

- :func:`corridor_scan`: a fresh carry every ``chunk`` elements, one
  thread a row, keys staged in shared memory (the fast fit's blocks;
  ``chunk >= length`` walks a whole table in one thread, the exact form's
  oracle on the card).  Twin: :func:`corridor_scan_twin`, a loop over a
  row's elements vectorised over the rows.
- :func:`corridor_scan_exact`: the exact fit in parallel, one cooperative
  launch: every chunk of ``chunk`` elements walked from a fresh carry
  (speculate), again from its predecessor's end carry until the two walks
  flag the same element (correct; after a flag the carry depends on the
  element alone), and, one block a row, the chunks after each one that
  did not sync walked from the true carry until they meet the flags
  already written (resolve).  Each walk is one block's: a prefix max/min
  of the cone's quotients over a window of 4,096 elements a round.  Twin:
  :func:`corridor_scan_exact_twin`, the same three phases (the chunk walks
  a loop over a chunk's elements, the resolve's window as
  ``cummax``/``cummin``).

Bound on the H100: the bytes (0.045 ms for 4 × 2^22 keys), and for the
exact form on long segments the resolve's f64 divisions on one SM a row
and a block round a segment (``corridor_bench.py`` times it).
"""

from __future__ import annotations

import torch

from . import cuda_lib

#: kernel launches of either form (CUDA path only); reset by callers that count them
LAUNCHES = 0
#: launches of the exact form's kernel, counted in ``LAUNCHES`` too
EXACT_LAUNCHES = 0

#: the recurrences and their kernel mode numbers
RECURRENCES = {"pgm": 0, "rs": 1}

#: the exact kernel's chunk: one walk window, long enough for the walks of
#: short segments to meet within a chunk (PERF.md)
EXACT_CHUNK = 4096
#: the twin's chunk on the CPU: its chunk walks are a Python loop over a
#: chunk's elements, so a short one is cheaper; the chunk changes no flag
TWIN_CHUNK = 256
#: elements the exact form's resolve walks a round (the kernel's block of
#: 512 threads, 8 elements a thread)
EXACT_WINDOW = 4096


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


def _rows(keys, eps, recurrence: str, length: int, chunk: int, count):
    """The stack cut into rows of ``chunk`` elements: the step inputs
    (element, previous key for RS, rank) as ``(rows, chunk)`` columns,
    the validity (past ``length`` or the row's ``count``: False), ε a row
    and a fresh carry a row (PGM's constant init, RS's anchor at the row's
    first point)."""
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
        cols = (blocks(keys[:, :length]), None,
                blocks(idx[:length].to(torch.float64).expand(n_tables, length)))
        zero = torch.zeros(rows, dtype=torch.float64, device=dev)
        fresh = (zero, zero - 1.0, zero, zero + float("inf"))
    elif recurrence == "rs":
        xp = blocks(keys[:, :length])
        cols = (blocks(keys[:, 1:length + 1]), xp,
                blocks((idx[:length] + 1).to(torch.float64).expand(n_tables, length)))
        inf = torch.full((rows,), float("inf"), dtype=torch.float64, device=dev)
        fresh = (xp[:, 0], cols[2][:, 0] - 1.0, -inf, inf)
    else:
        raise ValueError(f"unknown recurrence {recurrence!r}; choose from {tuple(RECURRENCES)}")
    return cols, v, e, fresh, n_blocks


def _walk_rows(recurrence: str, carry, cols, v, e, spec=None):
    """Walk every row of the columns from ``carry``: ``(carry, flags,
    met)``.  With ``spec`` (flags a walk from another carry wrote), a row
    rewrites them until both walks flag one element (a row's first element
    counts as flagged by ``spec``: the fresh start leaves a flag's carry)
    and stops there (``met``); past it the flags stay ``spec``'s."""
    x, xp, r = cols
    rows, chunk = v.shape
    flags = torch.zeros_like(v) if spec is None else spec.clone()
    met = torch.zeros(rows, dtype=torch.bool, device=v.device)
    for j in range(chunk):
        vj = v[:, j] if spec is None else v[:, j] & ~met
        if recurrence == "pgm":
            carry, f = _pgm_step(carry, x[:, j], r[:, j], vj, e)
        else:
            carry, f = _rs_step(carry, x[:, j], xp[:, j], r[:, j], vj, e)
        if spec is None:
            flags[:, j] = f
        else:
            flags[:, j] = torch.where(vj, f, flags[:, j])
            met = met | (f & (spec[:, j] | (j == 0)))
    return carry, flags, met


def corridor_scan_twin(keys, eps, *, recurrence: str, length: int, chunk: int, count=None):
    """The blocked kernel's recurrence in plain PyTorch, on any device:
    ``(N, length)`` bool flags of the rows of ``keys`` (``(N, stride)``
    f64), every ``chunk`` elements a fresh row (``chunk >= length``: one
    row a table).  Elements past ``length`` or the row's ``count`` leave
    the carry as it is and flag False, the reference's validity input."""
    cols, v, e, fresh, n_blocks = _rows(keys, eps, recurrence, length, chunk, count)
    _, flags, _ = _walk_rows(recurrence, fresh, cols, v, e)
    return flags.reshape(keys.shape[0], n_blocks * chunk)[:, :length]


def _window_walk(recurrence: str, k, f, e, carry, start: int, live: int, window: int):
    """The resolve's walk of one row from element ``start`` under the true
    ``carry`` (0-d tensors), ``window`` elements a round: under a fixed
    anchor the cone's bounds are running max/min of per-element quotients
    (``cummax``/``cummin``, NaN absorbing as the kernel's max/min), and the
    first failed test ends the segment.  Rewrites ``f`` (the row's flags)
    until it flags an element ``f`` flags too: returns that element, or
    ``live`` with the end carry."""
    x0, y0, lo, hi = carry
    dev = k.device
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    for w0 in range(start, live, window):
        w1 = min(w0 + window, live)
        sub = w0
        while True:
            j = torch.arange(sub, w1, device=dev)
            r = (j + (recurrence == "rs")).to(torch.float64)
            dx = k[j + (recurrence == "rs")] - x0
            dy = r - y0
            ta, tb = (dy - e) / dx, (dy + e) / dx
            run_lo = torch.cummax(torch.cat([lo.reshape(1), ta]), 0).values
            run_hi = torch.cummin(torch.cat([hi.reshape(1), tb]), 0).values
            if recurrence == "pgm":
                bad = (run_lo[1:] > run_hi[1:]) | (y0 < 0.0)
            else:
                slope = dy / dx
                bad = (slope < run_lo[:-1]) | (slope > run_hi[:-1])
            if not bool(bad.any()):
                f[sub:w1] = False
                lo, hi = run_lo[-1], run_hi[-1]
                break
            v = sub + int(torch.argmax(bad.to(torch.uint8)))
            f[sub:v] = False
            if bool(f[v]):
                return v, (x0, y0, lo, hi)
            f[v] = True
            if recurrence == "pgm":
                x0, y0, lo, hi = k[v], r[v - sub], lo.new_zeros(()), inf
            else:
                x0, y0 = k[v], r[v - sub] - 1.0
                ddx, ddy = k[v + 1] - x0, r[v - sub] - y0
                lo, hi = (ddy - e) / ddx, (ddy + e) / ddx
            sub = v + 1
            if sub >= w1:
                break
    return live, (x0, y0, lo, hi)


def corridor_scan_exact_twin(keys, eps, *, recurrence: str, length: int, count=None,
                             chunk: int = TWIN_CHUNK, window: int = EXACT_WINDOW):
    """The exact form's three phases in plain PyTorch, on any device: the
    flags of :func:`corridor_scan_twin` with ``chunk >= length`` (the
    serial walk), computed as the kernel computes them.  Speculate and
    correct are vectorised over the chunks and loop over a chunk's
    ``chunk`` elements; the resolve loops over the tables and walks
    ``window`` elements a round (:func:`_window_walk`)."""
    n_tables = keys.shape[0]
    if length == 0:
        return torch.zeros((n_tables, 0), dtype=torch.bool, device=keys.device)
    chunk = min(int(chunk), length)
    cols, v, e, fresh, nb = _rows(keys, eps, recurrence, length, chunk, count)
    ends, spec, _ = _walk_rows(recurrence, fresh, cols, v, e)
    first = (torch.arange(v.shape[0], device=v.device) % nb) == 0
    prev = tuple(torch.roll(a, 1) for a in ends)
    corr, flags, synced = _walk_rows(recurrence, prev, cols, v & ~first[:, None], e, spec=spec)
    flags = flags.reshape(n_tables, nb * chunk)
    for t in range(n_tables):
        live = length if count is None else max(0, min(length, int(count[t])))
        nc = -(-live // chunk)
        row = slice(t * nb, (t + 1) * nb)
        ok, end = synced[row], tuple(a[row] for a in corr)
        g = 1
        while g < nc:
            lag = torch.nonzero(~ok[g:nc])
            if lag.numel() == 0:
                break
            u = g + int(lag[0])
            carry, g = tuple(a[u] for a in end), u + 1
            while g < nc:
                met, carry = _window_walk(recurrence, keys[t], flags[t], eps[t], carry, g * chunk,
                                          live, window)
                if met >= live:
                    g = nc
                    break
                g = met // chunk
                if bool(ok[g]):
                    g += 1
                    break  # its end carry is the speculative one: scan on
                carry, g = tuple(a[g] for a in end), g + 1
    return flags[:, :length]


def _check(keys, eps, count, recurrence: str, length: int, chunk: int) -> int:
    """Validate the operands; returns the number of tables."""
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
    if length < 0 or reach > stride or chunk < 1 or n_tables >= 2**31 or length >= 2**31 - 64:
        raise ValueError(f"need 0 <= length (+1 for rs) <= {stride} keys and chunk >= 1, got "
                         f"length={length}, chunk={chunk}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"corridor_scan runs on cuda or cpu tensors, not {dev}")
    return n_tables


def corridor_scan(keys, eps, *, recurrence: str, length: int, chunk: int, count=None):
    """``(N, length)`` bool flags of the corridor recurrence over each row
    of ``keys`` (contiguous ``(N, stride)`` f64), a fresh carry every
    ``chunk`` elements, one launch for every row: segment starts for
    ``recurrence="pgm"`` (element ``j`` is key ``j``), knots for ``"rs"``
    (element ``j`` is the point ``j + 1`` seen from ``j``, so ``length <=
    stride - 1``).  ``eps`` holds one f64 a row and ``count``, when given,
    one int64 a row: the live prefix, read on the device.  CPU tensors
    take :func:`corridor_scan_twin`; CUDA tensors launch the kernel."""
    n_tables = _check(keys, eps, count, recurrence, length, chunk)
    dev = keys.device
    if dev.type == "cpu":
        return corridor_scan_twin(keys, eps, recurrence=recurrence, length=length, chunk=chunk,
                                  count=count)
    out = torch.zeros((n_tables, length), dtype=torch.bool, device=dev)
    if n_tables == 0 or length == 0:
        return out
    cuda_lib.launch(
        "corridor_scan_launch", dev, keys.data_ptr(), keys.shape[1], n_tables, length,
        min(chunk, length), RECURRENCES[recurrence], eps.data_ptr(),
        None if count is None else count.data_ptr(), out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1
    return out


def corridor_scan_exact(keys, eps, *, recurrence: str, length: int, count=None, chunk=None):
    """The exact fit: the flags of one carry walked through each whole row
    (:func:`corridor_scan` with ``chunk >= length``, the same operands),
    computed in parallel over chunks of ``chunk`` elements (default
    ``EXACT_CHUNK`` on the card, ``TWIN_CHUNK`` on the CPU; no chunk
    changes a flag) in one launch with no host sync (scratch allocated
    here: two carries and a byte a chunk).  CPU tensors take
    :func:`corridor_scan_exact_twin`; CUDA tensors launch the kernel."""
    dev = keys.device
    if chunk is None:
        chunk = TWIN_CHUNK if dev.type == "cpu" else EXACT_CHUNK
    n_tables = _check(keys, eps, count, recurrence, length, chunk)
    if dev.type == "cpu":
        return corridor_scan_exact_twin(keys, eps, recurrence=recurrence, length=length,
                                        count=count, chunk=chunk)
    out = torch.zeros((n_tables, length), dtype=torch.bool, device=dev)
    if n_tables == 0 or length == 0:
        return out
    chunk = min(chunk, length)
    scratch = torch.empty(n_tables * -(-length // chunk) * 65, dtype=torch.uint8, device=dev)
    cuda_lib.launch(
        "corridor_exact_launch", dev, keys.data_ptr(), keys.shape[1], n_tables, length, chunk,
        RECURRENCES[recurrence], eps.data_ptr(), None if count is None else count.data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
    )
    global LAUNCHES, EXACT_LAUNCHES
    LAUNCHES += 1
    EXACT_LAUNCHES += 1
    return out
