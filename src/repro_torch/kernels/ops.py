"""The kernels' public entry points (counterpart of ``repro.kernels.ops``).

Host re-encoders of fitted models into the search kernels' f32/i32
arithmetic, with ε re-measured: the kernels predict in f32 on the
pre-normalised coordinate ``u``; these functions re-measure every leaf's
(or level's) error with exactly that arithmetic and widen ε so the window
stays a guarantee.  The +2 margin budgets one fused multiply-add, so the
CUDA kernels compile with ``-fmad=false`` and the twins run unfused eager
ops.

``embedding_bag`` and ``decode_attention`` take the signatures and the
semantics of the reference's entry points, numpy arrays or tensors alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.cdf import ceil_log2
from repro_torch.core.keys import unit_f32
from repro_torch.core.search import f64_to_i64
from repro_torch.device import resolve_device

from . import decode_attention as _attention
from . import embedding_bag as _bag


def rmi_kernel_arrays(model, table_np: np.ndarray):
    """Re-encode an :class:`~repro_torch.core.rmi.RMIModel` in kernel
    precision.  Returns ``(arrays, steps)``: f32/i32 leaf parameters
    (``root``, ``slope``, ``icept``, ``eps``, ``rlo``, ``rhi``) and the
    unbucketed trip count of the window search."""
    n = model.n
    b = model.b
    kmin = np.float64(model.kmin)
    inv_span = np.float64(model.inv_span)

    u64 = (table_np.astype(np.float64) - kmin) * inv_span
    u32 = np.clip(u64, 0.0, 1.0).astype(np.float32)

    root = np.asarray(model.root_coef, dtype=np.float32)
    slopes = np.asarray(model.leaf_slope, dtype=np.float32)
    icepts = np.asarray(model.leaf_icept, dtype=np.float32)

    # leaf assignment with kernel arithmetic (f32)
    p_root = ((root[3] * u32 + root[2]) * u32 + root[1]) * u32 + root[0]
    leaf = np.clip(np.floor(p_root.astype(np.float64) * (b / n)), 0, b - 1).astype(np.int64)
    leaf = np.maximum.accumulate(leaf)
    r32 = np.searchsorted(leaf, np.arange(b + 1), side="left").astype(np.int64)

    # f32 leaf prediction error at every key (exactly the kernel math)
    pred = slopes[leaf] * u32 + icepts[leaf]
    ranks = np.arange(n, dtype=np.float64)
    err = np.abs(pred.astype(np.float64) - ranks)
    eps = np.zeros(b)
    np.maximum.at(eps, leaf, err)
    # extended boundary keys per leaf (the guarantee argument)
    lo_idx = np.clip(r32[:-1] - 1, 0, n - 1)
    hi_idx = np.clip(r32[1:], 0, n - 1)
    err_lo = np.abs(slopes * u32[lo_idx] + icepts - ranks[lo_idx])
    err_hi = np.abs(slopes * u32[hi_idx] + icepts - ranks[hi_idx])
    eps = np.maximum(eps, np.maximum(err_lo, err_hi))
    eps_i = np.minimum(np.ceil(eps) + 2, float(n)).astype(np.int32)

    rlo = np.maximum(r32[:-1] - 1, 0).astype(np.int32)
    # high fence r32[l+1] (not -1): absorbs a 1-ulp leaf flip between this
    # re-encoding and the kernel's f32 root evaluation
    rhi = np.clip(r32[1:], 0, n - 1).astype(np.int32)
    widths = np.minimum(2 * eps_i.astype(np.int64) + 3, (rhi - rlo + 1).astype(np.int64))
    max_window = max(1, int(widths.max()))
    steps = max(1, int(math.ceil(math.log2(max(max_window, 2)))))

    arrays = {"root": root, "slope": slopes, "icept": icepts, "eps": eps_i, "rlo": rlo, "rhi": rhi}
    return arrays, steps


def pgm_kernel_arrays(model, table_np: np.ndarray):
    """Re-encode a :class:`~repro_torch.core.pgm.PGMModel` for the PGM
    descent kernel.  Each segment predicts ``r0 + slope_u * max(u - u0, 0)``
    in f32 with ``slope_u = slope * span``; the error of that arithmetic is
    re-measured at every child entry of every level.

    Returns ``(arrays, steps)``: level-concatenated f32 ``u0``/``slope``,
    the widened scalar ``eps`` and the f64 ``kmin``/``inv_span`` of ``u``;
    ``steps`` is the unbucketed trip count of every in-kernel search."""
    n = model.n
    kmin = np.float64(table_np[0])
    span = np.float64(table_np[-1]) - kmin
    inv_span = np.float64(1.0) / span if span > 0 else np.float64(1.0)

    def u_of(keys_u64):
        u = (keys_u64.astype(np.float64) - kmin) * inv_span
        return np.clip(u, 0.0, 1.0).astype(np.float32)

    levels = len(model.level_keys)
    u0_parts, slope_parts = [], []
    max_err = 0.0
    for lvl in range(levels):
        keys_l = np.asarray(model.level_keys[lvl])
        u0_l = u_of(keys_l)
        slope_u = (np.asarray(model.level_slope[lvl]) * span).astype(np.float32)
        u0_parts.append(u0_l)
        slope_parts.append(slope_u)
        child = np.asarray(model.level_keys[lvl + 1]) if lvl + 1 < levels else table_np
        # exact segment assignment — the kernel routes with exact key compares
        s = np.clip(np.searchsorted(keys_l, child, side="right") - 1, 0, len(keys_l) - 1)
        r0 = np.asarray(model.level_rank0[lvl])[s].astype(np.float32)
        du = np.maximum(u_of(child) - u0_l[s], np.float32(0.0))
        pred = r0 + slope_u[s] * du  # the kernel's f32 arithmetic, verbatim
        err = np.abs(pred.astype(np.float64) - np.arange(len(child), dtype=np.float64))
        if len(err):
            max_err = max(max_err, float(err.max()))
    # +2: one for between-keys interpolation drift beyond the widened ±1
    # the query path already adds, one for a fused multiply-add
    eps = int(min(np.ceil(max_err) + 2, n))
    steps = ceil_log2(min(2 * (eps + 1) + 3, max(n, 2)))
    arrays = {
        "u0": np.concatenate(u0_parts),
        "slope": np.concatenate(slope_parts),
        "eps": eps,
        "kmin": kmin,
        "inv_span": inv_span,
    }
    return arrays, steps


def rs_kernel_arrays(model, table_np: np.ndarray):
    """Re-encode a :class:`~repro_torch.core.radix_spline.RSModel` for the
    fused RadixSpline kernel.  Interpolation between knots is re-anchored
    in f32 ``u`` space with a per-knot-segment slope,
    ``pred = y1 + slope_j * max(u - u0_j, 0)``; the error of that exact
    arithmetic is re-measured at every table key *and* at every knot
    evaluated under its left neighbour's segment (the boundary a query
    just below a knot reaches), and ε widens to match.

    Returns ``(arrays, steps)``: f32 ``u0``/``slope`` per knot, the
    widened scalar ``eps`` and the f64 ``kmin``/``inv_span`` of ``u``;
    ``steps`` is the unbucketed trip count of the table search."""
    n = model.n
    m = model.m
    knot_keys = np.asarray(model.knot_keys)[:m]
    knot_ranks = np.asarray(model.knot_ranks)[:m]
    kmin = np.float64(np.asarray(model.kmin))
    span = np.float64(table_np[-1]) - kmin
    inv_span = np.float64(1.0) / span if span > 0 else np.float64(1.0)

    def u_of(keys_u64):
        u = (keys_u64.astype(np.float64) - kmin) * inv_span
        return np.clip(u, 0.0, 1.0).astype(np.float32)

    u0 = u_of(knot_keys)
    slope = np.zeros(m, dtype=np.float32)
    if m >= 2:
        dy = (knot_ranks[1:] - knot_ranks[:-1]).astype(np.float32)
        du = u0[1:] - u0[:-1]
        # knot pairs that collide in f32 u predict y1 flat; the measured
        # ε absorbs the rank span they cover
        np.divide(dy, du, out=slope[:-1], where=du > 0)
        j = np.clip(np.searchsorted(knot_keys, table_np, side="right") - 1, 0, m - 2)
        y1 = knot_ranks[j].astype(np.float32)
        pred = y1 + slope[j] * np.maximum(u_of(table_np) - u0[j], np.float32(0.0))
        err = np.abs(pred.astype(np.float64) - np.arange(n, dtype=np.float64))
        # boundary extension: each knot under its left segment's model
        pred_b = knot_ranks[:-1].astype(np.float32) + slope[:-1] * np.maximum(du, np.float32(0.0))
        err_b = np.abs(pred_b.astype(np.float64) - knot_ranks[1:].astype(np.float64))
        max_err = max(float(err.max()), float(err_b.max()))
        eps = int(min(np.ceil(max_err) + 2, n))
    else:
        eps = max(int(n), 1)
    steps = ceil_log2(min(2 * eps + 3, max(n, 2)))
    arrays = {"u0": u0, "slope": slope, "eps": eps, "kmin": kmin, "inv_span": inv_span}
    return arrays, steps


def pgm_level_reencode_device(keys_l, slopes_l, start_l, nseg, child, child_count, kmin, span,
                              inv_span):
    """One level of :func:`pgm_kernel_arrays` as tensor ops: the level's
    f32 anchors ``u0`` and slopes ``slope * span``, and the largest error of
    the kernel's f32 prediction at each *live* child entry.  ``keys_l``
    (encoded, max-key pads past the ``nseg`` live segments, so the exact
    segment route stays right), ``slopes_l`` and ``start_l`` are
    capacity rows; ``child`` holds ``child_count`` live entries; ``nseg``,
    ``child_count``, ``kmin``, ``span`` and ``inv_span`` are 0-d tensors.
    Returns ``(u0_l, slope_u, max_err)``."""
    u0_l = unit_f32(keys_l, kmin, inv_span)
    slope_u = (slopes_l * span).to(torch.float32)
    s = torch.searchsorted(keys_l, child, right=True) - 1
    s = torch.minimum(torch.clamp(s, min=0), torch.clamp(nseg - 1, min=0))
    r0 = start_l[s].to(torch.float32)
    du = torch.clamp(unit_f32(child, kmin, inv_span) - u0_l[s], min=0.0)
    pred = r0 + slope_u[s] * du  # the kernel's f32 arithmetic
    cap = child.shape[0]
    idx = torch.arange(cap, device=child.device)
    err = torch.abs(pred.to(torch.float64) - idx.to(torch.float64))
    err = torch.where(idx < child_count, err, 0.0)
    return u0_l, slope_u, torch.amax(err)


def rs_kernel_arrays_device(knot_keys, knot_ranks, m_valid, table_row, kmin, span, inv_span):
    """:func:`rs_kernel_arrays` as tensor ops over a capacity knot row with
    ``m_valid`` live knots (encoded max-key keys and the last rank past
    them); every key of ``table_row`` counts (a device refresh fits the
    padded capacity table).  Returns ``(u0, slope, rk_eps)``, ``rk_eps`` the
    widened int32 bound with the host's ``ceil(max_err) + 2`` margin."""
    n = table_row.shape[0]
    cap = knot_keys.shape[0]
    dev = knot_keys.device
    u0 = unit_f32(knot_keys, kmin, inv_span)
    i = torch.arange(cap, device=dev)
    nxt = torch.clamp(i + 1, max=cap - 1)
    dy = (knot_ranks[nxt] - knot_ranks).to(torch.float32)
    du = u0[nxt] - u0
    valid_pair = (i + 1) < m_valid
    # knot pairs that collide in f32 u predict y1 flat, as on the host
    slope = torch.where(valid_pair & (du > 0), dy / torch.where(du > 0, du, 1.0), 0.0)
    slope = slope.to(torch.float32)
    j = torch.searchsorted(knot_keys, table_row, right=True) - 1
    j = torch.minimum(torch.clamp(j, min=0), torch.clamp(m_valid - 2, min=0))
    y1 = knot_ranks[j].to(torch.float32)
    pred = y1 + slope[j] * torch.clamp(unit_f32(table_row, kmin, inv_span) - u0[j], min=0.0)
    err = torch.abs(pred.to(torch.float64) - torch.arange(n, dtype=torch.float64, device=dev))
    # boundary extension: each knot under its left segment's model
    pred_b = knot_ranks.to(torch.float32) + slope * torch.clamp(du, min=0.0)
    err_b = torch.abs(pred_b.to(torch.float64) - knot_ranks[nxt].to(torch.float64))
    err_b = torch.where(valid_pair, err_b, 0.0)
    max_err = torch.maximum(torch.amax(err), torch.amax(err_b))
    rk_eps = f64_to_i64(torch.clamp(torch.ceil(max_err) + 2.0, max=float(n))).to(torch.int32)
    return u0, slope, rk_eps


# ---------------------------------------------------------------------------
# EmbeddingBag and flash-decode attention
# ---------------------------------------------------------------------------


def _device_of(arrays, device) -> torch.device:
    """The device of the first tensor among ``arrays``, else ``device``
    (the card when None)."""
    for a in arrays:
        if torch.is_tensor(a):
            return a.device
    return resolve_device(device)


def _on(x, dtype, dev) -> torch.Tensor:
    if torch.is_tensor(x):
        if x.dtype == dtype and x.device == dev and x.is_contiguous():
            return x  # the common case, without ``to``'s argument parsing
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev).contiguous()


def embedding_bag(table, ids, seg_ids, weights=None, *, num_bags: int, v_tile: int = 512,
                  device=None):
    """``out[b] = sum_{seg_ids[i] == b} weights[i] * table[ids[i]]``, (num_bags,
    D) f32; ``weights=None`` means ones.  Tensors stay on their device;
    numpy inputs go to ``device`` (the card when None).

    ``v_tile`` is the TPU kernel's vocabulary tile: the reference pads the
    vocabulary to a multiple of it with zero rows, which add nothing, as
    an id outside ``[0, V)`` adds nothing here, so it changes no result."""
    if v_tile <= 0:
        raise ValueError(f"v_tile must be positive, got {v_tile}")
    dev = _device_of((table, ids, seg_ids, weights), device)
    ids = _on(ids, torch.int32, dev)
    w = (torch.ones(ids.shape, dtype=torch.float32, device=dev) if weights is None
         else _on(weights, torch.float32, dev))
    return _bag.embedding_bag(_on(table, torch.float32, dev), ids, _on(seg_ids, torch.int32, dev),
                              w, num_bags=num_bags)


def decode_attention(q, k, v, kv_len, *, s_tile: int = 256, device=None):
    """One-token GQA attention, f32: ``q`` (B, Hq, D) over ``k``/``v`` (B, S,
    Hkv, D), positions ``< kv_len[b]`` of row b.  Tensors stay on their
    device; numpy inputs go to ``device`` (the card when None).

    As in the reference, the cache is padded with zero rows to a multiple
    of ``s_tile``; that matters only for a ``kv_len`` beyond S, whose extra
    positions are those zero rows.  Otherwise ``s_tile`` changes no result."""
    if s_tile <= 0:
        raise ValueError(f"s_tile must be positive, got {s_tile}")
    dev = _device_of((q, k, v, kv_len), device)
    q, k, v = (_on(x, torch.float32, dev) for x in (q, k, v))
    pad_s = (-k.shape[1]) % s_tile
    if pad_s:
        zk = torch.zeros((k.shape[0], pad_s, *k.shape[2:]), dtype=torch.float32, device=dev)
        k, v = torch.cat([k, zk], dim=1), torch.cat([v, zk], dim=1)
    return _attention.decode_attention(q, k, v, _on(kv_len, torch.int32, dev))
