"""Single-program shard refresh on the device: fit, assemble, install
(counterpart of ``repro.tune.device_fit``).

The host refresh (:func:`repro_torch.dist.sharded_index.refresh_shard`)
fits on the host, builds the leaves there and copies them in.
:func:`device_refresh` does it all on the device for the PGM and RS kinds:
pad the merged keys to the tier's capacity row, fit (``fit="fast"``: the
O(log n)-depth corridor fit; ``fit="scan"``: the exact scan, the host
build's model), assemble every stacked leaf (level recursion, the flat
concatenation at device offsets, radix table, the kernels' ``pk_*``/
``rk_*`` re-encodings), check capacities, fences and trip-count budgets,
and install, with no host sync between the copy of the merged row and the
return.

Validity is a device bool ``ok``, not a host branch: every leaf, the table
row, the fence, count, offsets and last key install in place through
``torch.where(ok, new, old)``, so a refused build (a verified-ε miss, a
capacity or trip budget overflow, a fence crossed) leaves the tier
bit-identical.  The reference donates the old tier to a jitted program and
returns a new one; here the tier's tensors are written in place.

The fit runs on the padded capacity-``m`` table, so the leaf level has
``n == m``; only PGM's upper levels carry device live counts, which the
corridor scans take as ``count``.  A PGM that ends in fewer levels than
the tier refits one-segment roots, which equal the stack's level lift, so
the recursion always runs the tier's ``levels``.  The previous shard's
last key comes from the tier's ``lasts`` (as :func:`refresh_shard` reads
it), where the reference reads that shard's table row.  The reference's
``device_refreshes`` metric waits for the observability port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.cdf import bit_length_device, ceil_log2_device, segment_ids
from repro_torch.core.pgm import pgm_device_slopes, pgm_fit_fast, pgm_segments_scan
from repro_torch.core.radix_spline import rs_knots_fast, rs_knots_scan, rs_verified_eps
from repro_torch.core.search import KEY_FILL, f64_to_i64
from repro_torch.dist.sharded_index import ShardedIndex
from repro_torch.kernels.ops import pgm_level_reencode_device, rs_kernel_arrays_device

#: the max key, encoded
_MAXKEY = KEY_FILL
_LOW32 = 0xFFFFFFFF

#: kinds whose shard refresh runs as one device program
DEVICE_REFRESH_KINDS = ("PGM", "RS")

#: fits the device program takes
DEVICE_FITS = ("fast", "scan")


def _at(row: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``row[i]`` for a 0-d index tensor, as a 0-d tensor, without reading
    ``i`` on the host."""
    return row.index_select(0, i.reshape(1)).reshape(())


def _udiv(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``x // d`` of uint64 values held as int64 bit patterns, for
    ``0 < d < 2^31`` (torch has no unsigned 64-bit division on the card):
    long division by 32-bit halves, every partial value non-negative."""
    hi = (x >> 32) & _LOW32
    lo = x & _LOW32
    q_hi = hi // d
    q_lo = ((hi - q_hi * d) * (1 << 32) + lo) // d
    return (q_hi << 32) | q_lo


def pad_sorted_table_device(row: torch.Tensor, count: torch.Tensor, m: int) -> torch.Tensor:
    """:func:`repro_torch.dist.sharded_index._pad_sorted_table` on the
    device: the ``count``-key prefix of the encoded ``row`` extended to
    ``m`` keys with the same strictly increasing spread continuation of
    the last key (the same uint64 arithmetic, so the rows are bit-equal).

    ``room = MAX - last`` may exceed 2^63 - 1: its unsigned value is
    ``~last`` of the raw key, the compare with the pad is unsigned, and
    ``room // pad`` is :func:`_udiv`.  On encoded keys, adding ``k * step``
    (which never exceeds ``room``) is the uint64 addition."""
    count = count.to(torch.int64)
    last = _at(row, count - 1)
    pad = torch.clamp(m - count, min=0)
    room = ~(last ^ keymod.SIGN)  # MAX - last, as uint64 bits
    fits = (room < 0) | (room >= pad)  # unsigned room >= pad
    step = torch.where(fits, _udiv(room, torch.clamp(pad, min=1)), 0)
    idx = torch.arange(m, device=row.device)
    k = torch.clamp(idx - count + 1, min=0)
    return torch.where(idx < count, row, last + k * step)


def _lshr(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by ``0 <= shift < 64``."""
    logical = ((x >> 1) & ((1 << 63) - 1)) >> torch.clamp(shift - 1, min=0)
    return torch.where(shift > 0, logical, x)


def _merge_row(old: torch.Tensor, off: torch.Tensor, count: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """``old`` with ``vals[:count]`` written from position ``off`` on (what
    reaches past the row is dropped, as ``.at[].set(mode="drop")`` drops
    it), as a gather: no two writes meet at one address."""
    local = torch.arange(old.shape[0], device=old.device) - off
    take = (local >= 0) & (local < count)
    return torch.where(take, vals[torch.clamp(local, 0, vals.shape[0] - 1)].to(old.dtype), old)


def _pgm_device_arrays(tier, padded_tab, eps, fit: str):
    """Fit and assemble every stacked PGM leaf of one shard row on the
    device.  Returns ``(arrays, checks)``: the tier's leaf shapes and
    dtypes, and the validity terms by name (device bools: the fast fit's
    verified ε, a one-segment root within the tier's levels, the leaf
    rows' capacities, the descent's trip-count budget)."""
    m = padded_tab.shape[0]
    dev = padded_tab.device
    levels = tier.s("levels")
    K = int(tier.arrays["keys"].shape[1])
    R = int(tier.arrays["rank0"].shape[1])
    fit_ok = torch.ones((), dtype=torch.bool, device=dev)

    cur_u = padded_tab
    cur_f = keymod.to_f64(padded_tab)
    cnt = torch.full((), m, dtype=torch.int64, device=dev)
    idx_m = torch.arange(m, device=dev)
    lvls = []  # bottom-up: (keys, slopes, start, nseg, parent count)
    for _ in range(levels):
        if fit == "fast":
            mask, level_ok = pgm_fit_fast(cur_f, eps, count=cnt)
            fit_ok = fit_ok & level_ok
        else:
            mask = pgm_segments_scan(cur_f, eps, count=cnt)
        slopes, start, _ = pgm_device_slopes(cur_f, mask, eps, count=cnt)
        nseg = mask.sum()
        nxt_u = torch.where(idx_m < nseg, cur_u[torch.clamp(start, 0, m - 1)], _MAXKEY)
        lvls.append((nxt_u, slopes, start, nseg, cnt))
        cur_u, cur_f, cnt = nxt_u, keymod.to_f64(nxt_u), nseg
    # the greedy must end in a one-segment root within the tier's levels
    checks = {"verified_eps": fit_ok, "one_root": cnt == 1}
    lvls.reverse()  # root first, the stacked order

    sizes = torch.stack([nseg for _, _, _, nseg, _ in lvls])
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    off = torch.cat([zero, torch.cumsum(sizes, 0)])
    off_r = torch.cat([zero, torch.cumsum(sizes + 1, 0)])
    checks["leaf_capacity"] = (off[levels] <= K) & (off_r[levels] <= R)

    kmin = keymod.to_f64(padded_tab[0])
    span = keymod.to_f64(padded_tab[m - 1]) - kmin
    inv_span = torch.where(span > 0, 1.0 / torch.where(span > 0, span, 1.0), 1.0)

    # the flat concatenation at device offsets; the fills are the host's
    # pow2 sentinels (max key, zero slope, the leaf count for rank0)
    keys_flat = torch.full((K,), _MAXKEY, dtype=torch.int64, device=dev)
    slope_flat = torch.zeros((K,), dtype=torch.float64, device=dev)
    u0_flat = torch.ones((K,), dtype=torch.float32, device=dev)
    pk_slope_flat = torch.zeros((K,), dtype=torch.float32, device=dev)
    rank0_flat = torch.full((R,), m, dtype=torch.int64, device=dev)
    idx_m1 = torch.arange(m + 1, device=dev)
    max_err = torch.zeros((), dtype=torch.float64, device=dev)
    for lvl, (lvl_keys, lvl_slopes, lvl_start, nseg, parent_cnt) in enumerate(lvls):
        if lvl + 1 < levels:
            child, child_cnt = lvls[lvl + 1][0], lvls[lvl + 1][3]
        else:
            child, child_cnt = padded_tab, torch.full((), m, dtype=torch.int64, device=dev)
        u0_l, slope_u, err_l = pgm_level_reencode_device(
            lvl_keys, lvl_slopes, lvl_start, nseg, child, child_cnt, kmin, span, inv_span)
        max_err = torch.maximum(max_err, err_l)
        keys_flat, slope_flat, u0_flat, pk_slope_flat = (
            _merge_row(old, off[lvl], nseg, new)
            for old, new in ((keys_flat, lvl_keys), (slope_flat, lvl_slopes),
                             (u0_flat, u0_l), (pk_slope_flat, slope_u)))
        # rank0: the nseg starts, then the parent-count sentinel
        vals_r = torch.where(idx_m1 < nseg, torch.nn.functional.pad(lvl_start, (0, 1)), parent_cnt)
        rank0_flat = _merge_row(rank0_flat, off_r[lvl], nseg + 1, vals_r)

    pk_eps = f64_to_i64(torch.clamp(torch.ceil(max_err) + 2.0, max=float(m))).to(torch.int32)
    # the fused descent's trip count must fit the tier's bucketed static
    pk_window = torch.clamp(2 * (pk_eps.to(torch.int64) + 1) + 3, max=max(m, 2))
    checks["pksteps"] = ceil_log2_device(pk_window) <= tier.s("pksteps")
    # "epi" depends on eps and n only, both the tier row's
    arrays = {
        "keys": keys_flat,
        "slope": slope_flat,
        "rank0": rank0_flat,
        "off": off,
        "off_r": off_r,
        "sizes": sizes,
        "eps": eps.to(torch.int64),
        "pk_u0": u0_flat,
        "pk_slope": pk_slope_flat,
        "pk_eps": pk_eps,
        "pk_kmin": kmin,
        "pk_inv_span": inv_span,
    }
    return arrays, checks


def _rs_device_arrays(tier, padded_tab, eps, fit: str):
    """Fit and assemble every stacked RadixSpline leaf of one shard row on
    the device.  Returns ``(arrays, checks)``: the fast fit's verified ε,
    the knot rows' capacity, the radix width, and the trip-count budgets
    of the knot search, the table search and the kernel's knot window."""
    m = padded_tab.shape[0]
    dev = padded_tab.device
    r_bits = tier.s("r_bits")
    Kc = int(tier.arrays["knot_keys"].shape[1])
    keys_f = keymod.to_f64(padded_tab)

    if fit == "fast":
        kmask, fit_ok = rs_knots_fast(keys_f, eps)
    else:
        kmask = rs_knots_scan(keys_f, eps)
        fit_ok = torch.ones((), dtype=torch.bool, device=dev)
    _, kpos = segment_ids(kmask)
    m_valid = kmask.sum()
    checks = {"verified_eps": fit_ok, "leaf_capacity": m_valid <= Kc}

    # knot rows at the tier's capacity (Kc <= m: a spline has at most as
    # many knots as keys, and both are powers of two)
    ids = torch.arange(Kc, device=dev)
    sel = torch.clamp(kpos[torch.clamp(ids, max=m - 1)], 0, m - 1)
    live = ids < m_valid
    kk = torch.where(live, padded_tab[sel], _MAXKEY)
    kr = torch.where(live, sel, m - 1)

    kmin_u = padded_tab[0]
    span_u = padded_tab[m - 1] - kmin_u  # the uint64 span, as bits
    span_bits = torch.clamp(bit_length_device(span_u).to(torch.int64), min=1)
    # r_bits is structural: a shard whose span shrank below it cannot
    # install (the host build would lower r_bits: the restack cue)
    checks["r_bits"] = span_bits >= r_bits
    shift = torch.clamp(span_bits - r_bits, min=0)

    # radix table: a search over the capacity knot row; the max-key pads
    # prefix at or above 2^r_bits, and the clamp to m_valid makes each
    # entry the host's search over the live knots
    pref_cap = (1 << r_bits) + 1
    d = kk - kmin_u  # uint64 differences, as bits
    pre = _lshr(d, shift)
    prefixes = torch.where(pre < 0, pref_cap, torch.clamp(pre, max=pref_cap))
    grid = torch.arange((1 << r_bits) + 1, device=dev)
    rt = torch.minimum(torch.searchsorted(prefixes, grid, side="left"), m_valid)

    # the verified bound by build_rs's clipped interpolation: the same
    # knots give its eps_eff bit for bit
    meas = rs_verified_eps(keys_f, kmask)
    eps_eff = torch.clamp(f64_to_i64(torch.ceil(meas)) + 1, min=1)

    kmin_f = keymod.to_f64(kmin_u)
    span_f = keymod.to_f64(padded_tab[m - 1]) - kmin_f
    inv_span = torch.where(span_f > 0, 1.0 / torch.where(span_f > 0, span_f, 1.0), 1.0)
    rk_u0, rk_slope, rk_eps = rs_kernel_arrays_device(kk, kr, m_valid, padded_tab, kmin_f, span_f,
                                                      inv_span)

    # trip-count budgets against the tier's bucketed statics
    checks["ksteps"] = ceil_log2_device(m_valid) <= tier.s("ksteps")
    checks["epi"] = ceil_log2_device(torch.clamp(2 * eps_eff + 3, max=max(m, 2))) <= tier.s("epi")
    rk_window = torch.clamp(2 * rk_eps.to(torch.int64) + 3, max=max(m, 2))
    checks["rk_epi"] = ceil_log2_device(rk_window) <= tier.s("rk_epi")

    arrays = {
        "knot_keys": kk,
        "knot_ranks": kr,
        "radix_table": rt,
        "kmin": kmin_u,
        "shift": shift,
        "eps_eff": eps_eff,
        "m_valid": m_valid,
        "rk_u0": rk_u0,
        "rk_slope": rk_slope,
        "rk_eps": rk_eps,
        "rk_kmin": kmin_f,
        "rk_inv_span": inv_span,
    }
    return arrays, checks


_KIND_DEVICE_ARRAYS = {"PGM": _pgm_device_arrays, "RS": _rs_device_arrays}


def _refresh_program(sidx: ShardedIndex, shard: int, row, count, eps, fit: str):
    """The device program: pad, fit, assemble, validate, install under
    ``ok``.  Tensor ops only, no host sync; returns ``(ok, checks)``."""
    m = int(sidx.tables.shape[1])
    padded_tab = pad_sorted_table_device(row, count, m)
    new, checks = _KIND_DEVICE_ARRAYS[sidx.kind](sidx.index, padded_tab, eps, fit)
    # the fences, as refresh_shard checks them (the previous shard's last
    # live key from lasts)
    first, last = row[0], _at(row, count - 1)
    fences = torch.ones((), dtype=torch.bool, device=row.device)
    if shard > 0:
        fences = fences & (first > sidx.lasts[shard - 1])
    if shard + 1 < sidx.n_shards:
        fences = fences & (last < sidx.fences[shard + 1])
    checks["fences"] = fences
    ok = torch.stack(list(checks.values())).all()
    r = sidx._row(shard)
    for k, v in sidx.index.arrays.items():
        val = new[k].to(v.dtype)
        if val.shape != v[r].shape:
            raise AssertionError(f"device leaf {k!r} has shape {tuple(val.shape)}, the tier's "
                                 f"row {tuple(v[r].shape)}")
        v[r].copy_(torch.where(ok, val, v[r]))
    sidx.tables[r].copy_(torch.where(ok, padded_tab, sidx.tables[r]))
    for vec, val in ((sidx.fences, first), (sidx.counts, count), (sidx.lasts, last)):
        vec[shard:shard + 1].copy_(torch.where(ok, val.reshape(1), vec[shard:shard + 1]))
    sidx.offsets.copy_(torch.cumsum(sidx.counts, 0) - sidx.counts)
    return ok, checks


def device_refresh(sidx: ShardedIndex, shard: int, merged, eps, *, fit: str = "fast",
                   checks: dict | None = None):
    """Rebuild one shard of a PGM or RS tier and install it, in place, as
    one device program.

    ``merged`` is the shard's new raw key set (sorted, unique): uint64
    numpy, copied to the card first, or an encoded int64 tensor already on
    the tier's device.  ``eps`` is the tier spec's ε.  ``fit="fast"`` takes
    the O(log n)-depth corridor fit (verified ε checked on the device);
    ``fit="scan"`` the exact scan, which gives the host build's model.
    After the copy of the merged row nothing reads the device on the host.

    Returns ``(sidx, ok)`` with ``ok`` a device bool the caller may read
    later: when False every leaf, the table row, fences, counts, offsets
    and last keys kept their values, and the caller falls back to the host
    refresh.  A ``checks`` dict, when given, receives the terms whose
    conjunction is ``ok``, by name (device bools: ``verified_eps``,
    ``leaf_capacity``, ``fences``, the kind's level and trip-count
    budgets), to tell which one refused.  Raises ``ValueError`` on the
    host only where a restack is needed anyway (a kind without a device
    refresh, more keys than the table capacity), for an unknown fit, a
    capacity-1 tier, or a tier that holds only some of its shards.
    Example::

        sidx, ok = device_refresh(sidx, 1, merged_keys, eps=64)
        if not bool(ok):  # read later, off the serving path
            ...  # the host refresh
    """
    kind = sidx.index.kind
    if kind not in DEVICE_REFRESH_KINDS:
        raise ValueError(f"device_refresh supports kinds {DEVICE_REFRESH_KINDS}, not {kind!r}")
    if fit not in DEVICE_FITS:
        raise ValueError(f"unknown device fit {fit!r}; choose from {DEVICE_FITS}")
    m = int(sidx.tables.shape[1])
    n_new = int(merged.shape[0]) if torch.is_tensor(merged) else len(merged)
    if not 0 < n_new <= m:
        raise ValueError(f"shard has {n_new} keys for table capacity {m}: restack the tier")
    if m < 2:
        raise ValueError("capacity-1 tier: use the host refresh path")
    if len(sidx.held) != sidx.n_shards:
        raise ValueError("device_refresh needs a tier that holds every shard; "
                         "use refresh_shard under a sharding context")
    dev = sidx.device
    if torch.is_tensor(merged):
        if merged.dtype != torch.int64 or merged.device != dev:
            raise ValueError(f"a merged tensor must be encoded int64 on {dev}, got "
                             f"{merged.dtype} on {merged.device}")
        row = torch.full((m,), keymod.SIGN, dtype=torch.int64, device=dev)  # key 0, encoded
        row[:n_new].copy_(merged)
    else:
        row_np = np.zeros(m, dtype=np.uint64)
        row_np[:n_new] = np.asarray(merged, dtype=np.uint64)
        row = keymod.encode(row_np, dev)
    count = torch.full((), n_new, dtype=torch.int64, device=dev)
    eps_t = torch.full((), float(eps), dtype=torch.float64, device=dev)
    ok, terms = _refresh_program(sidx, shard, row, count, eps_t, fit)
    if checks is not None:
        checks.update(terms)
    return sidx, ok


__all__ = ["DEVICE_FITS", "DEVICE_REFRESH_KINDS", "device_refresh", "pad_sorted_table_device"]
