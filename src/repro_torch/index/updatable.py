"""GAPPED — the updatable learned index kind: gapped leaves plus a
delta-merge buffer (counterpart of ``repro.index.updatable``).

Leaves (key leaves encoded, as everywhere in the port):

* ``keys``   — ``(n_leaves, leaf_cap)`` rows.  Row ``l`` holds its leaf's
  ``counts[l]`` live keys sorted in a valid prefix; the tail is a
  strictly increasing pad (last key + 1, + 2, ... saturating at the max
  key).  The gaps are the insertion slots.
* ``counts`` / ``fences`` / ``route`` — per-leaf occupancy, per-leaf
  first key, and the routing array ``fences[1:]`` padded with the max key.
* ``delta`` / ``delta_count`` — a small sorted overflow buffer (valid
  prefix, max-key padded) merged into every lookup.
* the root model — one monotone linear model on the normalised key
  (``root_slope``/``root_icept``/``kmin``/``inv_span``) predicts the
  owning leaf; ``root_eps`` is its measured error bound, re-measured
  (not refitted) at compaction.

Read path: route the query to its leaf, count the leaf's live keys
``<= q`` and add the leaf's offset; count the delta's keys ``<= q``; the
two key sets are disjoint (inserts dedupe), so the predecessor rank in
the merged set is the sum minus one.  The index owns its keys, so a
lookup ignores the table argument.  Backends: ``xla`` (branch-free
bounded searches), ``bbs`` (the early-exit epilogue) and ``ref`` (the
merged keys, then ``torch.searchsorted``).  There is no kernel: the
reference has no Pallas path for GAPPED, and ``"kernel"`` raises.

The read path takes one table's leaves or a stack's (a leading table
axis: ``(N, L, cap)`` keys, ``(N,)`` scalars), so a batch or a tier is
answered in one pass of tensor ops.  The insert step and the compaction
work on one table.

The max key ``2**64 - 1`` is the pad and route sentinel and cannot be
stored as a live key.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core import search
from repro_torch.core.search import KEY_FILL, f64_to_i64, take_clip
from repro_torch.obs.timing import stopwatch

from . import impls, mutation
from .impls import _MAXKEY, QueryImpl, _bucket_steps, _pow2ceil, _scalar
from .index import Index, check_backend
from .specs import GappedSpec

#: the max key, encoded: the pad and route sentinel
MAXKEY = KEY_FILL

BACKENDS = ("xla", "bbs", "ref")


def _lifted(index: Index) -> dict:
    """The leaves as a stack: one table's gain a leading axis of one."""
    a = index.arrays
    return a if a["keys"].dim() == 3 else {k: v[None] for k, v in a.items()}


def _sat_add(x: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    """``min(x + over, max key)`` on encoded keys for ``over >= 0`` — the
    reference's uint64 ``x + min(over, MAXKEY - x)`` — with no int64
    overflow on the way."""
    room = MAXKEY - over
    return torch.where(x >= room, MAXKEY, torch.minimum(x, room) + over)


def _root_leaf(keys, kmin, inv_span, slope, icept, n_leaves: int) -> torch.Tensor:
    """The root model's leaf of each encoded key: two rounded f64
    operations, then the clip to ±4e15 before the int64 cast."""
    u = torch.clamp((keymod.to_f64(keys) - kmin) * inv_span, 0.0, 1.0)
    pred = torch.clamp(torch.floor(slope * u + icept), -4.0e15, 4.0e15)
    return torch.clamp(f64_to_i64(pred), 0, n_leaves - 1)


# ---------------------------------------------------------------------------
# Routing + the two-tier read path (stacked leaves, (N, B) queries)
# ---------------------------------------------------------------------------


def _route(a: dict, q, ksteps: int):
    """Model-guided owner leaf: the root prediction, then a bounded search
    of the ``route`` fences within the measured ±``root_eps`` window."""
    n_leaves = a["route"].shape[-1]
    col = {k: a[k][:, None] for k in ("kmin", "inv_span", "root_slope", "root_icept", "root_eps")}
    pred = _root_leaf(q, col["kmin"], col["inv_span"], col["root_slope"], col["root_icept"],
                      n_leaves)
    lo = torch.clamp(pred - col["root_eps"], 0, n_leaves - 1)
    hi = torch.clamp(pred + col["root_eps"], 0, n_leaves - 1)
    ub = search.bounded_upper_bound(a["route"], q, lo, hi - lo + 1, steps=ksteps)
    return torch.clamp(ub, 0, n_leaves - 1)


def _main_ub(a: dict, q, *, epi: int, ksteps: int, branchy: bool):
    """Number of live main-tier keys ``<= q`` (a global rank upper bound)."""
    keys, counts = a["keys"], a["counts"]
    n, n_leaves, cap = keys.shape
    owner = _route(a, q, ksteps)
    base = owner * cap
    cnt = torch.gather(counts, 1, owner)
    flat = keys.reshape(n, n_leaves * cap)
    if branchy:
        ub_in = search.bounded_upper_bound_branchy(flat, q, base, cnt)
    else:
        ub_in = search.bounded_upper_bound(flat, q, base, cnt, steps=epi) - base
    offsets = torch.cumsum(counts, -1) - counts
    return torch.gather(offsets, 1, owner) + ub_in


def _delta_ub(a: dict, q, *, epi: int, branchy: bool):
    """Number of delta-buffer keys ``<= q``."""
    zero = torch.zeros_like(q)
    cnt = a["delta_count"][:, None].expand(q.shape)
    if branchy:
        return search.bounded_upper_bound_branchy(a["delta"], q, zero, cnt)
    return search.bounded_upper_bound(a["delta"], q, zero, cnt, steps=epi)


def _two_tier(index: Index, a: dict, q, branchy: bool):
    steps = {"epi": index.s("epi")}
    return (_main_ub(a, q, ksteps=index.s("ksteps"), branchy=branchy, **steps)
            + _delta_ub(a, q, branchy=branchy, **steps) - 1)


def _materialize(a: dict):
    """Each table's sorted merged keys (max-key padded) and live total."""
    keys, counts = a["keys"], a["counts"]
    n, _, cap = keys.shape
    pos = torch.arange(cap, device=keys.device)
    flat = torch.where(pos < counts[..., None], keys, MAXKEY).reshape(n, -1)
    dpos = torch.arange(a["delta"].shape[-1], device=keys.device)
    dvals = torch.where(dpos < a["delta_count"][:, None], a["delta"], MAXKEY)
    merged = torch.sort(torch.cat([flat, dvals], -1), -1).values
    return merged, counts.sum(-1) + a["delta_count"]


def live_keys(index: Index) -> np.ndarray:
    """The sorted live key set of one table (main tier + delta), uint64."""
    if index.arrays["keys"].dim() != 2:
        raise ValueError("live_keys takes one table's index; unstack a stack first")
    merged, total = _materialize(_lifted(index))
    return keymod.decode(merged[0, : int(total[0])])


def _gapped_lookup(index: Index, table, q, backend: str):
    check_backend(index.kind, backend)
    one = index.arrays["keys"].dim() == 2
    a = _lifted(index)
    qs = q.reshape(1, -1) if one else q
    if backend == "ref":
        merged, total = _materialize(a)
        ub = torch.searchsorted(merged, qs.contiguous(), right=True)
        r = torch.minimum(ub, total[:, None]) - 1
    else:
        r = _two_tier(index, a, qs, backend == "bbs")
    return r.reshape(q.shape) if one else r


def _gapped_intervals(index: Index, table, q):
    # the two-tier merge is exact, so the "window" is the answer itself
    r = _two_tier(index, index.arrays, q, False)
    return r, r


def _gapped_space(index: Index) -> int:
    a = index.arrays
    live = int(a["counts"].sum()) + int(a["delta_count"])
    meta = sum(int(a[k].nbytes) for k in ("counts", "fences", "route", "delta_count", "kmin",
                                          "inv_span", "root_slope", "root_icept", "root_eps"))
    return live * a["keys"].element_size() + meta


GAPPED_IMPL = QueryImpl(
    intervals=_gapped_intervals,
    space_bytes=_gapped_space,
    batched_operands=None,
    batched_search=None,
    batched_plain=None,
    lookup=_gapped_lookup,
    backends=BACKENDS,
)


# ---------------------------------------------------------------------------
# Build (host numpy, the reference's operation for operation)
# ---------------------------------------------------------------------------


def _build_gapped_index(spec: GappedSpec, table_np: np.ndarray):
    sw = stopwatch()
    table = np.asarray(table_np, dtype=np.uint64)
    n = int(table.shape[0])
    if n == 0:
        raise ValueError("GAPPED requires a non-empty table")
    cap = int(spec.leaf_cap)
    per = max(1, min(cap, int(round(cap * float(spec.fill)))))
    L = _pow2ceil(-(-n // per))
    dcap = _pow2ceil(int(spec.delta_cap))

    base, rem = divmod(n, L)
    counts = (base + (np.arange(L) < rem)).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    fences = table[np.minimum(bounds[:-1], n - 1)]
    route = np.concatenate([fences[1:], [_MAXKEY]]).astype(np.uint64)

    pos = np.arange(cap)
    valid = pos[None, :] < counts[:, None]
    vals = table[np.minimum(bounds[:-1, None] + pos[None, :], n - 1)]
    last = table[np.minimum(np.maximum(bounds[1:] - 1, 0), n - 1)]
    lastv = np.where(counts > 0, last, fences).astype(np.uint64)
    over = np.maximum(pos[None, :] - counts[:, None] + 1, 0).astype(np.uint64)
    pad = lastv[:, None] + np.minimum(over, (_MAXKEY - lastv)[:, None])
    rows = np.where(valid, vals, pad).astype(np.uint64)

    # root model: least-squares leaf id over the normalised fence key,
    # slope clamped monotone so the measured ε bounds every query
    kmin = np.float64(table[0])
    span = np.float64(table[-1]) - kmin
    inv_span = np.float64(1.0 / span) if span > 0 else np.float64(0.0)
    uf = np.clip((fences.astype(np.float64) - kmin) * inv_span, 0.0, 1.0)
    lids = np.arange(L, dtype=np.float64)
    var = float(np.mean((uf - uf.mean()) ** 2))
    slope = float(np.mean((uf - uf.mean()) * (lids - lids.mean())) / var) if var > 0 else 0.0
    slope = max(slope, 0.0)
    icept = float(lids.mean() - slope * uf.mean())
    pred = np.clip(np.floor(slope * uf + icept), 0, L - 1).astype(np.int64)
    eps = int(np.max(np.abs(pred - np.arange(L)))) + 2

    arrays = {
        "keys": rows,
        "counts": counts,
        "fences": fences,
        "route": route,
        "delta": np.full((dcap,), _MAXKEY, dtype=np.uint64),
        "delta_count": _scalar(0, np.int64),
        "kmin": _scalar(kmin, np.float64),
        "inv_span": _scalar(inv_span, np.float64),
        "root_slope": _scalar(slope, np.float64),
        "root_icept": _scalar(icept, np.float64),
        "root_eps": _scalar(eps, np.int64),
    }
    static = (("epi", _bucket_steps(max(cap, dcap))), ("ksteps", _bucket_steps(L)))
    info = {
        "name": f"GAPPED(cap={cap},fill={spec.fill},delta={dcap})",
        "build_time": sw.elapsed,
        "n": n,
        "n_leaves": L,
        "leaf_cap": cap,
        "delta_cap": dcap,
        "root_eps": eps,
    }
    return static, arrays, info


# ---------------------------------------------------------------------------
# Mutation: insert_batch (absorb -> overflow) and compact (delta -> leaves)
# ---------------------------------------------------------------------------


def _insert_step(index: Index, batch, bcount: int):
    """One insert step on one table: dedupe the sorted batch against
    itself and the index, absorb per leaf where the gaps suffice (all or
    nothing a leaf), divert the rest to the delta.  Returns the new
    arrays and the counts of the step.

    The reference merges the absorbed keys through a ``(batch, batch)``
    matrix; here each touched leaf's keys go to one row of an
    ``(n_touched, cap)`` block (a leaf absorbs at most ``cap - counts``
    keys), which is sorted with the leaf's live prefix in rows of
    ``2 * cap``: the first ``cap`` entries of a row are the reference's,
    in O(batch * cap) memory."""
    a = index.arrays
    keys, counts, delta, dc = a["keys"], a["counts"], a["delta"], a["delta_count"]
    n_leaves, cap = keys.shape
    dcap = delta.shape[0]
    dev = keys.device
    epi = index.s("epi")

    b = torch.sort(batch).values  # max-key pads sort to the tail
    in_batch = torch.arange(b.shape[0], device=dev) < bcount
    dup_adj = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), b[1:] == b[:-1]])

    flat = keys.reshape(-1)
    owner = _route(_lifted(index), b[None], index.s("ksteps"))[0]
    base = owner * cap
    ub_in = search.bounded_upper_bound(flat, b, base, counts[owner], steps=epi) - base
    hit_main = (ub_in > 0) & (take_clip(flat, base + ub_in - 1) == b)
    ub_d = search.bounded_upper_bound(delta, b, torch.zeros_like(b), dc.expand(b.shape),
                                      steps=epi)
    hit_delta = (ub_d > 0) & (take_clip(delta, ub_d - 1) == b)

    fresh = in_batch & ~dup_adj & ~hit_main & ~hit_delta
    hist = torch.zeros(n_leaves, dtype=torch.int64, device=dev).index_add_(0, owner, fresh.long())
    absorb_leaf = hist <= (cap - counts)
    to_main = fresh & absorb_leaf[owner]
    to_delta = fresh & ~absorb_leaf[owner]

    # -- absorb: merge only the touched leaf rows --------------------------
    aff = torch.nonzero(absorb_leaf & (hist > 0)).reshape(-1)  # ascending
    pos = torch.arange(cap, device=dev)
    acnt = counts[aff]
    live = torch.where(pos < acnt[:, None], keys[aff], MAXKEY)
    took = torch.nonzero(to_main).reshape(-1)
    own, order = torch.sort(owner[took], stable=True)
    col = torch.empty_like(own)
    col[order] = torch.arange(own.numel(), device=dev) - torch.searchsorted(own, own)
    block = torch.full((aff.numel(), cap), MAXKEY, dtype=keys.dtype, device=dev)
    block[torch.searchsorted(aff, owner[took]), col] = b[took]
    merged = torch.sort(torch.cat([live, block], 1), 1).values[:, :cap]
    new_acnt = acnt + hist[aff]
    last = torch.gather(merged, 1, torch.clamp(new_acnt - 1, 0, cap - 1)[:, None])[:, 0]
    lastv = torch.where(new_acnt > 0, last, a["fences"][aff])
    over = torch.clamp(pos[None, :] - new_acnt[:, None] + 1, min=0)
    newrows = torch.where(pos < new_acnt[:, None], merged, _sat_add(lastv[:, None], over))

    # -- overflow: merge the diverted keys into the sorted delta prefix -----
    dvals = torch.where(torch.arange(dcap, device=dev) < dc, delta, MAXKEY)
    dnew = torch.where(to_delta, b, MAXKEY)
    new_dc = dc + to_delta.sum()

    # fences[0] tracks the live minimum (metadata; routing uses route)
    new_fences = a["fences"].clone()
    if bcount > 0:
        new_fences[0] = torch.minimum(a["fences"][0], b[0])

    arrays = dict(a)
    arrays.update(
        keys=keys.index_copy(0, aff, newrows),
        counts=counts + torch.where(absorb_leaf, hist, 0),
        fences=new_fences,
        delta=torch.sort(torch.cat([dvals, dnew])).values[:dcap],
        delta_count=new_dc,
    )
    stats = {
        "absorbed": int(to_main.sum()),
        "overflowed": int(to_delta.sum()),
        "duplicates": int((in_batch & (dup_adj | hit_main | hit_delta)).sum()),
        "new_dc": int(new_dc),
    }
    stats["ok"] = stats["new_dc"] <= dcap
    return arrays, stats


def _compact_step(index: Index):
    """Fold the delta into rebalanced leaves: one sort of the live keys and
    a gather.  Re-measures ``root_eps`` against the new fences with the
    query path's arithmetic; the root model is not refitted."""
    a = index.arrays
    keys, counts, dc = a["keys"], a["counts"], a["delta_count"]
    n_leaves, cap = keys.shape
    dcap = a["delta"].shape[0]
    dev = keys.device
    n_all = n_leaves * cap + dcap

    pos = torch.arange(cap, device=dev)
    flat = torch.where(pos[None, :] < counts[:, None], keys, MAXKEY).reshape(-1)
    dvals = torch.where(torch.arange(dcap, device=dev) < dc, a["delta"], MAXKEY)
    merged = torch.sort(torch.cat([flat, dvals])).values
    total = counts.sum() + dc
    ok = bool(total <= n_leaves * cap)

    lids = torch.arange(n_leaves, device=dev)
    ncnt = total // n_leaves + (lids < total % n_leaves).long()
    gstart = torch.cumsum(ncnt, 0) - ncnt
    vals = take_clip(merged, gstart[:, None] + pos[None, :])
    last = take_clip(merged, torch.clamp(gstart + ncnt - 1, 0, n_all - 1))
    over = torch.clamp(pos[None, :] - ncnt[:, None] + 1, min=0)
    nkeys = torch.where(pos[None, :] < ncnt[:, None], vals, _sat_add(last[:, None], over))
    nfences = nkeys[:, 0].contiguous()
    nroute = torch.cat([nfences[1:], nfences.new_full((1,), MAXKEY)])

    pred = _root_leaf(nfences, a["kmin"], a["inv_span"], a["root_slope"], a["root_icept"],
                      n_leaves)
    arrays = dict(a)
    arrays.update(
        keys=nkeys,
        counts=ncnt,
        fences=nfences,
        route=nroute,
        delta=torch.full_like(a["delta"], MAXKEY),
        delta_count=torch.zeros_like(dc),
        root_eps=(pred - lids).abs().max() + 2,
    )
    return arrays, ok


def gapped_compact(index: Index) -> Index:
    arrays, ok = _compact_step(index)
    if not ok:
        live = int(index.arrays["counts"].sum()) + int(index.arrays["delta_count"])
        n_leaves, cap = index.arrays["keys"].shape
        raise mutation.NeedsRebuild(
            f"GAPPED capacity exhausted: {live} live keys exceed "
            f"{n_leaves} leaves x {cap} slots — rebuild with a larger spec"
        )
    return Index(index.kind, index.static, arrays)


def gapped_insert_batch(index: Index, insert_keys, *, auto_compact: bool = True):
    arr = keymod.as_keys(insert_keys, index.device).reshape(-1)
    nb = int(arr.numel())
    dcap = int(index.arrays["delta"].shape[0])
    if nb == 0:
        dc = int(index.arrays["delta_count"])
        return index, mutation.InsertReport(0, 0, 0, 0, dc, dcap, False)
    # the reference's pow2 padding of the batch with the max key
    batch = arr.new_full((_pow2ceil(nb),), MAXKEY)
    batch[:nb] = arr

    compacted = False
    arrays, st = _insert_step(index, batch, nb)
    if not st["ok"]:
        if not auto_compact:
            raise mutation.NeedsRebuild(
                f"insert_batch would overflow the delta buffer "
                f"({st['new_dc']} > {dcap}) — compact() first or pass "
                "auto_compact=True"
            )
        index = gapped_compact(index)  # raises NeedsRebuild when full
        compacted = True
        arrays, st = _insert_step(index, batch, nb)
        if not st["ok"]:
            raise mutation.NeedsRebuild(
                f"batch of {nb} overflows the delta buffer (cap {dcap}) even "
                "after compaction — rebuild with a larger spec or split the batch"
            )
    report = mutation.InsertReport(
        requested=nb,
        absorbed=st["absorbed"],
        overflowed=st["overflowed"],
        duplicates=st["duplicates"],
        delta_count=st["new_dc"],
        delta_cap=dcap,
        compacted=compacted,
    )
    return Index(index.kind, index.static, arrays), report


# ---------------------------------------------------------------------------
# Registration: GAPPED enrols last, as in the reference's registry order
# ---------------------------------------------------------------------------

impls.QUERY_IMPLS["gapped"] = GAPPED_IMPL
impls._reg(
    "GAPPED",
    GappedSpec,
    "gapped",
    _build_gapped_index,
    lambda **p: GappedSpec(
        leaf_cap=p.get("leaf_cap", 256),
        fill=p.get("fill", 0.75),
        delta_cap=p.get("delta_cap", 1024),
    ),
)
mutation.register_mutator(
    "GAPPED", mutation.Mutator(insert_batch=gapped_insert_batch, compact=gapped_compact)
)
