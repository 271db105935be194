"""A sharded tier of per-shard learned indexes (counterpart of
``repro.dist.sharded_index``).

A tier holds many sorted tables, one per shard of a partitioned keyspace.
Same-spec per-table indexes stack leaf-wise into one :class:`Index` whose
leaves carry a leading table axis, so one batched kernel launch answers
every table.  Leaf shapes pad to the per-leaf maximum with inert
sentinels (max key for key leaves, the last entry repeated otherwise),
bucketed trip counts take the maximum across tables (extra trips of a
bounded search are no-ops), and PGM-shaped indexes of shallower tables
are lifted to the deepest one with trivial one-segment root levels.
Stacking works on the leaves in the reference's numpy layout (uint64
keys), so the stacked leaves equal the reference's.

:class:`ShardedIndex` splits a global sorted table into contiguous
shards, each padded to a common power-of-two length with a strictly
increasing continuation of its last key.  A process holds the whole tier
or, loaded with ``ShardedIndex.load(path, shard=s)``, one shard's leaves
and table; the fences, counts, offsets and last keys are on every
holder.  :func:`sharded_lookup` answers a query batch against the tier:

* ``mode="ref"`` — one process, every shard held: the fence array routes
  each query to its owner (:func:`route_owners`), every shard answers
  every query (``backend="kernel"``: ONE launch of the kind's batched
  kernel), each local rank is clamped and rebased to a global rank, and
  the owner's answer is kept.
* ``mode="a2a"`` — one rank a shard over the ``tp`` group of a
  :class:`~repro_torch.dist.sharding.ShardingCtx`: each rank routes its
  slice of the batch, buckets it by owner into a capacity-factored
  ``(n_shards, cap)`` request matrix, exchanges it with one
  ``all_to_all``, answers the requests it received on its own shard
  (``backend="kernel"``: one launch of the kind's single-table kernel),
  sends the global ranks back with a second ``all_to_all`` and scatters
  them into query order; one ``all_gather`` gives every rank the whole
  ``(B,)`` answer.  Queries beyond a (source, owner) pair's ``cap``
  slots come back as :data:`DROPPED`; ``cap_factor >= n_shards`` never
  drops.
* ``mode="allgather"`` — every rank answers the whole batch on its own
  shard, keeps the queries it owns, and one ``all_reduce`` merges them.

Ranks equal ``Index.lookup`` on the whole table (but the drops).
:func:`refresh_shard` installs a rebuilt shard in place, after every
check has passed, and :func:`rebalance_shards` moves the shard bounds
through it.  A tier of the updatable GAPPED kind also takes writes:
:func:`insert_into_shard` absorbs a routed key batch into one shard and
:func:`compact_shard` folds its delta buffer, both in place after every
check, keeping the counts, offsets, fences and last keys live.  GAPPED
shards are built on their raw tables (the kind owns its keys, so a pad
key must never become live) and stack with inert zero-count leaves.

``sharded_lookup(..., telemetry=True)`` also records routing-imbalance
and drop-rate counters into the :mod:`repro_torch.obs` registry
(``route_*``, tier ``"all"`` plus an optional per-tier label, and a
caller-owned ``telemetry_sink`` dict): one owner histogram on the
device (:func:`route_owners` and a ``bincount``) and one copy of it,
with the count of drops, to the host.  It adds no search-kernel launch.
:func:`tier_metrics` is the aggregate view and
:func:`shard_query_weights` the per-shard counts that a tuned tier
rebalances from.  With telemetry off nothing imports ``repro_torch.obs``.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import keys as keymod
from repro_torch.core.search import NO_PRED
from repro_torch.index import impls, mutation, registry
from repro_torch.index.impls import _pad_pow2
from repro_torch.index.index import BACKENDS, Index, check_backend, lookup_impl, resolve_device
from repro_torch.index.specs import IndexSpec

from . import collectives

#: rank of a query dropped by the capacity-factored exchange
#: (``mode="a2a"``); distinct from :data:`NO_PRED`, the below-the-first-key
#: rank.  The other modes never drop a query.
DROPPED = -2

# ---------------------------------------------------------------------------
# Tier telemetry: routing imbalance + drop-rate counters.
#
# The counters live in the repro_torch.obs registry (``route_*`` metrics,
# labeled by tier: "all" is the process-wide aggregate); everything below
# is a thin view in the reference's shapes.  obs is imported lazily inside
# the telemetry functions only: the telemetry-off lookup path never pulls
# repro_torch.obs in at call time.
# ---------------------------------------------------------------------------

#: the tier label the global aggregate view reads
_ALL_TIERS = "all"


def _fresh_tier_metrics() -> dict:
    """A zeroed caller-owned ``telemetry_sink`` dict."""
    return {
        "lookups": 0,
        "queries": 0,
        "dropped": 0,
        "routed_max": 0,  # busiest shard's queries, summed over lookups
        "routed_even": 0.0,  # perfectly even per-shard load, summed
        "imbalance_last": 0.0,
        "imbalance_peak": 0.0,
    }


def reset_tier_metrics() -> None:
    """Zero the registry-backed ``route_*`` counters (every tier label,
    including the per-:class:`~repro_torch.tune.rebuild.TunedTier` ones).

    Caller-owned ``telemetry_sink`` dicts are **not** reset: the caller
    owns that dict's lifetime (zero it, or take a fresh
    :func:`_fresh_tier_metrics`)."""
    from repro_torch import obs

    obs.reset(prefix="route_")


def derived_tier_metrics(counters: dict) -> dict:
    """Raw routing counters + the derived rates (drop rate, mean
    imbalance), shared by the global view and per-tier sinks.  Missing
    keys count as zero, so an empty snapshot yields 0.0 rates."""
    m = {**_fresh_tier_metrics(), **counters}
    m["drop_rate"] = m["dropped"] / m["queries"] if m["queries"] else 0.0
    m["imbalance_mean"] = m["routed_max"] / m["routed_even"] if m["routed_even"] else 0.0
    return m


def _tier_counters_from_obs(tier: str) -> dict:
    """One tier label's ``route_*`` registry samples in the counter-dict
    shape of :func:`_fresh_tier_metrics`."""
    from repro_torch import obs

    snap = obs.snapshot(prefix="route_")

    def v(name):
        return obs.sample_value(snap, name, tier=tier)

    return {
        "lookups": int(v("route_lookups")),
        "queries": int(v("route_queries")),
        "dropped": int(v("route_dropped")),
        "routed_max": int(v("route_max")),
        "routed_even": v("route_even"),
        "imbalance_last": v("route_imbalance_last"),
        "imbalance_peak": v("route_imbalance_peak"),
    }


def tier_metrics() -> dict:
    """Routing-imbalance and drop-rate counters across every telemetry-on
    :func:`sharded_lookup` in the process since the last reset.

    ``imbalance_*`` is the busiest shard's load over the perfectly even
    load (1.0 = uniform routing; ``n_shards`` = fully skewed);
    ``drop_rate`` is the fraction of queries returned as :data:`DROPPED`.
    A caller serving several tiers passes a ``telemetry_label`` (a
    per-tier ``route_*`` labelset) or its own ``telemetry_sink``; this
    view aggregates all of them (``obs.snapshot(prefix="route_")`` shows
    the same counters with labels)."""
    return derived_tier_metrics(_tier_counters_from_obs(_ALL_TIERS))


def _owner_histogram(fences, queries, n_shards: int):
    """Queries owned by each shard, ``(n_shards,)`` int64 on the queries'
    device: :func:`route_owners` and one ``bincount``."""
    owners = route_owners(fences, queries)
    return torch.bincount(owners.long(), minlength=n_shards)


def _record_tier_metrics(sidx: "ShardedIndex", queries, out, sink: dict | None = None,
                         label: str | None = None) -> None:
    from repro_torch import obs

    hist = _owner_histogram(sidx.fences, queries, sidx.n_shards)
    # one copy to the host: the histogram and the count of drops
    host = torch.cat([hist, (out == DROPPED).sum().reshape(1)]).cpu().numpy()
    hist, dropped = host[:-1], int(host[-1])
    b = int(hist.sum())
    even = b / sidx.n_shards
    imb = float(hist.max() / even) if even > 0 else 0.0
    tiers = [_ALL_TIERS] if label is None else [_ALL_TIERS, str(label)]
    for t in tiers:
        obs.metric("route_lookups").inc(tier=t)
        obs.metric("route_queries").inc(b, tier=t)
        obs.metric("route_dropped").inc(dropped, tier=t)
        obs.metric("route_max").inc(int(hist.max()), tier=t)
        obs.metric("route_even").inc(even, tier=t)
        obs.metric("route_imbalance_last").set(imb, tier=t)
        obs.metric("route_imbalance_peak").max(imb, tier=t)
    if label is not None:
        # per-owner-shard counts, labeled tiers only (the "all" view would
        # mix tiers of different shard counts): the density estimate
        # weighted_quantile_bounds rebalances from
        shard_q = obs.metric("route_shard_queries")
        for s, c in enumerate(hist):
            if c:
                shard_q.inc(int(c), tier=str(label), shard=s)
    if sink is not None:
        sink["lookups"] += 1
        sink["queries"] += b
        sink["dropped"] += dropped
        sink["routed_max"] += int(hist.max())
        sink["routed_even"] += even
        sink["imbalance_last"] = imb
        sink["imbalance_peak"] = max(sink["imbalance_peak"], imb)


def shard_query_weights(tier: str, n_shards: int) -> np.ndarray:
    """Observed per-owner-shard query counts of one labeled tier, read
    back from the ``route_shard_queries`` registry counter (zeros where a
    shard never owned a query): what
    :meth:`repro_torch.tune.rebuild.TunedTier.maybe_rebalance` windows to
    detect sustained drift."""
    from repro_torch import obs

    snap = obs.snapshot(prefix="route_shard_queries")
    return np.asarray(
        [obs.sample_value(snap, "route_shard_queries", tier=str(tier), shard=s)
         for s in range(n_shards)],
        dtype=np.float64,
    )


#: the key the a2a path pads a ragged batch and fills empty request slots
#: with: the reference's uint64 ``0``, encoded
PAD_KEY = keymod.SIGN

_MAXKEY = np.uint64(np.iinfo(np.uint64).max)

#: statics that hold bucketed loop trip counts: extra iterations are
#: no-ops, so stacking takes the max across tables.  ``pksteps`` /
#: ``rk_epi`` are the fused PGM / RadixSpline kernels' trip counts.
_STEP_KEYS = ("epi", "ksteps", "pksteps", "rk_epi")


def _pow2ceil(x: int) -> int:
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def _pad_to(arr: np.ndarray, shape: tuple) -> np.ndarray:
    """Pad ``arr`` up to ``shape`` with inert sentinels: uint64 key arrays
    get the max key, everything else repeats its last entry."""
    arr = np.asarray(arr)
    if arr.shape == tuple(shape):
        return arr
    widths = [(0, t - s) for s, t in zip(arr.shape, shape)]
    if any(w < 0 for _, w in widths):
        raise ValueError(f"cannot shrink leaf of shape {arr.shape} to {shape}")
    if arr.dtype == np.uint64:
        return np.pad(arr, widths, mode="constant", constant_values=_MAXKEY)
    return np.pad(arr, widths, mode="edge")


def _lift_pgm_levels(static: tuple, arrays: dict, target: int) -> tuple:
    """Lift a PGM-shaped index (numpy leaves) to ``target`` levels by
    prepending trivial one-segment root levels; returns ``(static, arrays)``.

    The PGM build always ends in a one-segment root, so a synthetic root
    (slope 0, ``rank0 = [0, 1]``) predicts the window ``[0, 0]`` over the
    level below: the next level's search lands on the old root and the
    lifted index answers identically."""
    levels = dict(static)["levels"]
    extra = target - levels
    if extra == 0:
        return static, arrays
    if extra < 0:
        raise ValueError(f"cannot lower a PGM from {levels} to {target} levels")
    sizes = np.asarray(arrays["sizes"])
    keys, slope, rank0 = arrays["keys"], arrays["slope"], arrays["rank0"]
    pk_u0, pk_slope = arrays["pk_u0"], arrays["pk_slope"]
    kv = int(sizes.sum())  # valid prefix before the pow2 sentinel pad
    rv = int((sizes + 1).sum())
    new_keys = np.concatenate([np.full(extra, keys[0], keys.dtype), keys[:kv]])
    new_slope = np.concatenate([np.zeros(extra, slope.dtype), slope[:kv]])
    new_rank0 = np.concatenate([np.tile(np.asarray([0, 1], rank0.dtype), extra), rank0[:rv]])
    # the synthetic roots anchor at keys[0], whose kernel coordinate is
    # pk_u0[0]; slope 0 keeps the fused descent's window at [0, 0] too
    new_pk_u0 = np.concatenate([np.full(extra, pk_u0[0], pk_u0.dtype), pk_u0[:kv]])
    new_pk_slope = np.concatenate([np.zeros(extra, pk_slope.dtype), pk_slope[:kv]])
    new_sizes = np.concatenate([np.ones(extra, sizes.dtype), sizes]).astype(np.int64)
    out = dict(arrays)
    out.update(_pgm_level_arrays(new_keys, new_slope, new_rank0, new_pk_u0, new_pk_slope,
                                 new_sizes))
    return tuple((k, target if k == "levels" else v) for k, v in static), out


def _pgm_level_arrays(keys, slope, rank0, pk_u0, pk_slope, sizes) -> dict:
    """The level leaves of a PGM-shaped index from its valid prefixes: the
    pow2 sentinel pads and the level directories, as the build makes them."""
    return {
        "keys": _pad_pow2(keys, _MAXKEY),
        "slope": _pad_pow2(slope, 0.0),
        "rank0": _pad_pow2(rank0, rank0[-1]),
        "pk_u0": _pad_pow2(pk_u0, np.float32(1.0)),
        "pk_slope": _pad_pow2(pk_slope, np.float32(0.0)),
        "sizes": sizes,
        "off": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        "off_r": np.concatenate([[0], np.cumsum(sizes + 1)]).astype(np.int64),
    }


def _pad_gapped_leaves(static: tuple, arrays: dict, target_l: int) -> tuple:
    """Pad a GAPPED index (numpy leaves) to ``target_l`` leaves with inert
    rows: max-key ``keys``/``fences``/``route`` and zero ``counts``;
    returns ``(static, arrays)``.

    The generic :func:`_pad_to` repeats the last entry of integer leaves,
    which would fabricate live keys in the padded rows: zero counts keep
    them empty (they absorb nothing and compaction skips them), and
    max-key route entries keep the owner search inside the real leaves."""
    n_leaves, cap = (int(d) for d in arrays["keys"].shape)
    if n_leaves == target_l:
        return static, arrays
    if n_leaves > target_l:
        raise ValueError(f"cannot shrink a GAPPED index from {n_leaves} to {target_l} leaves")
    pad = target_l - n_leaves
    out = dict(arrays)
    out["keys"] = np.concatenate([arrays["keys"], np.full((pad, cap), _MAXKEY, np.uint64)])
    out["counts"] = np.concatenate([arrays["counts"], np.zeros((pad,), np.int64)])
    for k in ("fences", "route"):
        out[k] = np.concatenate([arrays[k], np.full((pad,), _MAXKEY, np.uint64)])
    return static, out


def _harmonize(kind: str, per_table: list) -> list:
    """Make per-table ``(static, arrays)`` pairs stackable where the kind
    allows it: PGM-shaped kinds lift shallow tables to the deepest, GAPPED
    pads tables of fewer leaves with inert zero-count leaves."""
    if registry.entry(kind).query_key == "pgm":
        target = max(dict(s)["levels"] for s, _ in per_table)
        return [_lift_pgm_levels(s, a, target) for s, a in per_table]
    if kind == "GAPPED":
        target = max(int(a["keys"].shape[0]) for _, a in per_table)
        return [_pad_gapped_leaves(s, a, target) for s, a in per_table]
    return list(per_table)


def _self_contained(kind: str) -> bool:
    """Kinds that own their keys (GAPPED): their lookup ignores the table."""
    return impls.query_impl(kind).lookup is not None


def _live_lasts(arrays: dict) -> torch.Tensor:
    """The largest live key (leaves and delta) of each table of a stacked
    self-contained index, encoded."""
    keys, counts, delta = arrays["keys"], arrays["counts"], arrays["delta"]
    pos = torch.arange(keys.shape[-1], device=keys.device)
    main = torch.where(pos < counts[..., None], keys, keymod.SIGN).amax(dim=(-2, -1))
    dpos = torch.arange(delta.shape[-1], device=keys.device)
    dvals = torch.where(dpos < arrays["delta_count"][..., None], delta, keymod.SIGN)
    return torch.maximum(main, dvals.amax(-1))


def _merge_static(statics: list) -> tuple:
    """Merge per-table statics: bucketed trip counts take the max (extra
    bounded-search trips are no-ops); everything structural (levels,
    fanout, degree, r_bits, ...) must agree exactly."""
    merged = []
    for i, (name, v0) in enumerate(statics[0]):
        if any(s[i][0] != name for s in statics):
            raise ValueError("per-table indexes have mismatched static keys")
        vals = [s[i][1] for s in statics]
        if name in _STEP_KEYS:
            merged.append((name, max(vals)))
        elif len(set(vals)) != 1:
            raise ValueError(
                f"cannot stack: static {name!r} differs across tables ({sorted(set(vals))}); "
                "structural statics must agree — rebuild with a table-stable spec"
            )
        else:
            merged.append((name, v0))
    return tuple(merged)


def stack_arrays(per_table: list) -> tuple:
    """Stack harmonized ``(static, arrays)`` pairs (numpy, reference
    layout) leaf-wise: ``(merged static, stacked arrays)``."""
    if not per_table:
        raise ValueError("need at least one index to stack")
    names = set(per_table[0][1])
    if any(set(a) != names for _, a in per_table):
        raise ValueError("per-table indexes have mismatched leaf names")
    static = _merge_static([s for s, _ in per_table])
    arrays = {}
    for name in sorted(names):
        leaves = [np.asarray(a[name]) for _, a in per_table]
        if len({leaf.ndim for leaf in leaves}) != 1:
            raise ValueError(f"leaf {name!r} rank differs across tables")
        target = tuple(max(dims) for dims in zip(*[leaf.shape for leaf in leaves]))
        arrays[name] = np.stack([_pad_to(leaf, target) for leaf in leaves])
    return static, arrays


def stack_indexes(indexes: list, *, device=None) -> Index:
    """Stack N same-spec indexes leaf-wise into one :class:`Index` whose
    leaves carry a leading table axis (on ``device``, default: the first
    index's device).  Structural statics must agree: PGM-shaped indexes
    of different depths go through :func:`_harmonize` first."""
    if not indexes:
        raise ValueError("need at least one index to stack")
    kinds = {i.kind for i in indexes}
    if len(kinds) != 1:
        raise ValueError(f"cannot stack indexes of different kinds: {sorted(kinds)}")
    kind = indexes[0].kind
    static, arrays = stack_arrays([(i.static, i.to_numpy()) for i in indexes])
    info = {"n_shards": len(indexes), "name": f"sharded-{indexes[0].name}"}
    dev = indexes[0].device if device is None else device
    return Index.from_numpy(kind, static, arrays, info, device=dev)


def _pad_sorted_table(t: np.ndarray, m: int) -> np.ndarray:
    """Pad a sorted table to length ``m`` with a strictly increasing
    continuation of its last key, spread over the remaining headroom.

    The table stays sorted and unique, so every build sees a well-formed
    table, and the rank clamp against the table's valid count maps any
    hit in the padded tail back to the last real key.  With no headroom
    (last key at the top of the u64 range) the pad repeats the last key."""
    if len(t) == 0:
        raise ValueError("empty shard")
    pad = m - len(t)
    if pad < 0:
        raise ValueError(f"shard has {len(t)} keys > padded capacity {m}")
    if pad == 0:
        return t
    last = np.uint64(t[-1])
    room = int(_MAXKEY) - int(last)
    if room >= pad:
        # spread the pad across the headroom: tightly clustered pad keys
        # make per-segment least-squares fits ill-conditioned
        step = np.uint64(room // pad)
        ext = last + np.arange(1, pad + 1, dtype=np.uint64) * step
    else:
        ext = np.full(pad, last, dtype=t.dtype)
    return np.concatenate([t, ext])




# ---------------------------------------------------------------------------
# The tier
# ---------------------------------------------------------------------------


class ShardedIndex:
    """A tier of per-shard learned indexes over a partitioned keyspace.

    index:   stacked :class:`Index`: every leaf has a leading axis over the
             held shards.
    tables:  ``(held, m)`` encoded int64 per-shard sorted tables, padded to
             a common power-of-two ``m`` (strictly increasing pad).
    fences:  ``(n_shards,)`` encoded first key of each shard; the router
             searches ``fences[1:]``.
    counts:  ``(n_shards,)`` int64 valid (unpadded) keys per shard.
    offsets: ``(n_shards,)`` int64 global rank of each shard's first key.
    lasts:   ``(n_shards,)`` encoded last live key of each shard (what
             :func:`refresh_shard` checks a rebuilt neighbour against;
             kept live by :func:`insert_into_shard`, where a GAPPED
             shard's ``tables`` row becomes a stale snapshot).
    first:   the shard number of the first held row: the held shards are
             ``first .. first + held - 1`` (all of them, or one).
    """

    __slots__ = ("index", "tables", "fences", "counts", "offsets", "lasts", "first", "info")

    def __init__(self, index: Index, tables, fences, counts, offsets, info=None, *, lasts=None,
                 first: int = 0):
        if lasts is None:  # each shard's last live key: every shard must be held
            if first != 0 or tables.shape[0] != counts.shape[0]:
                raise ValueError("a tier that holds some of its shards needs their last keys")
            if _self_contained(index.kind):  # the tables are build-time snapshots
                lasts = _live_lasts(index.arrays)
            else:
                lasts = tables[torch.arange(tables.shape[0], device=tables.device), counts - 1]
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "tables", tables)
        object.__setattr__(self, "fences", fences)
        object.__setattr__(self, "counts", counts)
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "lasts", lasts)
        object.__setattr__(self, "first", int(first))
        object.__setattr__(self, "info", dict(info or {}))

    @property
    def n_shards(self) -> int:
        return int(self.fences.shape[0])

    @property
    def held(self) -> range:
        """The shard numbers whose leaves and tables this process holds."""
        return range(self.first, self.first + int(self.tables.shape[0]))

    @property
    def kind(self) -> str:
        return self.index.kind

    @property
    def device(self) -> torch.device:
        return self.tables.device

    def __repr__(self):
        return (f"ShardedIndex(kind={self.kind!r}, n_shards={self.n_shards}, "
                f"m={int(self.tables.shape[1])}, held={self.held.start}..{self.held.stop - 1})")

    def _row(self, s: int) -> int:
        if s not in self.held:
            raise ValueError(f"shard {s} is not held here (this tier holds shards "
                             f"{self.held.start}..{self.held.stop - 1} of {self.n_shards})")
        return s - self.first

    def shard(self, s: int) -> Index:
        """The per-shard :class:`Index` view of held shard ``s`` (sliced leaves)."""
        row = self._row(s)
        return Index(self.index.kind, self.index.static,
                     {k: v[row] for k, v in self.index.arrays.items()},
                     info={"shard": s, **self.info})

    def space_bytes(self) -> int:
        """Model bytes across the tier plus the router's fence, count and
        offset arrays."""
        router = 8 * (self.fences.numel() + self.counts.numel() + self.offsets.numel())
        return self.n_shards * self.shard(self.first).space_bytes() + router

    @staticmethod
    def build(kind_or_spec, table_np, n_shards: int, *, bounds=None, device=None,
              **params) -> "ShardedIndex":
        """Partition a global sorted uint64 table into ``n_shards``
        contiguous shards, build one same-spec index per shard (on the
        padded shard tables, as the reference does; a self-contained kind
        such as GAPPED on the raw ones, so no pad key becomes live), and
        stack them on ``device`` (default: the card).

        ``bounds`` overrides the even split with an explicit strictly
        increasing rank partition ``[0, ..., n]`` of length
        ``n_shards + 1``."""
        dev = resolve_device(device)
        table_np = np.asarray(table_np, dtype=np.uint64)
        n = len(table_np)
        if n_shards < 1 or n_shards > n:
            raise ValueError(f"n_shards={n_shards} must be in [1, {n}]")
        if isinstance(kind_or_spec, IndexSpec):
            spec = kind_or_spec
        else:
            spec = registry.spec_for(str(kind_or_spec), **params)
        if bounds is None:
            bounds = [round(i * n / n_shards) for i in range(n_shards + 1)]
        else:
            bounds = [int(b) for b in np.asarray(bounds).reshape(-1)]
            if (len(bounds) != n_shards + 1 or bounds[0] != 0 or bounds[-1] != n
                    or any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:]))):
                raise ValueError(
                    f"bounds must be a strictly increasing rank partition [0, ..., {n}] "
                    f"of length {n_shards + 1}, got {bounds}")
        locals_ = [table_np[bounds[i]:bounds[i + 1]] for i in range(n_shards)]
        m = _pow2ceil(max(len(t) for t in locals_))
        padded = [_pad_sorted_table(t, m) for t in locals_]
        build_tables = locals_ if _self_contained(spec.kind) else padded
        per_shard = [registry.entry(spec.kind).build(spec, p) for p in build_tables]
        stacked = stack_arrays(_harmonize(spec.kind, [(s, a) for s, a, _ in per_shard]))
        name = per_shard[0][2].get("name", spec.kind)
        index = Index.from_numpy(spec.kind, *stacked,
                                 {"n_shards": n_shards, "name": f"sharded-{name}"}, device=dev)
        counts = np.asarray([len(t) for t in locals_], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        fences = np.asarray([t[0] for t in locals_], dtype=np.uint64)
        return ShardedIndex(
            index=index,
            tables=keymod.encode(np.stack(padded), dev),
            fences=keymod.encode(fences, dev),
            counts=torch.from_numpy(counts).to(dev),
            offsets=torch.from_numpy(offsets).to(dev),
            info={"spec": spec.display_name(), "n": n, "m": m},
            lasts=keymod.encode(np.asarray([t[-1] for t in locals_], dtype=np.uint64), dev),
        )

    def save(self, path) -> None:
        """npz in the reference's layout (``idx_<leaf>``, ``tables``,
        ``fences``, ``counts``, ``offsets`` and a JSON ``__meta__``; keys
        as uint64), so either package reads the other's files.  Needs
        every shard held."""
        if len(self.held) != self.n_shards:
            raise ValueError("save needs every shard held; this tier holds "
                             f"{self.held.start}..{self.held.stop - 1} of {self.n_shards}")
        payload = {f"idx_{k}": v for k, v in self.index.to_numpy().items()}
        payload.update(tables=keymod.decode(self.tables), fences=keymod.decode(self.fences),
                       counts=self.counts.cpu().numpy(), offsets=self.offsets.cpu().numpy())
        meta = {
            "kind": self.index.kind,
            "static": list(map(list, self.index.static)),
            "info": {k: v for k, v in self.info.items() if isinstance(v, (str, int, float, bool))},
        }
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path, *, device=None, shard=None) -> "ShardedIndex":
        """Read an npz written by either package's ``save`` onto ``device``
        (default: the card): every shard, or with ``shard=s`` only shard
        ``s``'s leaves and table (the fences, counts, offsets and last keys
        of every shard).  A self-contained kind's last keys come from every
        shard's leaves, as its tables may be stale snapshots."""
        dev = resolve_device(device)
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k[len("idx_"):]: z[k] for k in z.files if k.startswith("idx_")}
            tables, fences = z["tables"], z["fences"]
            counts, offsets = z["counts"], z["offsets"]
        if _self_contained(meta["kind"]):
            leaves = {k: torch.from_numpy(np.asarray(arrays[k])) for k in
                      ("counts", "delta_count")}
            leaves.update({k: keymod.encode(arrays[k], "cpu") for k in ("keys", "delta")})
            lasts = keymod.decode(_live_lasts(leaves))
        else:
            lasts = tables[np.arange(len(counts)), counts - 1]
        first = 0
        if shard is not None:
            if not 0 <= shard < len(counts):
                raise ValueError(f"shard {shard} out of range [0, {len(counts)})")
            first = int(shard)
            arrays = {k: v[first:first + 1] for k, v in arrays.items()}
            tables = tables[first:first + 1]
        static = tuple((k, int(v)) for k, v in meta["static"])
        index = Index.from_numpy(meta["kind"], static, arrays, meta.get("info"), device=dev)
        return cls(index, keymod.encode(tables, dev), keymod.encode(fences, dev),
                   torch.from_numpy(counts).to(dev), torch.from_numpy(offsets).to(dev),
                   info=meta.get("info"), lasts=keymod.encode(lasts, dev), first=first)


# ---------------------------------------------------------------------------
# Routing, local answer, the one-process sweep
# ---------------------------------------------------------------------------


def route_owners(fences, queries):
    """Owner shard (int32) of each encoded query: a search of the fence
    array (``fences[0]`` is the global minimum, not a boundary)."""
    from repro_torch.kernels.kary_search import kary_owner_route

    return kary_owner_route(fences[1:], queries)


def _answer_local(local_index: Index, local_table, count, offset, queries, backend: str):
    """A shard's answer: the shared lookup body on its leaves, the local
    rank clamped to the valid count and rebased to a global rank.  Also
    takes a stacked index with ``(N, m)`` tables, ``(N, B)`` queries and
    ``(N, 1)`` counts and offsets: every shard at once."""
    r = torch.minimum(lookup_impl(local_index, local_table, queries, backend), count - 1)
    return torch.where(r < 0, NO_PRED, offset + r)


def _answer_shard(sidx: ShardedIndex, s: int, queries, backend: str):
    """Held shard ``s``'s global ranks of ``queries`` (one table's lookup:
    ``backend="kernel"`` launches the kind's single-table kernel)."""
    return _answer_local(sidx.shard(s), sidx.tables[sidx._row(s)], sidx.counts[s],
                         sidx.offsets[s], queries, backend)


def _lookup_vmapped(sidx: ShardedIndex, queries, backend: str):
    """Every shard answers every query (``backend="kernel"``: one batched
    launch), then each query keeps its owner's answer: the reference's
    single-device sweep, a leading shard axis for its ``vmap``."""
    if len(sidx.held) != sidx.n_shards:
        raise ValueError(f"mode='ref' needs every shard held; this tier holds "
                         f"{sidx.held.start}..{sidx.held.stop - 1} of {sidx.n_shards}")
    owners = route_owners(sidx.fences, queries)
    bq = queries[None, :].expand(sidx.n_shards, queries.shape[0])
    granks = _answer_local(sidx.index, sidx.tables, sidx.counts[:, None], sidx.offsets[:, None],
                           bq, backend)
    return torch.take_along_dim(granks, owners[None, :].long(), dim=0)[0]


# ---------------------------------------------------------------------------
# The collective modes: a2a exchange and allgather (all_reduce)
# ---------------------------------------------------------------------------


def a2a_requests(sidx: ShardedIndex, q_loc, cap: int, group):
    """The first half of the a2a exchange on one rank: route its slice of
    the batch, bucket it by owner into ``(n_shards, cap)`` requests (empty
    slots hold :data:`PAD_KEY`) and exchange them.  Returns ``(received,
    slots, valid, order)``: row ``i`` of ``received`` holds the requests
    from group rank ``i``, which this rank answers on its own shard."""
    owner = route_owners(sidx.fences, q_loc)
    req, slots, valid, order = collectives.bucket_by_owner(owner, q_loc, sidx.n_shards, cap,
                                                           PAD_KEY)
    return collectives.all_to_all(req, group), slots, valid, order


def _lookup_a2a(sidx: ShardedIndex, q_loc, group, me: int, backend: str, cap: int):
    """Global ranks of this rank's slice ``q_loc`` of the padded batch:
    requests out, the local answer, replies back, unsorted (drops keep
    :data:`DROPPED`)."""
    received, slots, valid, order = a2a_requests(sidx, q_loc, cap, group)
    g = _answer_shard(sidx, me, received.reshape(-1), backend)
    back = collectives.all_to_all(g.reshape(sidx.n_shards, cap), group)
    return collectives.unbucket_inverse(back, slots, valid, order, q_loc.shape[0], DROPPED)


def _lookup_allgather(sidx: ShardedIndex, queries, ctx, axes: tuple, backend: str):
    """Every rank answers the whole batch on its own shard and keeps the
    queries it owns; one all_reduce (sum) over the group merges them."""
    me = ctx.axes_group(axes)[1]
    owner = route_owners(sidx.fences, queries)
    g = _answer_shard(sidx, me, queries, backend)
    mine = torch.where(owner.long() == me, g, torch.zeros_like(g))
    return collectives.psum_if_mapped(mine, axes, ctx)


def _gather_slices(part, group, n_ranks: int):
    """Every rank's ``(b_loc,)`` slice, in group-rank order: the ``(B,)``
    global answer on every rank."""
    parts = [torch.empty_like(part) for _ in range(n_ranks)]
    dist.all_gather(parts, part.contiguous(), group=group)
    return torch.cat(parts)


#: the reference's lookup modes
MODES = ("auto", "a2a", "allgather", "ref")

#: backends of the tier's local answer: all of ``Index.lookup``'s
TIER_BACKENDS = BACKENDS


def sharded_lookup(sidx: ShardedIndex, queries, ctx=None, *, backend: str = "kernel",
                   mode: str = "auto", cap_factor: float = 2.0, telemetry: bool = False,
                   telemetry_sink: dict | None = None, telemetry_label: str | None = None):
    """Predecessor ranks (int64, global) of a flat ``(B,)`` query batch
    (uint64 numpy or encoded int64) against the whole tier: equal to
    ``Index.lookup`` on the concatenated table, but the over-capacity
    drops of ``mode="a2a"``, which report :data:`DROPPED`.

    ``ctx`` is a :class:`~repro_torch.dist.sharding.ShardingCtx`; the tier
    is laid out over its ``tp`` axis, one shard a rank (the rank at
    position ``s`` of the ``tp`` group holds shard ``s``).  Under a
    context every rank of the group calls with the same batch and gets
    the same ``(B,)`` answer.  ``mode``:

    * ``"a2a"`` — each rank routes a ``1/n_shards`` slice, a
      capacity-factored double ``all_to_all`` exchange (``cap_factor``;
      ``>= n_shards`` never drops);
    * ``"allgather"`` — masked local answers over the whole batch, merged
      with one ``all_reduce`` (never drops);
    * ``"ref"`` — the one-process sweep over every shard (needs them all
      held);
    * ``"auto"`` — ``a2a`` when the ``tp`` extent equals the shard count
      (> 1), else ``ref``.

    ``backend`` is any of :data:`TIER_BACKENDS` that the kind claims (not
    ``"kernel"`` for GAPPED, which raises).  ``"kernel"``: one launch
    of the kind's batched kernel for every shard in ``ref`` mode, one
    launch of its single-table kernel a rank in ``a2a`` and ``allgather``.

    ``telemetry=True`` also records the call's routing-imbalance and
    drop-rate counters into the :mod:`repro_torch.obs` registry
    (:func:`tier_metrics` is the aggregate view): one owner histogram on
    the device and one copy of it to the host, no search-kernel launch.
    ``telemetry_label`` attributes the same counters to a per-tier
    ``route_*`` labelset (and ``route_shard_queries``); the ``tier="all"``
    aggregate always updates.  ``telemetry_sink`` (a dict shaped as
    :func:`_fresh_tier_metrics`) receives the same updates.  Example::

        sidx = ShardedIndex.build("PGM", table, n_shards=4, eps=64)
        ranks = sharded_lookup(sidx, queries, backend="kernel")
        # on each of 4 ranks of a (1, 4) ("data", "model") mesh:
        mine = ShardedIndex.load(path, shard=ctx.index("tp"))
        ranks = sharded_lookup(mine, queries, ctx, mode="a2a")
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if backend not in TIER_BACKENDS:
        raise ValueError(f"unknown tier backend {backend!r}; choose from {TIER_BACKENDS}")
    check_backend(sidx.kind, backend)
    queries = keymod.as_keys(queries, sidx.device)
    if queries.dim() != 1:
        raise ValueError("sharded_lookup expects a flat (B,) query vector")
    n_shards = sidx.n_shards
    tp = ctx.n("tp") if ctx is not None else 1
    axes = ctx.mesh_axes("tp") if ctx is not None else ()
    spmd_ok = tp == n_shards and n_shards > 1 and bool(axes)
    if mode == "auto":
        mode = "a2a" if spmd_ok else "ref"
    if mode in ("a2a", "allgather") and not spmd_ok:
        raise ValueError(
            f"mode={mode!r} needs the mesh tp extent ({tp}) to equal n_shards "
            f"({n_shards}); use mode='ref' or 'auto'"
        )
    if mode == "ref":
        out = _lookup_vmapped(sidx, queries, backend)
    elif mode == "allgather":
        out = _lookup_allgather(sidx, queries, ctx, axes, backend)
    else:
        group, me = ctx.axes_group(axes)
        b = queries.shape[0]
        pad = (-b) % n_shards
        padded = torch.cat([queries, queries.new_full((pad,), PAD_KEY)]) if pad else queries
        b_loc = padded.shape[0] // n_shards
        cap = collectives.exchange_capacity(b_loc, n_shards, cap_factor)
        part = _lookup_a2a(sidx, padded[me * b_loc:(me + 1) * b_loc], group, me, backend, cap)
        out = _gather_slices(part, group, n_shards)[:b]
    if telemetry:
        _record_tier_metrics(sidx, queries, out, telemetry_sink, telemetry_label)
    return out


# ---------------------------------------------------------------------------
# In-place refresh
# ---------------------------------------------------------------------------


def refresh_shard(sidx: ShardedIndex, shard: int, new_index: Index, new_table) -> ShardedIndex:
    """Install a rebuilt shard into the tier in place; returns ``sidx``.

    The reference donates the old tier to a jitted ``.at[shard].set``;
    here the new leaves and table are written into the resident tensors,
    but only after every check has passed, so a refused install (a
    ``ValueError``) leaves the tier exactly as it was.  Under a sharding
    context every rank calls it the same way: the rank that holds
    ``shard`` writes its leaves and table, and every rank updates the
    fences, counts, offsets and last keys (a rebuilt shard may change its
    key count).

    ``new_index`` must be built with a shard-stable spec: structural
    statics must match the tier and its (padded) leaves must fit the
    stacked leaf shapes.  ``new_table`` is the shard's raw (unpadded)
    sorted uint64 keys, but the index must be fitted on
    :func:`shard_build_table` of it: the kinds normalise predictions by
    the lookup-time table length, which is the padded resident row.
    """
    kind = sidx.index.kind
    if new_index.kind != kind:
        raise ValueError(f"kind mismatch: tier is {kind!r}, got {new_index.kind!r}")
    static, arrays = new_index.static, new_index.to_numpy()
    if registry.entry(kind).query_key == "pgm":
        if dict(static)["levels"] < sidx.index.s("levels"):
            static, arrays = _lift_pgm_levels(static, arrays, sidx.index.s("levels"))
    for (name, have), (n2, new) in zip(sidx.index.static, static):
        if name != n2:
            raise ValueError("static key mismatch between tier and rebuilt shard")
        if name in _STEP_KEYS:
            if new > have:
                raise ValueError(
                    f"rebuilt shard needs {name}={new} > tier's {have}: restack the tier "
                    "(a larger trip count cannot be installed in place)"
                )
        elif new != have:
            raise ValueError(f"static {name!r} mismatch: tier {have}, rebuilt shard {new}")
    new_table = np.asarray(new_table, dtype=np.uint64)
    if len(new_table) == 0:
        raise ValueError("cannot install an empty shard")
    m = int(sidx.tables.shape[1])
    if len(new_table) > m:
        raise ValueError(f"rebuilt shard has {len(new_table)} keys > tier table capacity {m}")
    # the rebuilt key set must stay inside this shard's fence slot, or
    # global ranks would silently go wrong for every later shard
    if shard > 0:
        prev_last = keymod.decode(sidx.lasts[shard - 1:shard])[0]
        if new_table[0] <= prev_last:
            raise ValueError(
                f"rebuilt shard {shard} starts at {new_table[0]}, inside the previous "
                f"shard's range (its last key is {prev_last})"
            )
    if shard + 1 < sidx.n_shards:
        next_fence = keymod.decode(sidx.fences[shard + 1:shard + 2])[0]
        if new_table[-1] >= next_fence:
            raise ValueError(
                f"rebuilt shard {shard} ends at {new_table[-1]}, at or beyond the next "
                f"shard's fence {next_fence}"
            )
    if kind == "GAPPED":
        # inert zero-count leaf rows, not the generic edge replication
        static, arrays = _pad_gapped_leaves(static, arrays, int(sidx.index.arrays["keys"].shape[1]))
    leaves = {}
    for k, v in sidx.index.arrays.items():
        if k not in arrays:
            raise ValueError(f"rebuilt shard is missing leaf {k!r}")
        leaves[k] = _pad_to(arrays[k], tuple(v.shape[1:]))
    # encoded on the host by every rank, so every rank refuses alike
    new = Index.from_numpy(kind, static, leaves, device="cpu")
    padded_tab = keymod.encode(_pad_sorted_table(new_table, m), "cpu")
    # -- every check passed: write in place --
    if shard in sidx.held:
        row = sidx._row(shard)
        for k, v in sidx.index.arrays.items():
            v[row].copy_(new.arrays[k])
        sidx.tables[row].copy_(padded_tab)
    ends = keymod.encode_np(new_table[[0, -1]])
    sidx.fences[shard] = int(ends[0])
    sidx.lasts[shard] = int(ends[1])
    sidx.counts[shard] = len(new_table)
    sidx.offsets.copy_(torch.cumsum(sidx.counts, 0) - sidx.counts)
    return sidx


# ---------------------------------------------------------------------------
# Skew-aware rebalancing: weighted-quantile fences + ordered re-shard
# ---------------------------------------------------------------------------


def shard_build_table(kind: str, part, m: int) -> np.ndarray:
    """The table a replacement shard index must be *fitted* on to be
    installable at stacked capacity ``m`` (as :meth:`ShardedIndex.build`
    fits): for the static kinds the padded table, because their query
    paths normalise model predictions by the lookup-time table length,
    which is the resident padded row; for self-contained kinds (GAPPED),
    which own their keys, the raw part, so a pad key never becomes live.
    Raises ``ValueError`` when a static kind's ``part`` no longer fits
    ``m`` (the restack cue)."""
    registry.entry(kind)
    part = np.asarray(part, dtype=np.uint64)
    if _self_contained(kind):
        return part
    return _pad_sorted_table(part, m)


def weighted_quantile_bounds(merged_keys, fences, weights) -> np.ndarray:
    """Rank partition of ``merged_keys`` that evens out *observed* load.

    The per-shard query counts ``weights`` (one per current fence slot)
    define a piecewise-constant traffic density over the sorted global
    key set: every key in current shard ``s`` carries ``weights[s]``
    spread evenly over that shard's keys.  Inverting the cumulative
    weight at ``j/S`` for ``j = 1..S-1`` yields new shard bounds under
    which each shard would have answered an equal share of the observed
    traffic.

    Degenerate inputs stay well-formed: an all-zero weight vector falls
    back to the even split, and the bounds are clamped to a strictly
    increasing partition with at least one key per shard
    (:func:`refresh_shard` rejects empty shards).  Keys outside the
    current fence range attach to the nearest shard.  Host numpy, as in
    the reference; ``fences`` are uint64 keys (``keys.decode`` of a
    tier's).
    """
    merged = np.asarray(merged_keys, dtype=np.uint64)
    fences = np.asarray(fences, dtype=np.uint64)
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    n, S = len(merged), len(fences)
    if len(w) != S:
        raise ValueError(f"got {len(w)} weights for {S} fence slots")
    if n < S:
        raise ValueError(f"cannot split {n} keys across {S} shards")
    own = np.clip(np.searchsorted(fences, merged, side="right") - 1, 0, S - 1)
    per_owner = np.bincount(own, minlength=S).astype(np.float64)
    if w.sum() <= 0:
        w = np.ones(S, dtype=np.float64)
    # a shard that owns no current keys contributes no density rows;
    # spread every observed weight over its owner's resident keys
    per_key = np.where(per_owner[own] > 0, w[own] / np.maximum(per_owner[own], 1.0), 0.0)
    if per_key.sum() <= 0:
        per_key = np.ones(n, dtype=np.float64)
    cum = np.cumsum(per_key)
    targets = cum[-1] * np.arange(1, S, dtype=np.float64) / S
    inner = np.searchsorted(cum, targets, side="left") + 1
    # clamp to a strictly increasing partition with >= 1 key per shard
    for j in range(len(inner)):
        lo = (inner[j - 1] + 1) if j else 1
        inner[j] = max(int(inner[j]), lo)
    for j in range(len(inner) - 1, -1, -1):
        hi = (inner[j + 1] - 1) if j + 1 < len(inner) else n - 1
        inner[j] = min(int(inner[j]), hi)
    return np.concatenate([[0], inner, [n]]).astype(np.int64)


def rebalance_shards(sidx: ShardedIndex, merged_keys, bounds, build_shard) -> ShardedIndex:
    """Repartition the tier at ``bounds`` over the global sorted key set
    through :func:`refresh_shard` installs, in place; returns ``sidx``.

    Each boundary move orders only the two adjacent shards' installs
    (``refresh_shard`` checks the new shard against the *current*
    neighbours: a boundary moving right means the right shard must shrink
    before the left can grow, and vice versa), so the dependencies form
    an acyclically oriented path and a deferred-retry sweep ends in at
    most ``n_shards`` rounds; a refused install leaves the tier as it was
    and is retried.  Raises ``ValueError`` when a rebuilt shard cannot be
    installed at all (e.g. it outgrew the stacked table capacity): the
    caller's cue to rebuild with ``ShardedIndex.build(..., bounds=...)``.

    ``build_shard(build_table)`` builds the per-shard :class:`Index` for a
    key slice already run through :func:`shard_build_table`.  Every shard
    is built, and capacity-checked, before the first install, so a
    partition that cannot be installed fails with the tier intact.  Under
    a sharding context every rank calls it the same way.
    """
    merged = np.asarray(merged_keys, dtype=np.uint64)
    bounds = np.asarray(bounds, dtype=np.int64).reshape(-1)
    S = sidx.n_shards
    if len(bounds) != S + 1 or bounds[0] != 0 or bounds[-1] != len(merged):
        raise ValueError(
            f"bounds must partition [0, {len(merged)}] into {S} shards, got {bounds.tolist()}"
        )
    if (np.diff(bounds) < 1).any():
        raise ValueError(f"bounds must give every shard >= 1 key, got {bounds.tolist()}")
    m = int(sidx.tables.shape[1])
    kind = sidx.index.kind
    parts = [merged[bounds[s]:bounds[s + 1]] for s in range(S)]
    built = [build_shard(shard_build_table(kind, p, m)) for p in parts]
    remaining = set(range(S))
    while remaining:
        progressed = False
        last_err: Exception | None = None
        for s in sorted(remaining):
            try:
                refresh_shard(sidx, s, built[s], parts[s])
            except ValueError as e:
                last_err = e
                continue
            remaining.discard(s)
            progressed = True
        if not progressed:
            raise ValueError(f"rebalance not installable via refresh_shard: {last_err}")
    return sidx


# ---------------------------------------------------------------------------
# In-place shard mutation (updatable kinds: GAPPED)
# ---------------------------------------------------------------------------

#: the shard's holder raised NeedsRebuild (the status word of a mutation's exchange)
_REFUSED = 1


def _mutate_shard(sidx: ShardedIndex, shard: int, ctx, mutate) -> tuple:
    """Run ``mutate(local) -> (new_local, report_or_None, new_count)`` on
    held shard ``shard``'s :class:`Index` view, then write its leaves and
    the tier's vectors in place; returns the report.  Nothing is written
    when ``mutate`` raises.  A tier that holds one shard learns the new
    count, fence, last key and report from the holder: every rank of the
    ``tp`` group calls alike and one ``all_reduce`` (max) over ``ctx``'s
    group carries them (the holder's entries, the minimum elsewhere)."""
    local_tier = len(sidx.held) != sidx.n_shards
    if local_tier and (ctx is None or ctx.group("tp") is None):
        raise ValueError(f"a tier that holds shards {sidx.held.start}..{sidx.held.stop - 1} of "
                         f"{sidx.n_shards} mutates a shard only under its sharding context "
                         "(pass ctx)")
    new_local, report, err = None, None, None
    if shard in sidx.held:
        try:
            new_local, report, count = mutate(sidx.shard(shard))
        except mutation.NeedsRebuild as e:
            if not local_tier:
                raise
            err = e
    if local_tier:
        vec = torch.full((11,), keymod.SIGN, dtype=torch.int64, device=sidx.device)
        if shard in sidx.held:
            vec[0] = _REFUSED if err is not None else 0
        if new_local is not None:
            vec[1] = count
            vec[2] = new_local.arrays["fences"][0]
            vec[3] = _live_lasts(new_local.arrays)
            if report is not None:
                vec[4:] = torch.tensor([report.requested, report.absorbed, report.overflowed,
                                        report.duplicates, report.delta_count, report.delta_cap,
                                        int(report.compacted)])
        dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=ctx.group("tp"))
        got = vec.tolist()
        if got[0] == _REFUSED:
            raise err if err is not None else mutation.NeedsRebuild(
                f"shard {shard}'s holder refused the mutation: NeedsRebuild")
        count, fence, last = got[1:4]
        if got[4] != keymod.SIGN:
            report = mutation.InsertReport(*got[4:10], compacted=bool(got[10]))
    else:
        fence, last = new_local.arrays["fences"][0], _live_lasts(new_local.arrays)
    # -- every check passed: write in place --
    if new_local is not None:
        row = sidx._row(shard)
        for k, v in sidx.index.arrays.items():
            v[row].copy_(new_local.arrays[k])
    sidx.fences[shard] = fence
    sidx.lasts[shard] = last
    sidx.counts[shard] = count
    sidx.offsets.copy_(torch.cumsum(sidx.counts, 0) - sidx.counts)
    return report


def insert_into_shard(sidx: ShardedIndex, shard: int, keys, ctx=None, *,
                      auto_compact: bool = True) -> tuple:
    """Absorb a key batch (uint64 numpy or encoded) into one shard of an
    updatable tier without rebuilding; returns ``(sidx, InsertReport)``.

    The shard's :class:`Index` view runs the kind's ``insert_batch``
    (gap absorption first, delta overflow second; see
    :mod:`repro_torch.index.mutation`), and its new leaves are written
    into the tier in place, with the shard's count, fence (its live
    minimum), last live key and the offsets, once every check has
    passed: a refusal (the fence ``ValueError``, ``NeedsRebuild``)
    leaves the tier as it was.  ``sidx.tables`` is not touched: a
    self-contained kind's lookup ignores it, and it becomes a stale
    build-time snapshot.  As in the reference, only the next fence is
    checked: route keys with :func:`route_owners` first.

    A tier loaded one shard a rank (``ShardedIndex.load(path, shard=s)``)
    takes ``ctx``: every rank of its ``tp`` group calls alike, the rank
    that holds ``shard`` writes its leaves and every rank updates the
    per-shard vectors and gets the report.  Raises ``TypeError`` for
    static kinds and :class:`~repro_torch.index.NeedsRebuild` when the
    shard's fixed capacity is exhausted, the cue to rebuild the shard
    through :func:`refresh_shard`."""
    if not 0 <= shard < sidx.n_shards:
        raise ValueError(f"shard {shard} out of range [0, {sidx.n_shards})")
    keys = keymod.as_keys(keys, sidx.device).reshape(-1)
    if keys.numel() and shard + 1 < sidx.n_shards:
        # fence discipline: a key at/beyond the next fence belongs to a
        # later shard; absorbing it here would corrupt global ranks
        top, next_fence = keymod.decode(torch.stack([keys.max(), sidx.fences[shard + 1]]))
        if top >= next_fence:
            raise ValueError(
                f"key {int(top)} at/beyond shard {shard}'s next fence "
                f"{int(next_fence)}: route keys with route_owners first"
            )
    mutation._mutator(sidx.index)  # static kinds raise TypeError on every rank

    def mutate(local):
        new, report = mutation.insert_batch(local, keys, auto_compact=auto_compact)
        return new, report, int(sidx.counts[shard]) + report.absorbed + report.overflowed

    return sidx, _mutate_shard(sidx, shard, ctx, mutate)


def compact_shard(sidx: ShardedIndex, shard: int, ctx=None) -> ShardedIndex:
    """Fold one updatable shard's delta buffer into its leaves in place;
    returns ``sidx``.  The live key set, so the counts and offsets, stays
    the same.  Raises ``NeedsRebuild`` (the tier unchanged) when the live
    set no longer fits the shard's leaves.  ``ctx`` as in
    :func:`insert_into_shard`."""
    if not 0 <= shard < sidx.n_shards:
        raise ValueError(f"shard {shard} out of range [0, {sidx.n_shards})")
    mutation._mutator(sidx.index)

    def mutate(local):
        return mutation.compact(local), None, int(sidx.counts[shard])

    _mutate_shard(sidx, shard, ctx, mutate)
    return sidx
