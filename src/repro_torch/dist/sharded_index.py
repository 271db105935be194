"""Leaf-wise stacking of same-spec indexes (counterpart of the stacking
half of ``repro.dist.sharded_index``).

A tier holds many sorted tables, one per shard of a partitioned keyspace.
Same-spec per-table indexes stack leaf-wise into one :class:`Index` whose
leaves carry a leading table axis, so one batched kernel launch answers
every table.  Leaf shapes pad to the per-leaf maximum with inert
sentinels (max key for key leaves, the last entry repeated otherwise),
bucketed trip counts take the maximum across tables (extra trips of a
bounded search are no-ops), and PGM-shaped indexes of shallower tables
are lifted to the deepest one with trivial one-segment root levels.

Stacking works on the leaves in the reference's numpy layout (uint64
keys), so the stacked leaves equal the reference's.  The routed and
collective tier (``ShardedIndex``, ``route_owners``, ``sharded_lookup``)
is a later slice; GAPPED's leaf padding waits for the GAPPED kind.
"""

from __future__ import annotations

import numpy as np

from repro_torch.index import registry
from repro_torch.index.impls import _pad_pow2
from repro_torch.index.index import Index

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


def _harmonize(kind: str, per_table: list) -> list:
    """Make per-table ``(static, arrays)`` pairs stackable where the kind
    allows it: PGM-shaped kinds lift shallow tables to the deepest."""
    if registry.entry(kind).query_key == "pgm":
        target = max(dict(s)["levels"] for s, _ in per_table)
        return [_lift_pgm_levels(s, a, target) for s, a in per_table]
    return list(per_table)


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
