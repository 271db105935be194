"""A sharded tier of per-shard learned indexes, in one process
(counterpart of ``repro.dist.sharded_index``).

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
increasing continuation of its last key, and :func:`sharded_lookup`
answers a query batch against the whole tier: the fence array routes
each query to its owner shard (:func:`route_owners`), every shard answers
every query against its own table (``backend="kernel"``: ONE launch of
the kind's batched kernel for the whole tier), each local rank is clamped
to its shard's valid count and rebased to a global rank, and the owner's
answer is kept.  Ranks equal ``Index.lookup`` on the whole table.  This
is the reference's single-device ``mode="ref"``; its collective modes
(``"a2a"``, ``"allgather"``, a sharding context) and its routing
telemetry come with ``torch.distributed`` and the observability port,
later slices, as do ``refresh_shard`` and the rest of the tier's
maintenance.  GAPPED's leaf padding waits for the GAPPED kind.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.search import NO_PRED
from repro_torch.index import registry
from repro_torch.index.impls import _pad_pow2
from repro_torch.index.index import BACKENDS, Index, lookup_impl, resolve_device
from repro_torch.index.specs import IndexSpec

#: rank of a query dropped by the reference's capacity-factored exchange
#: (``mode="a2a"``); distinct from :data:`NO_PRED`, the below-the-first-key
#: rank.  The one-process tier never drops a query.
DROPPED = -2

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


# ---------------------------------------------------------------------------
# The tier
# ---------------------------------------------------------------------------


class ShardedIndex:
    """A tier of per-shard learned indexes over a partitioned keyspace.

    index:   stacked :class:`Index`: every leaf has a leading shard axis.
    tables:  ``(n_shards, m)`` encoded int64 per-shard sorted tables, padded
             to a common power-of-two ``m`` (strictly increasing pad).
    fences:  ``(n_shards,)`` encoded first key of each shard; the router
             searches ``fences[1:]``.
    counts:  ``(n_shards,)`` int64 valid (unpadded) keys per shard.
    offsets: ``(n_shards,)`` int64 global rank of each shard's first key.
    """

    __slots__ = ("index", "tables", "fences", "counts", "offsets", "info")

    def __init__(self, index: Index, tables, fences, counts, offsets, info=None):
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "tables", tables)
        object.__setattr__(self, "fences", fences)
        object.__setattr__(self, "counts", counts)
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "info", dict(info or {}))

    @property
    def n_shards(self) -> int:
        return int(self.tables.shape[0])

    @property
    def kind(self) -> str:
        return self.index.kind

    @property
    def device(self) -> torch.device:
        return self.tables.device

    def __repr__(self):
        return (f"ShardedIndex(kind={self.kind!r}, n_shards={self.n_shards}, "
                f"m={int(self.tables.shape[1])})")

    def shard(self, s: int) -> Index:
        """The per-shard :class:`Index` view of shard ``s`` (sliced leaves)."""
        return Index(self.index.kind, self.index.static,
                     {k: v[s] for k, v in self.index.arrays.items()},
                     info={"shard": s, **self.info})

    def space_bytes(self) -> int:
        """Model bytes across the tier plus the router's fence, count and
        offset arrays."""
        router = 8 * (self.fences.numel() + self.counts.numel() + self.offsets.numel())
        return self.n_shards * self.shard(0).space_bytes() + router

    @staticmethod
    def build(kind_or_spec, table_np, n_shards: int, *, bounds=None, device=None,
              **params) -> "ShardedIndex":
        """Partition a global sorted uint64 table into ``n_shards``
        contiguous shards, build one same-spec index per shard (on the
        padded shard tables, as the reference does), and stack them on
        ``device`` (default: the card).

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
        per_shard = [registry.entry(spec.kind).build(spec, p) for p in padded]
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
        )

    def save(self, path) -> None:
        """npz in the reference's layout (``idx_<leaf>``, ``tables``,
        ``fences``, ``counts``, ``offsets`` and a JSON ``__meta__``; keys
        as uint64), so either package reads the other's files."""
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
    def load(cls, path, *, device=None) -> "ShardedIndex":
        """Read an npz written by either package's ``save`` onto ``device``
        (default: the card)."""
        dev = resolve_device(device)
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k[len("idx_"):]: z[k] for k in z.files if k.startswith("idx_")}
            tables, fences = z["tables"], z["fences"]
            counts, offsets = z["counts"], z["offsets"]
        static = tuple((k, int(v)) for k, v in meta["static"])
        index = Index.from_numpy(meta["kind"], static, arrays, meta.get("info"), device=dev)
        return cls(index, keymod.encode(tables, dev), keymod.encode(fences, dev),
                   torch.from_numpy(counts).to(dev), torch.from_numpy(offsets).to(dev),
                   info=meta.get("info"))


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


def _lookup_vmapped(sidx: ShardedIndex, queries, backend: str):
    """Every shard answers every query (``backend="kernel"``: one batched
    launch), then each query keeps its owner's answer: the reference's
    single-device sweep, a leading shard axis for its ``vmap``."""
    owners = route_owners(sidx.fences, queries)
    bq = queries[None, :].expand(sidx.n_shards, queries.shape[0])
    granks = _answer_local(sidx.index, sidx.tables, sidx.counts[:, None], sidx.offsets[:, None],
                           bq, backend)
    return torch.take_along_dim(granks, owners[None, :].long(), dim=0)[0]


#: the reference's lookup modes; the one-process port answers ``"ref"``
#: (and ``"auto"``, which resolves to it without a sharding context)
MODES = ("auto", "a2a", "allgather", "ref")

#: backends of the tier's local answer: all of ``Index.lookup``'s
TIER_BACKENDS = BACKENDS

_LATER = "comes with the torch.distributed slice of the port"


def sharded_lookup(sidx: ShardedIndex, queries, ctx=None, *, backend: str = "kernel",
                   mode: str = "auto", telemetry: bool = False):
    """Predecessor ranks (int64, global) of a flat ``(B,)`` query batch
    (uint64 numpy or encoded int64) against the whole tier: equal to
    ``Index.lookup`` on the concatenated table.

    ``mode="ref"`` (and ``"auto"`` with no ``ctx``) runs the one-process
    sweep; ``backend`` is any of :data:`TIER_BACKENDS` (``"kernel"``: one
    launch of the kind's batched kernel for every shard).  A sharding
    context, ``mode="a2a"``/``"allgather"`` and ``telemetry`` raise
    ``ValueError``: they come with later slices of the port (and with them
    the reference's ``cap_factor`` and telemetry sinks).  Example::

        sidx = ShardedIndex.build("PGM", table, n_shards=4, eps=64)
        ranks = sharded_lookup(sidx, queries, backend="kernel")
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if backend not in TIER_BACKENDS:
        raise ValueError(f"unknown tier backend {backend!r}; choose from {TIER_BACKENDS}")
    if ctx is not None:
        raise ValueError(f"a sharding context {_LATER}; call without ctx (mode='ref')")
    if mode in ("a2a", "allgather"):
        raise ValueError(f"mode={mode!r} {_LATER}; use mode='ref' or 'auto'")
    if telemetry:
        raise ValueError("tier telemetry comes with the observability slice of the port")
    queries = keymod.as_keys(queries, sidx.device)
    if queries.dim() != 1:
        raise ValueError("sharded_lookup expects a flat (B,) query vector")
    return _lookup_vmapped(sidx, queries, backend)
