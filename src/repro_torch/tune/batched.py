"""Batched index construction and lookup: one spec over many tables
(counterpart of ``repro.tune.batched``, ``fit="host"``).

:func:`build_many` builds one index per table with the registered host
build and stacks them leaf-wise (:mod:`repro_torch.dist.sharded_index`)
into a :class:`BatchedIndexes`.  Over same-length tables the result
unstacks bit-exactly to per-table ``build``; ragged batches first pad
every table to a common power-of-two length with a strictly increasing
continuation, and lookups clamp hits in the padded tail back to the last
real key.

:meth:`BatchedIndexes.lookup` answers a query batch against every table
with ONE launch of the kind's batched kernel (``backend="kernel"``, the
reference's ``"pallas"``): the fused batched RMI, PGM or RadixSpline
kernel where the kind has one, the batched model-free search otherwise.
``"xla"`` and ``"bbs"`` compute every table's windows and search them in
one pass of tensor ops over the stack (the reference vmaps the
single-table path); ``"ref"`` is ``torch.searchsorted`` per row.  The
updatable GAPPED kind stacks too (tables of fewer leaves padded with
inert zero-count leaves) and answers on ``"xla"``, ``"bbs"`` and
``"ref"`` only; ``"kernel"`` raises for it.

The vmapped and fast fits (``fit="vmap"``/``"fast"``/``"auto"``) are the
device-fit slice's work; ``build_grid`` waits for the tuner.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.dist.sharded_index import (
    _harmonize,
    _pad_sorted_table,
    _pgm_level_arrays,
    _pow2ceil,
    stack_arrays,
)
from repro_torch.index import registry
from repro_torch.index.index import BACKENDS, Index, check_backend, lookup_impl, resolve_device
from repro_torch.index.specs import IndexSpec

#: fit strategies of the reference; only ``host`` is ported
FITS = ("host", "vmap", "fast", "auto")

#: backends of the batched lookup: all of ``Index.lookup``'s
BATCH_BACKENDS = BACKENDS


def _resolve_spec(kind_or_spec, **params) -> IndexSpec:
    if isinstance(kind_or_spec, IndexSpec):
        return kind_or_spec
    return registry.spec_for(str(kind_or_spec), **params)


def _is_pgm(kind: str) -> bool:
    return registry.entry(kind).query_key == "pgm"


class BatchedIndexes:
    """N same-spec indexes over N tables, stacked leaf-wise.

    index:   stacked :class:`Index`: every leaf has a leading table axis.
    tables:  ``(N, m)`` encoded int64 keys, each table padded to a common
             power-of-two ``m`` (strictly increasing continuation).
    counts:  ``(N,)`` int64: valid (unpadded) keys per table.
    meta:    per-table host metadata (original statics, harmonized leaf
             shapes, build info) behind a bit-exact :meth:`unstack`.
    """

    __slots__ = ("index", "tables", "counts", "meta", "info")

    def __init__(self, index: Index, tables, counts, meta, info=None):
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "tables", tables)
        object.__setattr__(self, "counts", counts)
        object.__setattr__(self, "meta", list(meta))
        object.__setattr__(self, "info", dict(info or {}))

    @property
    def n_tables(self) -> int:
        return len(self.meta)

    @property
    def kind(self) -> str:
        return self.index.kind

    @property
    def device(self) -> torch.device:
        return self.index.device

    def __repr__(self):
        return (
            f"BatchedIndexes(kind={self.kind!r}, n_tables={self.n_tables}, "
            f"m={int(self.tables.shape[1])})"
        )

    def unstack(self) -> list:
        """The per-table indexes, bit-exact with per-table builds (the PGM
        level lift inverted)."""
        lifted = self.index.s("levels") if _is_pgm(self.kind) else 0
        stacked = self.index.to_numpy()
        out = []
        for i, m in enumerate(self.meta):
            arrays = {
                k: v[i][tuple(slice(0, int(s)) for s in m["shapes"][k])]
                for k, v in stacked.items()
            }
            if lifted:
                arrays = _lower_pgm_arrays(arrays, lifted, dict(m["static"])["levels"])
            out.append(Index.from_numpy(self.kind, m["static"], arrays, m.get("info"),
                                        device=self.device))
        return out

    def queries_for(self, queries) -> torch.Tensor:
        """``queries`` as encoded ``(N, B)`` int64 on the batch's device: a
        ``(B,)`` batch (uint64 numpy or an encoded tensor) is broadcast to
        every table with ``expand``, without a copy."""
        q = keymod.as_keys(queries, self.device)
        if q.dim() == 1:
            q = q[None, :].expand(self.n_tables, q.shape[0])
        elif q.dim() != 2 or q.shape[0] != self.n_tables:
            raise ValueError(f"expected (B,) or ({self.n_tables}, B) queries, got {tuple(q.shape)}")
        return q

    def lookup(self, queries, *, backend: str = "kernel") -> torch.Tensor:
        """Predecessor ranks per table, ``(N, B)`` int64 on the batch's
        device, for ``(N, B)`` queries or one ``(B,)`` batch broadcast to
        every table.  ``backend="kernel"`` is one launch of the kind's
        batched kernel; a backend the kind does not claim (GAPPED's
        ``"kernel"``) raises ``ValueError``."""
        if backend not in BATCH_BACKENDS:
            raise ValueError(f"unknown batched backend {backend!r}; choose from {BATCH_BACKENDS}")
        check_backend(self.kind, backend)
        r = lookup_impl(self.index, self.tables, self.queries_for(queries), backend)
        # hits in the padded tail clamp back to the last real key
        return torch.minimum(r, self.counts[:, None] - 1)

    def space_bytes(self) -> int:
        """Summed per-table model bytes."""
        return sum(i.space_bytes() for i in self.unstack())


def _lower_pgm_arrays(arrays: dict, lifted: int, target: int) -> dict:
    """Invert the PGM level lift of :mod:`repro_torch.dist.sharded_index`:
    strip the ``lifted - target`` synthetic one-segment root levels and
    re-pad, which gives the original build's leaves bit for bit."""
    extra = lifted - target
    if extra == 0:
        return arrays
    if extra < 0:
        raise ValueError(f"cannot lower {lifted} levels to {target}: not lifted")
    sizes = np.asarray(arrays["sizes"])
    if not (sizes[:extra] == 1).all():
        raise ValueError("leading levels are not synthetic one-segment roots")
    kv = int(sizes.sum())
    rv = int((sizes + 1).sum())
    out = dict(arrays)
    out.update(_pgm_level_arrays(
        arrays["keys"][:kv][extra:],
        arrays["slope"][:kv][extra:],
        arrays["rank0"][:rv][2 * extra:],
        arrays["pk_u0"][:kv][extra:],
        arrays["pk_slope"][:kv][extra:],
        sizes[extra:].astype(np.int64),
    ))
    return out


def build_many(kind_or_spec, tables, *, fit: str = "host", device=None, **params) -> BatchedIndexes:
    """Build one index per table and stack them into a
    :class:`BatchedIndexes` on ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU).

    ``tables`` are sorted uint64 numpy arrays.  Same-length tables build
    as they are, so :meth:`~BatchedIndexes.unstack` is bit-exact with
    per-table ``build``; ragged batches are padded to a common
    power-of-two length first (the tier idiom), and lookups clamp back to
    each table's real keys.  Example::

        bm = build_many(RMISpec(b=1024), [t0, t1, t2])
        ranks = bm.lookup(queries)              # (3, B), one launch
        per_table = bm.unstack()                # bit-exact Indexes
    """
    if fit not in FITS:
        raise ValueError(f"unknown fit {fit!r}; choose from {FITS}")
    if fit != "host":
        raise ValueError(f"fit={fit!r} comes with the device fits, a later slice of the port; "
                         "use fit='host'")
    dev = resolve_device(device)
    spec = _resolve_spec(kind_or_spec, **params)
    tables = [np.asarray(t, dtype=np.uint64) for t in tables]
    if not tables:
        raise ValueError("need at least one table")
    counts = np.asarray([len(t) for t in tables], dtype=np.int64)
    if len(set(counts.tolist())) == 1:
        fit_tables = tables  # equal lengths: no padding, bit-exact with build()
    else:
        m = _pow2ceil(int(counts.max()))
        fit_tables = [_pad_sorted_table(t, m) for t in tables]
    entry = registry.entry(spec.kind)
    per = [entry.build(spec, t) for t in fit_tables]
    return _stack_with_meta(spec, per, fit_tables, counts, dev)


def _stack_with_meta(spec: IndexSpec, per: list, fit_tables: list, counts, dev) -> BatchedIndexes:
    """Harmonize and stack host builds ``(static, arrays, info)`` and move
    the stacked leaves, tables and counts to ``dev``."""
    per = [(tuple((str(k), int(v)) for k, v in s), {k: np.asarray(v) for k, v in a.items()}, i)
           for s, a, i in per]
    harmonized = _harmonize(spec.kind, [(s, a) for s, a, _ in per])
    static, arrays = stack_arrays(harmonized)
    name = per[0][2].get("name", spec.kind)
    index = Index.from_numpy(spec.kind, static, arrays,
                             {"n_shards": len(per), "name": f"sharded-{name}"}, device=dev)
    meta = [
        {"static": s, "shapes": {k: tuple(v.shape) for k, v in ha.items()}, "info": dict(i)}
        for (s, _, i), (_, ha) in zip(per, harmonized)
    ]
    info = {"spec": spec.display_name(), "n_tables": len(fit_tables), "m": len(fit_tables[0])}
    return BatchedIndexes(
        index=index,
        tables=keymod.encode(np.stack(fit_tables), dev),
        counts=torch.from_numpy(counts).to(dev),
        meta=meta,
        info=info,
    )


__all__ = ["BATCH_BACKENDS", "FITS", "BatchedIndexes", "build_many"]
