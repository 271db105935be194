r"""The :class:`Index` of torch tensors and its query path (counterpart of
``repro.index.index``).

A learned index is data: a few flat arrays driven by one lookup
procedure per kind.  ``Index.arrays`` holds them as tensors on one
device, with the reference's names, dtypes and shapes; the key leaves
(``fences``, ``keys``) hold sign-flipped int64 (:mod:`repro_torch.core.keys`)
where the reference holds uint64.  ``save``/``load`` use the reference's
npz layout, so either package reads the other's files.

Backends (``lookup(..., backend=...)``; the port's default is
``"kernel"``, the reference's ``"xla"``):

* ``"kernel"`` — the hand-written CUDA kernels (the reference's
  ``"pallas"``): the fused RMI, PGM and RadixSpline kernels for
  RMI/SY-RMI, PGM/PGM_M and RS, the model-free search for L/Q/C/KO/BTREE.
  On CPU tensors the kernels' plain twins run instead;
* ``"xla"`` — the kind's predicted window (:meth:`Index.intervals`) then
  the branch-free bounded search, ``epi`` trips: the reference's default
  path, tensor ops on the index's device;
* ``"bbs"`` — the same window, then the branchy early-exit search (the
  paper's \*-BBS), which syncs with the host once a trip on the card;
* ``"ref"`` — ``torch.searchsorted`` oracle.

Each kind claims its backends (:meth:`Index.backends`): the static kinds
all four, the updatable GAPPED only ``"xla"``, ``"bbs"`` and ``"ref"``.
GAPPED has no kernel, as the reference has no Pallas path for it, so
``backend="kernel"`` on it raises ``ValueError``, the port's default
included: pass ``backend="xla"``.  GAPPED owns its keys and answers
from its leaves and delta on every backend, ignoring ``table``; its
``insert_batch``/``compact`` return a new index and leave the old one
as it was.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core import search
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import predecessor_ref

#: the backends that search the kind's predicted window (:func:`windows`)
INTERVAL_BACKENDS = ("xla", "bbs")

BACKENDS = (*INTERVAL_BACKENDS, "kernel", "ref")

#: leaves that hold table keys: uint64 in the reference, encoded int64 here
#: (RS's ``kmin`` is a key; the other kinds' ``kmin``, GAPPED's too, is a
#: float64 leaf)
KEY_LEAVES = frozenset({"fences", "keys", "knot_keys", "kmin", "route", "delta"})

#: uint64 leaves that are not keys (RS's radix ``shift``): small values,
#: held as int64 here and cast back to uint64 by :meth:`Index.to_numpy`
UNSIGNED_LEAVES = frozenset({"shift"})


class Index:
    """A learned static index as a dict of flat tensors.

    kind:   registry kind tag (``"RMI"``, ``"PGM"``, ...).
    static: tuple of ``(name, int)`` pairs (bucketed trip counts, level
            counts, degrees).
    arrays: dict name -> tensor, all on one device.
    info:   host-side build metadata (name, build_time, eps, ...).
    """

    __slots__ = ("kind", "static", "arrays", "info")

    def __init__(self, kind: str, static: tuple, arrays: dict, info: dict | None = None):
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "static", tuple((str(k), int(v)) for k, v in static))
        object.__setattr__(self, "arrays", dict(arrays))
        object.__setattr__(self, "info", dict(info or {}))

    def s(self, name: str) -> int:
        for k, v in self.static:
            if k == name:
                return v
        raise KeyError(name)

    @property
    def name(self) -> str:
        return self.info.get("name", self.kind)

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device

    def __getattr__(self, item):
        # convenience passthrough: idx.eps, idx.b, idx.n, ...
        info = object.__getattribute__(self, "info")
        if item in info:
            return info[item]
        raise AttributeError(item)

    def __repr__(self):
        shapes = {k: tuple(v.shape) for k, v in self.arrays.items()}
        return f"Index(kind={self.kind!r}, static={dict(self.static)}, arrays={shapes})"

    # -- host <-> device -----------------------------------------------------
    @classmethod
    def from_numpy(cls, kind: str, static, arrays: dict, info=None, *, device=None) -> "Index":
        """An Index on ``device`` from numpy leaves in the reference's layout
        (uint64 key leaves are encoded; every other leaf keeps its dtype)."""
        from . import registry

        kind = registry.entry(kind).kind
        dev = resolve_device(device)
        leaves = {}
        for name, v in arrays.items():
            v = np.asarray(v)
            if v.dtype == np.uint64 and name in UNSIGNED_LEAVES:
                if (v >= np.uint64(1 << 63)).any():
                    raise ValueError(f"leaf {name!r} holds a value above the int64 range")
                leaves[name] = torch.from_numpy(v.astype(np.int64)).to(dev)
            elif v.dtype == np.uint64:
                if name not in KEY_LEAVES:
                    raise ValueError(f"leaf {name!r} is uint64 but not a key leaf {sorted(KEY_LEAVES)}")
                leaves[name] = keymod.encode(v, dev)
            else:
                leaves[name] = torch.from_numpy(np.array(v, order="C")).to(dev)
        return cls(kind, static, leaves, info)

    def to_numpy(self) -> dict:
        """The leaves as numpy arrays in the reference's layout: encoded key
        leaves decode to uint64, unsigned leaves cast back to uint64, the
        rest keep their dtype."""
        out = {}
        for k, v in self.arrays.items():
            if k in KEY_LEAVES and v.dtype == torch.int64:
                out[k] = keymod.decode(v)
            else:
                out[k] = v.detach().cpu().numpy()
                if k in UNSIGNED_LEAVES:
                    out[k] = out[k].astype(np.uint64)
        return out

    # -- queries -------------------------------------------------------------
    def intervals(self, table, queries) -> tuple:
        """Predicted inclusive window ``[lo, hi]`` (int64) of each query.
        ``table`` and ``queries`` as in :meth:`lookup`."""
        dev = self.device
        return windows(self, keymod.as_keys(table, dev), keymod.as_keys(queries, dev))

    def backends(self) -> tuple:
        """The backends this kind supports (a subset of :data:`BACKENDS`:
        all of it for the static kinds, no ``"kernel"`` for GAPPED)."""
        from . import impls

        return impls.query_impl(self.kind).backends

    def lookup(self, table, queries, *, backend: str = "kernel") -> torch.Tensor:
        """Predecessor ranks (int64, on the index's device) of ``queries``
        over the sorted ``table``.  Both are encoded int64 tensors or uint64
        numpy arrays, which are encoded and moved to the index's device.
        A backend the kind does not claim raises ``ValueError``: GAPPED
        on ``"kernel"``, the default, so GAPPED callers name a backend."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
        check_backend(self.kind, backend)
        dev = self.device
        return lookup_impl(self, keymod.as_keys(table, dev), keymod.as_keys(queries, dev), backend)

    def predecessor(self, table, queries, *, branchy: bool = False, backend: str | None = None):
        r"""Predecessor ranks; ``branchy=True`` selects the \*-BBS epilogue.
        The backend defaults to ``"xla"`` (``"bbs"`` when branchy), as in
        the reference."""
        return self.lookup(table, queries, backend=backend or ("bbs" if branchy else "xla"))

    # -- mutation (updatable kinds only) ------------------------------------
    def insert_batch(self, keys, *, auto_compact: bool = True):
        """Insert a batch of keys (uint64 numpy or an encoded tensor) into
        an updatable kind (GAPPED); returns ``(new_index, InsertReport)``
        and leaves this index as it was.  Leaf gaps absorb first, the
        delta buffer takes the overflow, and ``auto_compact`` folds the
        delta into the leaves when it would overflow.  Static kinds raise
        ``TypeError``; see :mod:`repro_torch.index.mutation`."""
        from . import mutation

        return mutation.insert_batch(self, keys, auto_compact=auto_compact)

    def compact(self) -> "Index":
        """Fold the delta buffer into the gapped leaves (a new index)."""
        from . import mutation

        return mutation.compact(self)

    # -- accounting / serialization -----------------------------------------
    def space_bytes(self) -> int:
        """Model space in the paper's sense: the bytes of the leaves that
        constitute the model (kernel re-encodings and padding excluded)."""
        from . import impls

        return impls.query_impl(self.kind).space_bytes(self)

    def nbytes(self) -> int:
        """Total bytes of every leaf as stored (padding and kernel
        re-encodings included)."""
        return sum(int(v.nbytes) for v in self.arrays.values())

    def save(self, path) -> None:
        """npz in the reference's layout: ``arr_<leaf>`` plus JSON ``__meta__``."""
        payload = {f"arr_{k}": v for k, v in self.to_numpy().items()}
        meta = {
            "kind": self.kind,
            "static": list(map(list, self.static)),
            "info": {k: v for k, v in self.info.items() if isinstance(v, (str, int, float, bool))},
        }
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path, *, device=None) -> "Index":
        """Read an npz written by either package's ``save``."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k[len("arr_"):]: z[k] for k in z.files if k.startswith("arr_")}
        static = tuple((k, int(v)) for k, v in meta["static"])
        return cls.from_numpy(meta["kind"], static, arrays, meta.get("info"), device=device)


def check_backend(kind: str, backend: str) -> None:
    """Refuse a backend the kind does not claim, with the reference's
    message."""
    from . import impls

    claimed = impls.query_impl(kind).backends
    if backend not in claimed:
        raise ValueError(f"kind {kind!r} supports backends {claimed}, not {backend!r}")


def windows(index: Index, table, queries) -> tuple:
    """The kind's predicted windows on encoded tensors, one table or a
    stack.  The ``*_window`` functions take a stack only, so one table is
    the stack of one: its leaves and table gain a leading table axis and
    the queries become ``(1, B)``."""
    from . import impls

    intervals = impls.query_impl(index.kind).intervals
    if table.dim() == 2:
        return intervals(index, table, queries)
    one = Index(index.kind, index.static, {k: v[None] for k, v in index.arrays.items()})
    lo, hi = intervals(one, table[None], queries.reshape(1, -1))
    return lo.reshape(queries.shape), hi.reshape(queries.shape)


def lookup_impl(index: Index, table, queries, backend: str) -> torch.Tensor:
    """The lookup body on encoded tensors already on the index's device:
    one table (``(m,)`` table, any query shape) or a stack (a stacked
    index, ``(N, m)`` tables, ``(N, B)`` queries: raw local ranks, which
    the caller clamps to each table's valid count).  ``"kernel"`` on a
    stack is one launch of the kind's batched kernel; ``"xla"``/``"bbs"``
    search every table's window in one pass of tensor ops."""
    from . import impls

    impl = impls.query_impl(index.kind)
    if impl.lookup is not None:
        # self-contained kinds (GAPPED's two-tier merge) own their keys:
        # the answer ignores ``table`` on every backend
        return impl.lookup(index, table, queries, backend)
    stacked = table.dim() == 2
    if backend == "ref":
        return predecessor_ref(table, queries.contiguous() if stacked else queries)
    if backend == "kernel":
        return (impl.batched_kernel if stacked else impl.kernel)(index, table, queries)
    lo, hi = windows(index, table, queries)
    if backend == "bbs":
        return search.bounded_bbs_branchy(table, queries, lo, hi)
    return search.bounded_bfs(table, queries, lo, hi, max_window=1 << impl.epi_steps(index))


def build(kind_or_spec, table, *, device=None, **params) -> Index:
    """Build an :class:`Index` over a sorted uint64 ``table`` (numpy, or an
    encoded tensor) from a spec or a kind string plus parameters.  The fit
    runs on the host; the leaves go to ``device`` (default: the card)."""
    from . import registry
    from .specs import IndexSpec

    dev = resolve_device(device)
    if isinstance(kind_or_spec, IndexSpec):
        spec = kind_or_spec
    else:
        spec = registry.spec_for(str(kind_or_spec), **params)
    if torch.is_tensor(table):
        table_np = keymod.decode(table)
    else:
        table_np = np.asarray(table, dtype=np.uint64)
    static, arrays, info = registry.entry(spec.kind).build(spec, table_np)
    return Index.from_numpy(spec.kind, static, arrays, info, device=dev)
