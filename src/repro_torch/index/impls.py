"""Per-kind builds and kernel dispatch behind the :class:`Index` API
(counterpart of ``repro.index.impls``, for the ten static kinds L, Q, C,
KO, RMI, SY-RMI, PGM, PGM_M, RS and BTREE; the updatable GAPPED
registers from :mod:`repro_torch.index.updatable`).

Each kind contributes a host build that runs the fit in
:mod:`repro_torch.core` and flattens the model into the reference's
leaves and statics (numpy; :meth:`Index.from_numpy` moves them to the
device), and a :class:`QueryImpl` with ``intervals`` (the window the
``xla`` and ``bbs`` backends search, computed by the core module's
``*_window`` on a stack's leaves), ``epi_steps``,
``space_bytes`` and the kernel dispatch, the counterpart of the
reference's ``pallas``, plus its batched arm, the counterpart of
``pallas_batched``: the RMI family, the PGM family and RS have fused
batched kernels, every other kind answers a stack of tables with the
batched model-free search.

The reference's two cache normalisations are kept so leaves and statics
match it exactly: variable-length PGM leaves are padded to the next
power of two with inert sentinels, and every trip count is rounded up to
a multiple of 4 (:func:`_bucket_steps`) — extra trips of a Khuong–Morin
loop are no-ops once the window is one key wide.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.atomic import atomic_window, build_atomic
from repro_torch.core.btree import btree_window, build_btree
from repro_torch.core.cdf import ceil_log2
from repro_torch.core.kbfs import build_ko, ko_window
from repro_torch.core.pgm import build_pgm, build_pgm_bicriteria, pgm_window
from repro_torch.core.radix_spline import build_rs, rs_window
from repro_torch.core.rmi import build_rmi, rmi_window
from repro_torch.core.sy_rmi import build_sy_rmi
from repro_torch.kernels.kary_search import (
    batched_kary_search,
    batched_kary_search_plain,
    kary_search,
    kary_search_plain,
)
from repro_torch.kernels.ops import pgm_kernel_arrays, rmi_kernel_arrays, rs_kernel_arrays
from repro_torch.kernels.pgm_search import (
    batched_pgm_search,
    batched_pgm_search_plain,
    pgm_search,
    pgm_search_plain,
)
from repro_torch.kernels.rmi_search import (
    batched_rmi_search,
    batched_rmi_search_plain,
    rmi_search,
    rmi_search_plain,
)
from repro_torch.kernels.rs_search import (
    batched_rs_search,
    batched_rs_search_plain,
    rs_search,
    rs_search_plain,
)

from .index import BACKENDS, Index
from .registry import register
from .specs import (
    AtomicSpec,
    BTreeSpec,
    KOSpec,
    PGMBicriteriaSpec,
    PGMSpec,
    RMISpec,
    RSSpec,
    SYRMISpec,
)

_MAXKEY = np.uint64(np.iinfo(np.uint64).max)


def _bucket_steps(window: int) -> int:
    """ceil_log2 rounded up to a multiple of 4."""
    s = ceil_log2(max(int(window), 2))
    return max(4, 4 * math.ceil(s / 4))


def _pow2ceil(x: int) -> int:
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def _pad_pow2(arr: np.ndarray, fill) -> np.ndarray:
    arr = np.asarray(arr)
    m = _pow2ceil(arr.shape[0])
    if m == arr.shape[0]:
        return arr
    return np.concatenate([arr, np.full(m - arr.shape[0], fill, dtype=arr.dtype)])


def _scalar(x, dtype) -> np.ndarray:
    return np.asarray(x, dtype=dtype).reshape(())


def _kary_operands(idx: Index, table, q):
    """Model-free search, one table or a stack: the kernel backend of kinds
    without a fused kernel, and the batched backend of kinds without a
    fused batched kernel (the reference's ``QueryImpl.__post_init__``)."""
    return (table, q), {}


@dataclass(frozen=True)
class QueryImpl:
    """How a kind answers queries.  ``intervals(index, tables, queries) ->
    (lo, hi)`` is the window that ``xla`` and ``bbs`` search, on a stack
    (``(N, m)`` tables, ``(N, B)`` queries; one table goes through
    :func:`repro_torch.index.index.windows` as the stack of one), and
    ``epi_steps`` the trips of the ``xla`` search.  ``backend="kernel"``:
    ``operands(index, table, queries) -> (args, kwargs)`` gives the kernel
    wrapper ``search`` its inputs; ``plain`` is the wrapper's twin on the
    same inputs (any device), for holding the kernel against it.  The
    ``batched_*`` fields do the same for a stacked index over
    ``(n_tables, m)`` tables and ``(n_tables, B)`` queries; they default
    to the batched model-free search.

    ``lookup(index, table, queries, backend) -> ranks`` overrides all of
    it for a self-contained kind (GAPPED, whose answer is not a window of
    ``table``): :func:`~repro_torch.index.index.lookup_impl` dispatches
    to it before any generic backend, on one table and on a stack.
    ``backends`` are the backends the kind claims; the entry points
    refuse the others."""

    intervals: Callable  # (index, table, q) -> (lo, hi)
    space_bytes: Callable  # (index) -> int
    operands: Callable = None
    search: Callable = None
    plain: Callable = None
    batched_operands: Callable = _kary_operands
    batched_search: Callable = batched_kary_search
    batched_plain: Callable = batched_kary_search_plain
    lookup: Callable = None
    backends: tuple = BACKENDS

    @staticmethod
    def epi_steps(idx: Index) -> int:
        return idx.s("epi")

    def kernel(self, idx: Index, table, queries):
        """int64 predecessor ranks through the kind's kernel."""
        args, kwargs = self.operands(idx, table, queries)
        return self.search(*args, **kwargs).long()

    def batched_kernel(self, idx: Index, tables, queries):
        """Raw int64 local ranks ``(n_tables, B)`` of a stacked index through
        the kind's batched kernel, one launch (callers clamp to the counts)."""
        args, kwargs = self.batched_operands(idx, tables, queries)
        return self.batched_search(*args, **kwargs).long()


def _kary_impl(intervals: Callable, space_bytes: Callable) -> QueryImpl:
    return QueryImpl(intervals, space_bytes, _kary_operands, kary_search, kary_search_plain)


# -- atomic (L / Q / C) ------------------------------------------------------


def _atomic_intervals(idx: Index, table, q):
    a = idx.arrays
    return atomic_window(q, a["coef"], a["kmin"], a["inv_span"], a["eps"], n=table.shape[-1])


def _atomic_space(idx: Index) -> int:
    # coef valid prefix (degree+1 of the padded 4) + kmin/inv_span + eps
    a = idx.arrays
    return 8 * (idx.s("degree") + 1) + a["kmin"].nbytes + a["inv_span"].nbytes + a["eps"].nbytes


ATOMIC_IMPL = _kary_impl(_atomic_intervals, _atomic_space)


def _build_atomic_index(spec: AtomicSpec, table_np: np.ndarray):
    m = build_atomic(table_np, degree=spec.degree)
    arrays = {
        "coef": np.asarray(m.coef, np.float64),
        "kmin": _scalar(m.kmin, np.float64),
        "inv_span": _scalar(m.inv_span, np.float64),
        "eps": _scalar(m.eps, np.int64),
    }
    static = (("degree", spec.degree), ("epi", _bucket_steps(min(2 * m.eps + 3, m.n))))
    info = {"name": m.name, "build_time": m.build_time, "eps": m.eps, "n": m.n}
    return static, arrays, info


# -- KO ----------------------------------------------------------------------


def _ko_intervals(idx: Index, table, q):
    a = idx.arrays
    return ko_window(q, *(a[k] for k in ("fences", "coef", "kmin_seg", "inv_span_seg", "eps",
                                          "seg_start")))


def _ko_space(idx: Index) -> int:
    a = idx.arrays
    return sum(
        a[k].nbytes for k in ("fences", "coef", "kmin_seg", "inv_span_seg", "eps", "seg_start")
    )


KO_IMPL = _kary_impl(_ko_intervals, _ko_space)


def _build_ko_index(spec: KOSpec, table_np: np.ndarray):
    m = build_ko(table_np, k=spec.k)
    arrays = {
        "fences": np.asarray(m.fences, np.uint64),
        "coef": m.coef,
        "kmin_seg": m.kmin_seg,
        "inv_span_seg": m.inv_span_seg,
        "eps": m.eps,
        "seg_start": m.seg_start,
    }
    static = (("epi", _bucket_steps(m.max_window)),)
    info = {"name": m.name, "build_time": m.build_time, "k": m.k, "max_eps": m.max_eps, "n": m.n}
    return static, arrays, info


# -- RMI / SY-RMI ------------------------------------------------------------


def _rmi_intervals(idx: Index, table, q):
    a = idx.arrays
    leaves = (a[k] for k in ("root_coef", "leaf_slope", "leaf_icept", "leaf_eps", "leaf_r", "kmin",
                             "inv_span"))
    return rmi_window(q, *leaves, n=table.shape[-1])


def _rmi_space(idx: Index) -> int:
    # the k_* leaves are the kernel's f32 re-encoding of the same model — a
    # query-time cache, not model space, so they don't count
    a = idx.arrays
    return sum(
        a[k].nbytes
        for k in ("root_coef", "leaf_slope", "leaf_icept", "leaf_eps", "leaf_r", "kmin", "inv_span")
    )


def _rmi_operands(idx: Index, table, q):
    """Fused RMI kernel on the raw queries, the f64 ``kmin``/``inv_span``
    (the kernel computes ``u``) and the ``k_*`` leaves."""
    a = idx.arrays
    args = (q, table, a["kmin"].reshape(1), a["inv_span"].reshape(1), a["k_root"], a["k_slope"],
            a["k_icept"], a["k_eps"], a["k_rlo"], a["k_rhi"])
    return args, {"steps": idx.s("ksteps")}


def _rmi_batched_operands(idx: Index, tables, queries):
    """Batched fused RMI kernel on the raw queries, each table's f64
    ``kmin``/``inv_span`` and the stacked ``k_*`` leaves; ``ksteps`` took
    the max over the tables at stack time."""
    a = idx.arrays
    args = (queries, tables, a["kmin"], a["inv_span"], a["k_root"], a["k_slope"], a["k_icept"],
            a["k_eps"], a["k_rlo"], a["k_rhi"])
    return args, {"steps": idx.s("ksteps")}


RMI_IMPL = QueryImpl(
    _rmi_intervals, _rmi_space, _rmi_operands, rmi_search, rmi_search_plain,
    _rmi_batched_operands, batched_rmi_search, batched_rmi_search_plain,
)


def _rmi_to_index(m, table_np: np.ndarray, extra_info=None):
    karr, ksteps = rmi_kernel_arrays(m, table_np)
    arrays = {
        "root_coef": np.asarray(m.root_coef, np.float64),
        "leaf_slope": m.leaf_slope,
        "leaf_icept": m.leaf_icept,
        "leaf_eps": m.leaf_eps,
        "leaf_r": m.leaf_r,
        "kmin": _scalar(m.kmin, np.float64),
        "inv_span": _scalar(m.inv_span, np.float64),
        "k_root": karr["root"],
        "k_slope": karr["slope"],
        "k_icept": karr["icept"],
        "k_eps": karr["eps"],
        "k_rlo": karr["rlo"],
        "k_rhi": karr["rhi"],
    }
    static = (("epi", _bucket_steps(m.max_window)), ("ksteps", _bucket_steps(1 << ksteps)))
    info = {
        "name": m.name,
        "build_time": m.build_time,
        "b": m.b,
        "max_eps": m.max_eps,
        "root_type": m.root_type,
        "n": m.n,
    }
    info.update(extra_info or {})
    return static, arrays, info


def _build_rmi_index(spec: RMISpec, table_np: np.ndarray):
    return _rmi_to_index(build_rmi(table_np, b=spec.b, root_type=spec.root_type), table_np)


def _build_sy_rmi_index(spec: SYRMISpec, table_np: np.ndarray):
    m = build_sy_rmi(table_np, space_pct=spec.space_pct, ub=spec.ub, winner_root=spec.winner_root)
    return _rmi_to_index(m, table_np, {"space_pct": spec.space_pct})


# -- PGM / PGM_M -------------------------------------------------------------


def _pgm_intervals(idx: Index, table, q):
    a = idx.arrays
    leaves = (a[k] for k in ("keys", "slope", "rank0", "off", "off_r", "sizes", "eps"))
    return pgm_window(q, *leaves, levels=idx.s("levels"), n=table.shape[-1], steps=idx.s("epi"))


def _pgm_space(idx: Index) -> int:
    # valid prefixes of the level-concatenated leaves (the pow2 sentinel pad
    # is cache bucketing, not model space) + level directories
    a = idx.arrays
    sizes = a["sizes"].cpu().numpy()
    kv, rv = int(sizes.sum()), int((sizes + 1).sum())
    per_seg = kv * (a["keys"].dtype.itemsize + a["slope"].dtype.itemsize)
    ranks = rv * a["rank0"].dtype.itemsize
    meta = a["off"].nbytes + a["off_r"].nbytes + a["sizes"].nbytes + a["eps"].nbytes
    return per_seg + ranks + meta


def _pgm_operands(idx: Index, table, q):
    """Fused PGM descent on the raw queries, the f64 ``pk_kmin``/
    ``pk_inv_span`` (the kernel computes ``u``), the ``pk_*`` leaves and
    the int64 level directories as the index holds them."""
    a = idx.arrays
    dirs = [a[k] for k in ("rank0", "off", "off_r", "sizes")]
    args = (q, table, a["pk_kmin"].reshape(1), a["pk_inv_span"].reshape(1), a["keys"], a["pk_u0"],
            a["pk_slope"], *dirs, a["pk_eps"].reshape(1))
    return args, {"levels": idx.s("levels"), "steps": idx.s("pksteps")}


def _pgm_batched_operands(idx: Index, tables, queries):
    """Batched PGM descent on the raw queries, each table's f64
    ``pk_kmin``/``pk_inv_span`` and the stacked leaves and directories; the
    level count is common (lifted at stack time) and ``pksteps`` the max."""
    a = idx.arrays
    dirs = [a[k] for k in ("rank0", "off", "off_r", "sizes")]
    args = (queries, tables, a["pk_kmin"], a["pk_inv_span"], a["keys"], a["pk_u0"], a["pk_slope"],
            *dirs, a["pk_eps"])
    return args, {"levels": idx.s("levels"), "steps": idx.s("pksteps")}


PGM_IMPL = QueryImpl(
    _pgm_intervals, _pgm_space, _pgm_operands, pgm_search, pgm_search_plain,
    _pgm_batched_operands, batched_pgm_search, batched_pgm_search_plain,
)


def _pgm_to_index(m, table_np: np.ndarray, extra_info=None):
    karr, pksteps = pgm_kernel_arrays(m, table_np)
    sizes = np.asarray(m.level_sizes, dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    off_r = np.concatenate([[0], np.cumsum(sizes + 1)]).astype(np.int64)
    keys = np.concatenate(m.level_keys)
    slope = np.concatenate(m.level_slope)
    rank0 = np.concatenate(m.level_rank0)
    arrays = {
        "keys": _pad_pow2(keys, _MAXKEY),
        "slope": _pad_pow2(slope, 0.0),
        "rank0": _pad_pow2(rank0, rank0[-1]),
        "off": off,
        "off_r": off_r,
        "sizes": sizes,
        "eps": _scalar(m.eps, np.int64),
        # kernel re-encoding (query-time cache, not model space)
        "pk_u0": _pad_pow2(karr["u0"], np.float32(1.0)),
        "pk_slope": _pad_pow2(karr["slope"], np.float32(0.0)),
        "pk_eps": _scalar(karr["eps"], np.int32),
        "pk_kmin": _scalar(karr["kmin"], np.float64),
        "pk_inv_span": _scalar(karr["inv_span"], np.float64),
    }
    static = (
        ("levels", len(m.level_keys)),
        ("epi", _bucket_steps(min(2 * (m.eps + 2) + 3, m.n))),
        ("pksteps", _bucket_steps(1 << pksteps)),
    )
    info = {
        "name": m.name,
        "build_time": m.build_time,
        "eps": m.eps,
        "n_segments_l0": m.n_segments_l0,
        "n": m.n,
    }
    info.update(extra_info or {})
    return static, arrays, info


def _build_pgm_index(spec: PGMSpec, table_np: np.ndarray):
    return _pgm_to_index(build_pgm(table_np, eps=spec.eps), table_np)


def _build_pgm_m_index(spec: PGMBicriteriaSpec, table_np: np.ndarray):
    m = build_pgm_bicriteria(table_np, space_budget_bytes=spec.budget_for(len(table_np)), a=spec.a)
    return _pgm_to_index(m, table_np, {"a": spec.a})


# -- RadixSpline -------------------------------------------------------------


def _rs_intervals(idx: Index, table, q):
    a = idx.arrays
    leaves = (a[k] for k in ("knot_keys", "knot_ranks", "radix_table", "kmin", "shift", "eps_eff",
                             "m_valid"))
    return rs_window(q, *leaves, r_bits=idx.s("r_bits"), n=table.shape[-1], steps=idx.s("ksteps"))


def _rs_space(idx: Index) -> int:
    a = idx.arrays
    m = int(a["m_valid"])
    knots = m * (a["knot_keys"].dtype.itemsize + a["knot_ranks"].dtype.itemsize)
    scalars = a["kmin"].nbytes + a["shift"].nbytes + a["eps_eff"].nbytes + a["m_valid"].nbytes
    return knots + a["radix_table"].nbytes + scalars


def _rs_operands(idx: Index, table, q):
    """Fused RadixSpline kernel on the raw queries, the key ``kmin`` and
    ``shift`` (the kernel computes the unsigned radix prefix), the f64
    ``rk_kmin``/``rk_inv_span`` (the kernel computes ``u``), the ``rk_*``
    leaves and the int64 knot ranks and radix table as the index holds
    them."""
    a = idx.arrays
    scalars = [a[k].reshape(1) for k in ("kmin", "shift", "rk_kmin", "rk_inv_span")]
    args = (q, table, *scalars, a["knot_keys"], a["rk_u0"], a["rk_slope"], a["knot_ranks"],
            a["radix_table"], a["m_valid"].reshape(1), a["rk_eps"].reshape(1))
    return args, {"r_bits": idx.s("r_bits"), "ksteps": idx.s("ksteps"), "steps": idx.s("rk_epi")}


def _rs_batched_operands(idx: Index, tables, queries):
    """Batched fused RadixSpline kernel on the raw queries and the stacked
    leaves, each table's ``kmin``, ``shift``, ``rk_kmin``, ``rk_inv_span``,
    ``m_valid`` and ``rk_eps``; ``r_bits`` is structural, so common, and
    ``ksteps``/``rk_epi`` took the max over the tables at stack time."""
    a = idx.arrays
    args = (queries, tables, *(a[k] for k in ("kmin", "shift", "rk_kmin", "rk_inv_span",
                                              "knot_keys", "rk_u0", "rk_slope", "knot_ranks",
                                              "radix_table", "m_valid", "rk_eps")))
    return args, {"r_bits": idx.s("r_bits"), "ksteps": idx.s("ksteps"), "steps": idx.s("rk_epi")}


RS_IMPL = QueryImpl(
    _rs_intervals, _rs_space, _rs_operands, rs_search, rs_search_plain,
    _rs_batched_operands, batched_rs_search, batched_rs_search_plain,
)


def _build_rs_index(spec: RSSpec, table_np: np.ndarray):
    return _rs_to_index(build_rs(table_np, eps=spec.eps, r_bits=spec.r_bits), table_np)


def _rs_to_index(m, table_np: np.ndarray):
    karr, rksteps = rs_kernel_arrays(m, table_np)
    arrays = {
        "knot_keys": _pad_pow2(m.knot_keys, _MAXKEY),
        "knot_ranks": _pad_pow2(m.knot_ranks, m.knot_ranks[-1]),
        "radix_table": m.radix_table,
        "kmin": _scalar(m.kmin, np.uint64),
        "shift": _scalar(m.shift, np.uint64),
        "eps_eff": _scalar(m.eps_eff, np.int64),
        "m_valid": _scalar(m.m, np.int64),
        # kernel re-encoding (query-time cache, not model space)
        "rk_u0": _pad_pow2(karr["u0"], np.float32(1.0)),
        "rk_slope": _pad_pow2(karr["slope"], np.float32(0.0)),
        "rk_eps": _scalar(karr["eps"], np.int32),
        "rk_kmin": _scalar(karr["kmin"], np.float64),
        "rk_inv_span": _scalar(karr["inv_span"], np.float64),
    }
    static = (
        ("r_bits", m.r_bits),
        ("ksteps", _bucket_steps(_pow2ceil(len(m.knot_keys)))),
        ("epi", _bucket_steps(min(2 * m.eps_eff + 3, m.n))),
        ("rk_epi", _bucket_steps(1 << rksteps)),
    )
    info = {
        "name": m.name,
        "build_time": m.build_time,
        "eps": m.eps,
        "eps_eff": m.eps_eff,
        "m": m.m,
        "n": m.n,
    }
    return static, arrays, info


# -- B+-tree -----------------------------------------------------------------


def _btree_intervals(idx: Index, table, q):
    a = idx.arrays
    return btree_window(q, a["keys"], a["off"], a["valid"], fanout=idx.s("fanout"),
                        levels=idx.s("levels"), n=table.shape[-1])


def _btree_space(idx: Index) -> int:
    a = idx.arrays
    return a["keys"].nbytes + a["off"].nbytes + a["valid"].nbytes


# the reference's BTREE answers ``pallas`` with the model-free search too
BTREE_IMPL = _kary_impl(_btree_intervals, _btree_space)


def _build_btree_index(spec: BTreeSpec, table_np: np.ndarray):
    m = build_btree(table_np, fanout=spec.fanout)
    keys = np.concatenate(m.levels) if m.levels else np.zeros((0,), dtype=np.uint64)
    off = np.concatenate([[0], np.cumsum([len(lvl) for lvl in m.levels])]).astype(np.int64)
    arrays = {"keys": keys, "off": off, "valid": np.asarray(m.valid, dtype=np.int64)}
    static = (
        ("fanout", m.fanout),
        ("levels", len(m.levels)),
        ("epi", _bucket_steps(min(m.fanout + 1, m.n))),
    )
    info = {"name": m.name, "build_time": m.build_time, "n": m.n}
    return static, arrays, info


# ---------------------------------------------------------------------------
# Registry wiring — registration order IS the paper's hierarchy order.
# ---------------------------------------------------------------------------

QUERY_IMPLS = {
    "atomic": ATOMIC_IMPL,
    "ko": KO_IMPL,
    "rmi": RMI_IMPL,
    "pgm": PGM_IMPL,
    "rs": RS_IMPL,
    "btree": BTREE_IMPL,
}

_KIND_TO_IMPL = {}


def query_impl(kind: str) -> QueryImpl:
    return QUERY_IMPLS[_KIND_TO_IMPL[kind.upper()]]


def _reg(kind, spec_cls, query_key, build_fn, spec_from_params):
    _KIND_TO_IMPL[kind] = query_key
    register(kind, spec_cls, query_key=query_key, spec_from_params=spec_from_params)(build_fn)


_reg("L", AtomicSpec, "atomic", _build_atomic_index, lambda **p: AtomicSpec(degree=1))
_reg("Q", AtomicSpec, "atomic", _build_atomic_index, lambda **p: AtomicSpec(degree=2))
_reg("C", AtomicSpec, "atomic", _build_atomic_index, lambda **p: AtomicSpec(degree=3))
_reg("KO", KOSpec, "ko", _build_ko_index, lambda **p: KOSpec(k=p.get("k", 15)))
_reg(
    "RMI",
    RMISpec,
    "rmi",
    _build_rmi_index,
    lambda **p: RMISpec(b=p.get("b", 1024), root_type=p.get("root_type", "linear")),
)
_reg(
    "SY-RMI",
    SYRMISpec,
    "rmi",
    _build_sy_rmi_index,
    lambda **p: SYRMISpec(
        space_pct=p.get("space_pct", 2.0),
        ub=p.get("ub", 0.05),
        winner_root=p.get("winner_root", "linear"),
    ),
)
_reg("PGM", PGMSpec, "pgm", _build_pgm_index, lambda **p: PGMSpec(eps=p.get("eps", 64)))
_reg(
    "PGM_M",
    PGMBicriteriaSpec,
    "pgm",
    _build_pgm_m_index,
    lambda **p: PGMBicriteriaSpec(
        space_budget_bytes=p.get("space_budget_bytes", 0),
        space_pct=p.get("space_pct", 2.0),
        a=p.get("a", 1.0),
    ),
)
_reg(
    "RS",
    RSSpec,
    "rs",
    _build_rs_index,
    lambda **p: RSSpec(eps=p.get("eps", 32), r_bits=p.get("r_bits", 12)),
)
_reg(
    "BTREE",
    BTreeSpec,
    "btree",
    _build_btree_index,
    lambda **p: BTreeSpec(fanout=p.get("fanout", 16)),
)
