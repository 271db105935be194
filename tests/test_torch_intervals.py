"""The port's interval backends held against the JAX reference: each
kind's ``intervals`` and the ``xla`` (window + branch-free bounded search)
and ``bbs`` (window + branchy search) backends, on indexes that the
reference built and saved (the npz is the bridge), the core models'
query side, the reduction factor, and ``BatchedIndexes.lookup`` on
``xla``/``bbs``.  Ranks and windows are integers: equal, no tolerance.

The backend names map ``kernel`` <-> ``pallas``; ``xla``, ``bbs`` and
``ref`` are the same in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as rix
from repro import tune as rtune
from repro.core import cdf as rcdf
from repro.core.cdf import true_ranks
from repro_torch import index as tix
from repro_torch import tune as ttune
from repro_torch.core import cdf as tcdf
from repro_torch.core import keys

from conftest import TABLE_KINDS, make_queries, make_table
from test_torch_gpu import RS_SHIFT0, clamp_table

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE")
#: port backend -> reference backend
BACKEND_NAMES = {"xla": "xla", "bbs": "bbs", "kernel": "pallas", "ref": "ref"}


def structure_keys(ref) -> np.ndarray:
    """The keys where a kind's model changes piece: KO's fences, RMI's leaf
    boundaries (as keys of the table, added by the caller), every PGM
    level's segment keys, RS's knots, the BTREE levels' fence keys."""
    a = {k: np.asarray(v) for k, v in ref.arrays.items()}
    for leaf in ("fences", "keys", "knot_keys"):
        if leaf in a:
            return a[leaf].reshape(-1)
    return np.zeros((0,), np.uint64)


def probe_queries(rng, table, ref) -> np.ndarray:
    """``make_queries`` (keys, uniform misses, 0, min, max, 2^64 - 1) plus
    every structure key and table key at an RMI leaf boundary, each ± 1,
    and the keys just outside the table."""
    pts = structure_keys(ref)
    if "leaf_r" in ref.arrays:
        pts = table[np.clip(np.asarray(ref.arrays["leaf_r"]), 0, len(table) - 1)]
    with np.errstate(over="ignore"):
        pts = np.concatenate([pts, pts - np.uint64(1), pts + np.uint64(1),
                              [table.min() - np.uint64(1), table.max() + np.uint64(1)]])
    return np.concatenate([make_queries(rng, table, 200), pts.astype(np.uint64)])


def ref_and_port(kind, table, tmp_path, **params):
    ref = rix.build(kind, table, **params)
    path = tmp_path / f"{kind}.npz"
    ref.save(path)
    return ref, tix.Index.load(path, device="cpu")


def assert_same_answers(ref, port, table, qs, what: str):
    """Equal windows, and equal ranks on every backend, all exact."""
    rlo, rhi = ref.intervals(jnp.asarray(table), jnp.asarray(qs))
    lo, hi = port.intervals(table, qs)
    assert lo.dtype == hi.dtype == torch.int64
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo), err_msg=f"{what} lo")
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi), err_msg=f"{what} hi")
    want = true_ranks(table, qs)
    # the bounded search finds the upper bound ``rank + 1`` in [lo, hi + 1]:
    # a window may start one past the rank (RMI in a gap between clusters)
    inside = (lo.numpy() - 1 <= want) & (want <= hi.numpy())
    assert inside.all(), f"{what}: a window misses its rank"
    for backend, ref_backend in BACKEND_NAMES.items():
        got = port.lookup(table, qs, backend=backend)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.lookup(table, qs,
                                                                          backend=ref_backend)),
                                      err_msg=f"{what} {backend}")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what} {backend}")


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("kind", KINDS)
def test_index_windows_and_ranks_match_reference(kind, table_kind, tmp_path):
    rng = np.random.default_rng([KINDS.index(kind), TABLE_KINDS.index(table_kind)])
    table = make_table(rng, table_kind, 3000)
    ref, port = ref_and_port(kind, table, tmp_path)
    assert port.backends() == tix.BACKENDS
    assert_same_answers(ref, port, table, probe_queries(rng, table, ref), f"{kind}/{table_kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_pinned_clamp_and_tiny_tables(kind, tmp_path):
    """The pinned clustered table of the clamp regression, and tables of
    1, 2 and 3 keys (where RS's knot index clips to -1 and the
    reference's gather wraps)."""
    table, qs = clamp_table()
    ref, port = ref_and_port(kind, table, tmp_path)
    assert_same_answers(ref, port, table, qs, f"{kind}/pinned clamp")
    for n in (1, 2, 3):
        table = np.arange(1, n + 1, dtype=np.uint64) * np.uint64(1 << 40)
        with np.errstate(over="ignore"):
            qs = np.concatenate([table, table - np.uint64(1), table + np.uint64(1),
                                 np.array([0, 2**64 - 1], dtype=np.uint64)])
        ref, port = ref_and_port(kind, table, tmp_path)
        assert_same_answers(ref, port, table, qs, f"{kind}/n={n}")


def test_rs_shift0_prefix_differs_from_reference_only_where_it_is_wrong(tmp_path):
    """RS with shift 0 (a key span below 2^r_bits): the reference's
    ``_rs_intervals`` casts the unsigned radix prefix to int64 before
    clamping, so a query 2^63 or more above ``kmin`` reads bucket 0 and
    its window misses the rank (ROADMAP.md, queue 3).  The port takes the
    unsigned prefix clamped to the top bucket, as both packages' kernel
    paths do: its windows equal the reference's everywhere else, and its
    ranks are exact everywhere."""
    table = np.unique(np.concatenate([np.arange(100, 160), np.arange(300, 400, 7),
                                      [400, 401]])).astype(np.uint64)
    qs = np.concatenate([RS_SHIFT0[1], table, np.array([2**63 + 99, 2**63 + 200], np.uint64)])
    ref, port = ref_and_port("RS", table, tmp_path, eps=2, r_bits=12)
    assert int(port.arrays["shift"]) == 0
    far = qs - np.uint64(table[0]) >= np.uint64(2**63)
    far &= qs >= table[0]
    assert far.sum() >= 2
    rlo, rhi = (np.asarray(x) for x in ref.intervals(jnp.asarray(table), jnp.asarray(qs)))
    lo, hi = (x.numpy() for x in port.intervals(table, qs))
    np.testing.assert_array_equal(lo[~far], rlo[~far])
    np.testing.assert_array_equal(hi[~far], rhi[~far])
    want = true_ranks(table, qs)
    ref_xla = np.asarray(ref.lookup(table, qs, backend="xla"))
    assert (ref_xla[far] != want[far]).any()  # the reference's fault shows here
    np.testing.assert_array_equal(ref_xla[~far], want[~far])
    for backend in ("xla", "bbs", "kernel"):
        np.testing.assert_array_equal(port.lookup(table, qs, backend=backend).numpy(), want,
                                      err_msg=backend)
    np.testing.assert_array_equal(np.asarray(ref.lookup(table, qs, backend="pallas")), want)


def test_predecessor_defaults_and_backends(tmp_path):
    rng = np.random.default_rng(21)
    table = make_table(rng, "lognormal", 2000)
    qs = make_queries(rng, table, 300)
    ref, port = ref_and_port("KO", table, tmp_path)
    want = true_ranks(table, qs)
    for kwargs in ({}, {"branchy": True}, {"backend": "kernel"}, {"branchy": True,
                                                                  "backend": "ref"}):
        ref_kwargs = dict(kwargs)
        if ref_kwargs.get("backend") == "kernel":
            ref_kwargs["backend"] = "pallas"
        got = port.predecessor(table, qs, **kwargs).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.predecessor(table, qs, **ref_kwargs)))
        np.testing.assert_array_equal(got, want)
    assert tix.BACKENDS == ("xla", "bbs", "kernel", "ref")
    with pytest.raises(ValueError, match="unknown backend"):
        port.lookup(table, qs, backend="pallas")


# -- the core models' query side ---------------------------------------------------


def _core_models():
    from repro.core import atomic as ra, btree as rb, kbfs as rk, pgm as rp
    from repro.core import radix_spline as rr, rmi as rm
    from repro_torch.core import atomic as ta, btree as tb, kbfs as tk, pgm as tp
    from repro_torch.core import radix_spline as tr, rmi as tm

    return {
        "L": (lambda t: ra.build_atomic(t, 1), lambda t: ta.build_atomic(t, 1)),
        "C": (lambda t: ra.build_atomic(t, 3), lambda t: ta.build_atomic(t, 3)),
        "KO": (lambda t: rk.build_ko(t, 15), lambda t: tk.build_ko(t, 15)),
        "RMI-linear": (lambda t: rm.build_rmi(t, 256), lambda t: tm.build_rmi(t, 256)),
        "RMI-cubic": (lambda t: rm.build_rmi(t, 256, "cubic"),
                      lambda t: tm.build_rmi(t, 256, "cubic")),
        "PGM": (lambda t: rp.build_pgm(t, 16), lambda t: tp.build_pgm(t, 16)),
        "RS": (lambda t: rr.build_rs(t, 16, 8), lambda t: tr.build_rs(t, 16, 8)),
        "BTREE": (lambda t: rb.build_btree(t, 8), lambda t: tb.build_btree(t, 8)),
    }


CORE_MODELS = ("L", "C", "KO", "RMI-linear", "RMI-cubic", "PGM", "RS", "BTREE")


@pytest.mark.parametrize("model", CORE_MODELS)
def test_core_model_query_side_matches_reference(model):
    """``intervals``, ``predecessor`` (KO also branchy), ``max_window``
    and ``space_bytes`` of each core model, and its reduction factor."""
    rng = np.random.default_rng(CORE_MODELS.index(model))
    table = make_table(rng, "bursty", 2500)
    qs = make_queries(rng, table, 400)
    build_ref, build_port = _core_models()[model]
    ref, port = build_ref(table), build_port(table)
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    rlo, rhi = ref.intervals(jnp.asarray(table), jnp.asarray(qs))
    lo, hi = port.intervals(t, q)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    assert port.max_window == ref.max_window
    assert port.space_bytes() == ref.space_bytes()
    want = true_ranks(table, qs)
    for kwargs in ({}, {"branchy": True}) if model == "KO" else ({},):
        got = port.predecessor(t, q, **kwargs).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.predecessor(jnp.asarray(table),
                                                                      jnp.asarray(qs), **kwargs)))
        np.testing.assert_array_equal(got, want)
    assert tcdf.model_reduction_factor(port, table, qs) == rcdf.model_reduction_factor(ref, table,
                                                                                       qs)


def test_reduction_factor_and_unit_maps_match_reference(tmp_path):
    rng = np.random.default_rng(23)
    table = make_table(rng, "clustered", 4000)
    qs = make_queries(rng, table, 500)
    for kind in ("SY-RMI", "PGM_M", "RS"):
        ref, port = ref_and_port(kind, table, tmp_path)
        assert tcdf.model_reduction_factor(port, table, qs) == rcdf.model_reduction_factor(
            ref, table, qs), kind
    lo = rng.integers(-5, 4000, 300)
    hi = lo + rng.integers(-3, 600, 300)
    assert tcdf.reduction_factor(torch.from_numpy(lo), torch.from_numpy(hi), 4000) == \
        rcdf.reduction_factor(lo, hi, 4000)
    preds = rng.normal(0, 50, 300) + np.arange(300)
    assert tcdf.verified_max_error(preds, np.arange(300)) == rcdf.verified_max_error(
        preds, np.arange(300))
    kmin, kmax = table[0], table[-1]
    np.testing.assert_array_equal(tcdf.keys_to_unit(table, kmin, kmax),
                                  rcdf.keys_to_unit(table, kmin, kmax))
    inv = 1.0 / np.float64(kmax - kmin)
    got = tcdf.keys_to_unit_torch(keys.encode(qs, "cpu"), keys.encode(kmin, "cpu"), inv)
    want = rcdf.keys_to_unit_jnp(jnp.asarray(qs), jnp.asarray(kmin), inv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_grids_match_reference():
    for name in ("AtomicSpec", "KOSpec", "RMISpec", "SYRMISpec", "PGMSpec", "PGMBicriteriaSpec",
                 "RSSpec", "BTreeSpec"):
        for n in (1, 10, 4096, 1 << 16, 1 << 24):
            want = getattr(rix, name).default_grid(n)
            got = getattr(tix, name).default_grid(n)
            assert [g.display_name() for g in got] == [w.display_name() for w in want], (name, n)


# -- batched lookups on xla / bbs --------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_batched_interval_backends_match_reference(kind):
    """A ragged batch (padded to a common power of two, ranks clamped to
    each table's keys): ``BatchedIndexes.lookup`` on ``xla`` and ``bbs``
    equals the reference's vmapped lookup and numpy, row by row."""
    rng = np.random.default_rng([31, KINDS.index(kind)])
    tables = [make_table(rng, k, m) for k, m in (("uniform", 2048), ("clustered", 1100),
                                                  ("bursty", 1500))]
    qs = make_queries(rng, np.concatenate(tables), 400)
    ref = rtune.build_many(kind, tables)
    port = ttune.build_many(kind, tables, device="cpu")
    want = np.stack([true_ranks(t, qs) for t in tables])
    for backend in ("xla", "bbs"):
        got = port.lookup(qs, backend=backend)
        assert got.shape == (3, len(qs)) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.lookup(qs, backend=backend)),
                                      err_msg=backend)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)


def test_batched_pgm_with_lifted_levels_matches_reference():
    """PGM tables of different depths stack only after the level lift; the
    lifted stack answers ``xla``/``bbs`` as the reference's does."""
    rng = np.random.default_rng(37)
    tables = [make_table(rng, "sequential", 4096), make_table(rng, "lognormal", 4096)]
    depths = {tix.build("PGM", t, eps=4, device="cpu").s("levels") for t in tables}
    assert len(depths) == 2
    ref = rtune.build_many("PGM", tables, eps=4)
    port = ttune.build_many("PGM", tables, eps=4, device="cpu")
    assert port.index.s("levels") == max(depths)
    rows = np.stack([make_queries(rng, t, 300) for t in tables])
    q = keys.encode(rows, "cpu")
    want = np.stack([true_ranks(t, r) for t, r in zip(tables, rows)])
    for backend in ("xla", "bbs"):
        got = port.lookup(q, backend=backend).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.lookup(rows, backend=backend)))
        np.testing.assert_array_equal(got, want)
