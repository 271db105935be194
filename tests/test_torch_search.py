"""The port's search procedures (``repro_torch.core.search``) against the
reference's (``repro.core.search``) and the numpy oracle, on the cases of
``tests/test_search_procedures.py``.  Ranks are integers: equal, no
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as rsearch
from repro.core.cdf import true_ranks
from repro_torch.core import keys
from repro_torch.core import search as tsearch

from conftest import TABLE_KINDS, make_queries, make_table

SEEDS = {kind: i for i, kind in enumerate(TABLE_KINDS)}


def _case(kind: str, n: int, nq: int = 100, seed: int = 0):
    rng = np.random.default_rng([SEEDS.get(kind, 9), n, seed])
    table = make_table(rng, kind, n)
    return table, make_queries(rng, table, nq)


def _enc(x):
    return keys.encode(x, "cpu")


def test_procedure_registry_matches_reference():
    assert tuple(tsearch.PROCEDURES) == tuple(rsearch.PROCEDURES)
    assert tsearch.NO_PRED == rsearch.NO_PRED


@pytest.mark.parametrize("kind", TABLE_KINDS)
@pytest.mark.parametrize("n", [1, 2, 7, 100, 4096])
def test_bfs_bbs_ibs_tip(kind, n):
    table, qs = _case(kind, n)
    want = true_ranks(table, qs)
    for name in ("bfs", "bbs", "ibs", "tip"):
        got = tsearch.PROCEDURES[name](_enc(table), _enc(qs)).numpy()
        ref = np.asarray(rsearch.PROCEDURES[name](jnp.asarray(table), jnp.asarray(qs)))
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} {kind} n={n}")
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {kind} n={n}")


@pytest.mark.parametrize("k", [3, 6, 15, 20, 128])
def test_kary(k):
    table, qs = _case("clustered", 3000, 200, seed=k)
    want = true_ranks(table, qs)
    for name in ("kbfs", "kbbs"):
        got = tsearch.PROCEDURES[name](_enc(table), _enc(qs), k=k).numpy()
        ref = np.asarray(rsearch.PROCEDURES[name](jnp.asarray(table), jnp.asarray(qs), k=k))
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kind", TABLE_KINDS)
@pytest.mark.parametrize("n", [1, 2, 15, 16, 1000])
def test_eytzinger(kind, n):
    table, qs = _case(kind, n)
    layout, ranks, h = tsearch.eytzinger_layout(table)
    r_layout, r_ranks, r_h = rsearch.eytzinger_layout(table)
    assert h == r_h
    np.testing.assert_array_equal(layout, r_layout)
    np.testing.assert_array_equal(ranks, r_ranks)
    got = tsearch.bfe(_enc(layout), torch.from_numpy(ranks), _enc(qs), height=h, n=len(table))
    ref = rsearch.bfe(jnp.asarray(r_layout), jnp.asarray(r_ranks), jnp.asarray(qs), height=h,
                      n=len(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), true_ranks(table, qs))


def test_bounded_bbs_branchy_windows():
    """The branchy bounded epilogue (``backend="bbs"``) honours windows,
    also windows that miss the rank, as the reference does."""
    table, qs = _case("clustered", 800)
    want = true_ranks(table, qs)
    for width in (0, 1, 5, 40):
        lo = np.maximum(want - width, 0) + (width == 1)  # width 1: windows that miss
        hi = np.maximum(np.minimum(want + width, len(table) - 1), 0)
        got = tsearch.bounded_bbs_branchy(_enc(table), _enc(qs), torch.from_numpy(lo),
                                          torch.from_numpy(hi))
        ref = rsearch.bounded_bbs_branchy(jnp.asarray(table), jnp.asarray(qs), jnp.asarray(lo),
                                          jnp.asarray(hi))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"width {width}")
        if width != 1:
            np.testing.assert_array_equal(got.numpy(), want)


def test_bounded_upper_bound_windows():
    """The branch-free bounded search honours arbitrary (lo, length)
    windows, zero-length ones included."""
    table, _ = _case("uniform", 500)
    rng = np.random.default_rng(5)
    q = rng.choice(table, 50)
    want = np.searchsorted(table, q, side="right")
    lo = np.maximum(want - 7, 0)
    for length in (np.minimum(np.full(lo.shape, 20), len(table) - lo), np.zeros(lo.shape, np.int64)):
        got = tsearch.bounded_upper_bound(_enc(table), _enc(q), torch.from_numpy(lo),
                                          torch.from_numpy(length), steps=6)
        ref = rsearch.bounded_upper_bound(jnp.asarray(table), jnp.asarray(q), jnp.asarray(lo),
                                          jnp.asarray(length), steps=6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), lo)


@pytest.mark.parametrize("max_window", [1, 2, 16, 1000])
def test_bounded_bfs_windows(max_window):
    table, qs = _case("lognormal", 700, 300)
    want = true_ranks(table, qs)
    half = max(max_window // 2 - 1, 0)
    lo, hi = want - half, want + half  # lo may be -1 ("possibly before A[0]")
    got = tsearch.bounded_bfs(_enc(table), _enc(qs), torch.from_numpy(lo), torch.from_numpy(hi),
                              max_window=max_window)
    ref = rsearch.bounded_bfs(jnp.asarray(table), jnp.asarray(qs), jnp.asarray(lo),
                              jnp.asarray(hi), max_window=max_window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [2, 3, 128])
def test_bounded_kary_upper_bound(k):
    table, qs = _case("bursty", 2000, 200, seed=k)
    n = len(table)
    lo = np.zeros(qs.shape, np.int64)
    ln = np.full(qs.shape, n, np.int64)
    steps = max(1, int(np.ceil(np.log(n) / np.log(k))))
    got = tsearch.bounded_kary_upper_bound(_enc(table), _enc(qs), torch.from_numpy(lo),
                                           torch.from_numpy(ln), k=k, steps=steps)
    ref = rsearch.bounded_kary_upper_bound(jnp.asarray(table), jnp.asarray(qs), jnp.asarray(lo),
                                           jnp.asarray(ln), k=k, steps=steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(table, qs, side="right"))


def test_bounded_upper_bound_branchy_prefixes():
    """Prefix counts through the branchy loop, empty prefixes included."""
    table, qs = _case("sequential", 300)
    rng = np.random.default_rng(7)
    lo = rng.integers(0, len(table), qs.shape).astype(np.int64)
    count = np.minimum(rng.integers(0, 40, qs.shape), len(table) - lo).astype(np.int64)
    got = tsearch.bounded_upper_bound_branchy(_enc(table), _enc(qs), torch.from_numpy(lo),
                                              torch.from_numpy(count))
    ref = rsearch.bounded_upper_bound_branchy(jnp.asarray(table), jnp.asarray(qs),
                                              jnp.asarray(lo), jnp.asarray(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[count == 0] == 0).all()


def test_bounded_epilogues_on_a_stack_of_tables():
    """A ``(N, m)`` stack with ``(N, B)`` queries and windows: row ``i``
    searched in table ``i``, as the reference's vmap of the same call."""
    import jax

    rng = np.random.default_rng(11)
    tables = np.stack([make_table(rng, "uniform", 600)[:512] for _ in range(3)])
    qs = np.stack([make_queries(rng, t, 60) for t in tables])
    want = np.stack([true_ranks(t, q) for t, q in zip(tables, qs)])
    lo, hi = want - 3, want + 3
    args = (keys.encode(tables, "cpu"), keys.encode(qs, "cpu"), torch.from_numpy(lo),
            torch.from_numpy(hi))
    jargs = tuple(map(jnp.asarray, (tables, qs, lo, hi)))
    got = tsearch.bounded_bfs(*args, max_window=8)
    ref = jax.vmap(lambda t, q, a, b: rsearch.bounded_bfs(t, q, a, b, max_window=8))(*jargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = tsearch.bounded_bbs_branchy(*args)
    ref = jax.vmap(rsearch.bounded_bbs_branchy)(*jargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gathers_follow_jnp_take():
    """``take_clip`` is ``mode="clip"``; ``take_fill`` is the default mode
    (a negative index wraps once, others out of range fill), on one array
    and row-wise on a stack; the fills match jnp's for int64 and f64, and
    for keys the encoded uint64 maximum."""
    idx = np.array([-6, -5, -1, 0, 3, 4, 5, 9])
    for arr in (np.arange(5, dtype=np.int64) * 10, np.arange(5, dtype=np.float64) / 4):
        t = torch.from_numpy(arr)
        np.testing.assert_array_equal(tsearch.take_clip(t, torch.from_numpy(idx)).numpy(),
                                      np.asarray(jnp.take(jnp.asarray(arr), idx, mode="clip")))
        np.testing.assert_array_equal(tsearch.take_fill(t, torch.from_numpy(idx)).numpy(),
                                      np.asarray(jnp.take(jnp.asarray(arr), idx)))
        stack = torch.stack([t, t + 1])
        np.testing.assert_array_equal(
            tsearch.take_fill(stack, torch.from_numpy(np.stack([idx, idx[::-1]]))).numpy(),
            np.stack([np.asarray(jnp.take(jnp.asarray(arr + r), i)) for r, i in
                      ((0, idx), (1, idx[::-1]))]))
    ukeys = np.array([3, 2**63, 2**64 - 2], dtype=np.uint64)
    got = tsearch.take_fill(_enc(ukeys), torch.from_numpy(idx), tsearch.KEY_FILL)
    np.testing.assert_array_equal(keys.decode(got), np.asarray(jnp.take(jnp.asarray(ukeys), idx)))


def test_f64_to_i64_saturates_as_xla():
    x = np.array([0.5, -0.5, -2.7, 1e30, -1e30, np.nan, np.inf, -np.inf, 9.3e18, -9.3e18,
                  9.223372036854775e18, -9.223372036854775808e18])
    got = tsearch.f64_to_i64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x).astype(jnp.int64)))
