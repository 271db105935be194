"""The port's CUDA kernels held against their plain twins on the card.

Marked ``gpu``: each test decides inside itself (through the ``cuda``
fixture) whether a CUDA device exists and skips with a reason when none
does, so every worker collects the same tests.  This file imports neither
JAX nor the reference: it runs on the machine with the card, which has no
JAX, with ``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Ranks are integers and must be equal, with no tolerance; the float
kernels' tolerances are stated beside their tests.

It also holds the spawned-rank harness of the tier's collective modes
(:func:`run_ranks`, :func:`replay_cases`), which the CPU parity tests in
``test_torch_collectives.py`` share: a rank imports this file, not JAX.
"""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import index as tix
from repro_torch import kernels
from repro_torch import tune
from repro_torch.core import as_table, true_ranks
from repro_torch.kernels import ops
from repro_torch.data import generate, make_queries
from repro_torch.kernels import decode_attention as att
from repro_torch.kernels.decode_attention import (
    MAX_SPLIT,
    _decode_body,
    _decode_split_body,
    decode_attention,
    split_plan,
)
from repro_torch.kernels.embedding_bag import _bag_body, embedding_bag
from repro_torch.models import transformer
from repro_torch.serve import DecodeEngine, Request

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE")
KERNEL_OF = {"L": "kary_search", "Q": "kary_search", "C": "kary_search", "KO": "kary_search",
             "RMI": "rmi_search", "SY-RMI": "rmi_search", "PGM": "pgm_search", "PGM_M": "pgm_search",
             "RS": "rs_search", "BTREE": "kary_search"}
#: kinds with a fused batched kernel; the others take the batched model-free search
FUSED_BATCHED = ("RMI", "SY-RMI", "PGM", "PGM_M", "RS")


def _table(rng, kind: str, n: int) -> np.ndarray:
    """The table shapes of ``tests/conftest.py:make_table``."""
    if kind == "uniform":
        return as_table(rng.integers(0, 2**63, size=n, dtype=np.uint64))
    if kind == "lognormal":
        return as_table(np.exp(rng.normal(20, 2, size=n)).astype(np.uint64))
    if kind == "clustered":
        c = rng.integers(0, 2**60, size=max(4, n // 500), dtype=np.uint64)
        return as_table(c[rng.integers(0, len(c), n)] + rng.integers(0, 2**30, n).astype(np.uint64))
    if kind == "bursty":
        g = rng.exponential(100, size=n) * (1 + 50 * (rng.random(n) < 0.01))
        return as_table(np.cumsum(g).astype(np.uint64) + 10**15)
    return as_table(np.arange(n, dtype=np.uint64) * 7 + 3)


def _queries(rng, table):
    keys = rng.choice(table, min(len(table), 2000)).astype(np.uint64)
    with np.errstate(over="ignore"):
        extremes = np.array([0, table.min() - np.uint64(1), table.max() + np.uint64(1), 2**64 - 1],
                            dtype=np.uint64)
    return np.concatenate([keys, keys - np.uint64(1), keys + np.uint64(1),
                           rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64), extremes])


# -- cases shared with the CPU parity tests (this file imports no JAX) ------------------

#: table sizes around the edges of the k-ary kernel's plan: the staged tree
#: (2^10 keys), the sweep (a window of 32 keys after the tree: 2^15), odd
#: global-trip chains (32,769: a window of 33 -> 17 keys; 33,793: 34 ->
#: 17; 65,537: 65 -> 33 -> 17) and longer ones (262,145: 257 -> ... -> 17)
EDGE_NS = (1, 2, 3, 7, 8, 9, 1023, 1024, 1025, 4095, 4096, 4097,
           32767, 32768, 32769, 33793, 65537, 65536 + 3, 131073, 262145)


def edge_table(n: int) -> np.ndarray:
    """``n`` distinct random uint64 keys, sorted, seeded by ``n``."""
    rng = np.random.default_rng(n)
    table = np.unique(rng.integers(0, 2**64 - 1, 2 * n + 8, dtype=np.uint64))[:n]
    assert len(table) == n
    return table


def every_key_queries(table):
    """Every key, key +- 1, 0 and 2^64 - 1."""
    with np.errstate(over="ignore"):
        return np.concatenate([table, table - np.uint64(1), table + np.uint64(1),
                               np.array([0, 2**64 - 1], dtype=np.uint64)])


def clamp_table():
    """The pinned clustered table of
    ``test_pallas_window_center_clamp_regression``: dense clusters in a
    huge key span, where f32 ``u`` collapses, with its query mix."""
    rng = np.random.default_rng(42)
    centers = rng.integers(0, 2**63, size=8, dtype=np.uint64)
    parts = [c + rng.integers(0, 2**20, size=256, dtype=np.uint64) for c in centers]
    table = np.unique(np.concatenate(parts))
    qs = np.concatenate(
        [rng.choice(table, 400), rng.integers(0, 2**63, 100, dtype=np.uint64)]
    ).astype(np.uint64)
    return table, qs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test, the old
    setting restored after it.  A test that compares the port with itself
    bit for bit through ``index_add``, ``index_put(accumulate=True)`` (a
    gather's backward) or DimeNet's segment sums takes it: on the CPU
    those accumulate repeated rows in an order that depends on the
    threads, unless the deterministic kernels are asked for."""
    old, warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old, warn_only=warn)


@pytest.mark.gpu
@pytest.mark.parametrize("table_kind", ("uniform", "lognormal", "clustered", "bursty", "sequential"))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_twin_and_ref_on_card(cuda, kind, table_kind):
    rng = np.random.default_rng(31)
    table = _table(rng, table_kind, 65536)
    qs = _queries(rng, table)
    idx = tix.build(kind, table, device=cuda)
    twin = tix.Index.from_numpy(idx.kind, idx.static, idx.to_numpy(), idx.info, device="cpu")
    kernels.reset_launches()
    got = idx.lookup(table, qs, backend="kernel")
    torch.cuda.synchronize()
    assert kernels.launches()[KERNEL_OF[kind]] == 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.cpu().numpy(), twin.lookup(table, qs, backend="kernel").numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), idx.lookup(table, qs, backend="ref").cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), true_ranks(table, qs))


@pytest.mark.gpu
def test_ragged_tail_is_masked(cuda):
    rng = np.random.default_rng(32)
    table = _table(rng, "lognormal", 4096)
    for nq in (1, 255, 257, 1000):
        qs = rng.choice(table, nq)
        for kind in ("KO", "RMI", "PGM", "RS"):
            idx = tix.build(kind, table, device=cuda)
            got = idx.lookup(table, qs, backend="kernel").cpu().numpy()
            np.testing.assert_array_equal(got, true_ranks(table, qs), err_msg=f"{kind}/{nq}")


@pytest.mark.gpu
def test_rmi_leaf_boundary_table_is_exact(cuda):
    """The table on which an f32 leaf product misses keys near leaf
    boundaries (see ``test_rmi_leaf_product_is_the_reencoders``)."""
    rng = np.random.default_rng(0)
    table = _table(rng, "lognormal", 65536)
    idx = tix.build(tix.RMISpec(b=len(table) // 2), table, device=cuda)
    got = idx.lookup(table, table, backend="kernel").cpu().numpy()
    np.testing.assert_array_equal(got, np.arange(len(table)))


@pytest.mark.gpu
@pytest.mark.parametrize("dataset", ("amzn64", "osm"))
@pytest.mark.parametrize("kind", ("RMI", "SY-RMI"))
def test_rmi_fused_u_operands_match_searchsorted_on_card(cuda, kind, dataset):
    """The RMI kernels take the raw queries and the f64 kmin/inv_span and
    compute u themselves: single-table and batched ranks equal
    ``torch.searchsorted`` and the twins, which compute u with
    ``unit_f32``."""
    from repro_torch.core import keys

    table = generate(dataset, 1 << 18)
    qs = np.concatenate([make_queries(table, 50000, seed=2), _queries(np.random.default_rng(35), table)])
    idx = tix.build(kind, table, device=cuda)
    impl = tix.impls.query_impl(kind)
    t, q = keys.encode(table, cuda), keys.encode(qs, cuda)
    args, kwargs = impl.operands(idx, t, q)
    assert args[0] is q and args[2].dtype == torch.float64  # no u among the operands
    want = torch.searchsorted(t, q, right=True) - 1
    got = impl.search(*args, **kwargs).long()
    assert torch.equal(got, want)
    assert torch.equal(got, impl.plain(*args, **kwargs).long())
    shards = np.split(table, 4)
    bm = tune.build_many(kind, shards, device=cuda)
    bq = keys.encode(np.stack([make_queries(sh, 20000, seed=3) for sh in shards]), cuda)
    bargs, bkw = impl.batched_operands(bm.index, bm.tables, bq)
    assert bargs[2].shape == (4,) and bargs[2].dtype == torch.float64
    got = impl.batched_search(*bargs, **bkw).long()
    assert torch.equal(got, torch.searchsorted(bm.tables, bq, right=True) - 1)
    assert torch.equal(got, impl.batched_plain(*bargs, **bkw).long())


def _batched_kernel(kind: str) -> str:
    return "batched_" + (KERNEL_OF[kind] if kind in FUSED_BATCHED else "kary_search")


@pytest.mark.gpu
@pytest.mark.parametrize("ragged", (False, True))
@pytest.mark.parametrize("kind", KINDS)
def test_batched_kernel_matches_twin_and_ref_on_card(cuda, kind, ragged):
    rng = np.random.default_rng(33)
    sizes = (65536, 30000, 50000) if ragged else (65536, 65536, 65536)
    tables = [_table(rng, k, n) for k, n in zip(("uniform", "clustered", "bursty"), sizes)]
    qs = _queries(rng, np.concatenate(tables))
    bm = tune.build_many(kind, tables, device=cuda)
    twin = tune.build_many(kind, tables, device="cpu")
    kernels.reset_launches()
    got = bm.lookup(qs, backend="kernel")
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert counts[_batched_kernel(kind)] == 1
    assert sum(counts.values()) == 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, twin.lookup(qs, backend="kernel").numpy())
    np.testing.assert_array_equal(got, bm.lookup(qs, backend="ref").cpu().numpy())
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=f"{kind}/{i}")


@pytest.mark.gpu
def test_batched_ragged_tail_and_row_queries(cuda):
    rng = np.random.default_rng(34)
    tables = [_table(rng, "lognormal", 4096) for _ in range(3)]
    for kind in ("BTREE", "RMI", "PGM", "RS"):
        bm = tune.build_many(kind, tables, device=cuda)
        for nq in (1, 255, 257, 1000):
            rows = np.stack([rng.choice(t, nq) for t in tables])
            got = bm.lookup(rows, backend="kernel").cpu().numpy()
            for i, t in enumerate(tables):
                np.testing.assert_array_equal(got[i], true_ranks(t, rows[i]), err_msg=f"{kind}/{nq}")


# -- the redesigned model-free, PGM and RS search kernels ------------------------------
#
# kary_search: the top of the implicit search tree in shared memory and a
# final sweep; pgm_search: u in the kernel, int64 directories, per-query
# trips; rs_search: u and the unsigned radix prefix in the kernel, int64
# leaves, per-query trips in both searches.  Both single-table and
# batched, against their twins and torch.searchsorted, bit for bit.

def _edge_tables():
    out = [(f"n={n}", edge_table(n)) for n in EDGE_NS]
    return out + [("pinned clamp", clamp_table()[0])]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("KO", "PGM", "PGM_M", "RS"))
def test_redesigned_search_kernels_match_twin_and_searchsorted_on_card(cuda, kind):
    """Every key, key +- 1, 0 and 2^64 - 1 on tables of 1 to 262,145 keys
    (``EDGE_NS``: the tree's, the sweep's and the global trips' edges)
    and the pinned clamp table: the single-table kernel and the batched
    kernel (the table stacked three times, the queries expand-ed) equal
    their twins and ``torch.searchsorted``."""
    from repro_torch.core import keys

    impl = tix.impls.query_impl(kind)
    for label, table in _edge_tables():
        idx = tix.build(kind, table, device=cuda)
        t, q = keys.encode(table, cuda), keys.encode(every_key_queries(table), cuda)
        want = torch.searchsorted(t, q, right=True) - 1
        args, kwargs = impl.operands(idx, t, q)
        kernels.reset_launches()
        got = impl.search(*args, **kwargs).long()
        torch.cuda.synchronize()
        assert kernels.launches()[KERNEL_OF[kind]] == 1, label
        assert torch.equal(got, want), (kind, label)
        assert torch.equal(got, impl.plain(*args, **kwargs).long()), (kind, label)
        bm = tune.build_many(kind, [table] * 3, device=cuda)
        bq = bm.queries_for(q)
        assert bq.stride(0) == 0
        bargs, bkw = impl.batched_operands(bm.index, bm.tables, bq)
        got = impl.batched_search(*bargs, **bkw).long()
        assert torch.equal(got, want.expand(3, -1)), (kind, label)
        assert torch.equal(got, impl.batched_plain(*bargs, **bkw).long()), (kind, label)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("KO", "PGM", "PGM_M", "RS"))
def test_redesigned_batched_kernels_on_ragged_tiers_on_card(cuda, kind):
    """A ragged ``build_many`` (three table shapes, 65,536 / 5,000 / 30,001
    keys: PGM levels lifted, the count clamp) with expand-ed and packed
    queries, and 0 and 1 queries."""
    rng = np.random.default_rng(37)
    tables = [_table(rng, k, m) for k, m in (("clustered", 65536), ("bursty", 5000),
                                             ("lognormal", 30001))]
    bm = tune.build_many(kind, tables, device=cuda)
    twin = tune.build_many(kind, tables, device="cpu")
    qs = _queries(rng, np.concatenate(tables))
    kernels.reset_launches()
    got = bm.lookup(qs, backend="kernel").cpu().numpy()
    assert kernels.launches()[_batched_kernel(kind)] == 1
    np.testing.assert_array_equal(got, twin.lookup(qs, backend="kernel").numpy())
    rows = np.stack([rng.choice(t, 3000) for t in tables])
    packed = bm.lookup(rows, backend="kernel").cpu().numpy()
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=f"{kind}/{i}")
        np.testing.assert_array_equal(packed[i], true_ranks(t, rows[i]), err_msg=f"{kind}/{i}")
    for nq in (0, 1):
        few = qs[:nq]
        assert bm.lookup(few, backend="kernel").shape == (3, nq)
        single = tix.build(kind, tables[0], device=cuda)
        np.testing.assert_array_equal(single.lookup(tables[0], few, backend="kernel").cpu().numpy(),
                                      true_ranks(tables[0], few))


def rs_span_table():
    """Keys from near 0 to near 2^64: ``q - kmin`` has its top bit set for
    the upper half of the key space, where the radix prefix must be an
    unsigned shift (``test_rs_prefix_is_unsigned_on_a_span_of_2_63_or_more``)."""
    rng = np.random.default_rng(15)
    return np.unique(np.concatenate([
        rng.integers(0, 2**20, 2000, dtype=np.uint64),
        rng.integers(2**63, 2**64 - 1, 2000, dtype=np.uint64),
        np.array([2**63 - 1, 2**63, 2**64 - 2], dtype=np.uint64),
    ]))


#: a key span below 2^r: shift 0, and a query far above the table has an
#: unsigned difference of 2^63 or more, which clamps to the top prefix
RS_SHIFT0 = (np.arange(100, 400, 3, dtype=np.uint64),
             np.array([0, 99, 100, 101, 398, 399, 2**40, 2**63, 2**64 - 1], dtype=np.uint64))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("span >= 2^63", "shift 0"))
def test_rs_unsigned_prefix_on_card(cuda, case):
    """The RS kernels compute the radix prefix as an unsigned shift: on a
    key span of 2^63 or more, and with shift 0 and queries 2^63 or more
    above the table, single-table and batched (the table stacked twice)
    ranks equal the twins and ``torch.searchsorted``."""
    from repro_torch.core import keys

    if case == "shift 0":
        table, extra = RS_SHIFT0
        spec = tix.RSSpec(eps=4, r_bits=12)
    else:
        table = rs_span_table()
        extra = np.array([0, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1], dtype=np.uint64)
        spec = tix.RSSpec(eps=16, r_bits=10)
    idx = tix.build(spec, table, device=cuda)
    assert (int(idx.arrays["shift"]) == 0) == (case == "shift 0")
    impl = tix.impls.query_impl("RS")
    qs = np.concatenate([every_key_queries(table), extra])
    t, q = keys.encode(table, cuda), keys.encode(qs, cuda)
    want = torch.searchsorted(t, q, right=True) - 1
    args, kwargs = impl.operands(idx, t, q)
    got = impl.search(*args, **kwargs).long()
    assert torch.equal(got, want)
    assert torch.equal(got, impl.plain(*args, **kwargs).long())
    bm = tune.build_many(spec, [table, table], device=cuda)
    bq = bm.queries_for(q)
    bargs, bkw = impl.batched_operands(bm.index, bm.tables, bq)
    got = impl.batched_search(*bargs, **bkw).long()
    assert torch.equal(got, want.expand(2, -1))
    assert torch.equal(got, impl.batched_plain(*bargs, **bkw).long())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("RMI", "PGM", "RS"))
def test_batched_search_kernels_past_65535_tables_on_card(cuda, kind):
    """The grid's y dimension holds at most 65,535 rows: the batched RMI,
    PGM and RS kernels loop each row over the tables past that.  65,537
    stacked copies of one small index's leaves (not through
    ``build_many``), each table's own queries: one launch, the ranks of
    ``torch.searchsorted``."""
    from repro_torch.core import keys
    from repro_torch.dist import stack_indexes

    n_tables, n = 65537, 64
    table = edge_table(n)
    # small leaves: every leaf is copied 65,537 times
    spec = {"RMI": tix.RMISpec(b=16), "PGM": tix.PGMSpec(eps=8),
            "RS": tix.RSSpec(eps=8, r_bits=6)}[kind]
    stacked = stack_indexes([tix.build(spec, table, device=cuda)])
    leaves = {k: a.expand(n_tables, *a.shape[1:]).contiguous() for k, a in stacked.arrays.items()}
    many = tix.Index(kind, stacked.static, leaves)
    t = keys.encode(table, cuda)
    tables = t.expand(n_tables, n).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(39)
    q = tables.gather(1, torch.randint(0, n, (n_tables, 48), generator=gen, device=cuda))
    q = torch.cat([q, q - 1, q + 1], dim=1)
    impl = tix.impls.query_impl(kind)
    args, kwargs = impl.batched_operands(many, tables, q)
    kernels.reset_launches()
    got = impl.batched_search(*args, **kwargs).long()
    torch.cuda.synchronize()
    assert kernels.launches()["batched_" + KERNEL_OF[kind]] == 1
    assert got.shape == (n_tables, q.shape[1])
    assert torch.equal(got, torch.searchsorted(tables, q, right=True) - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tables,nq", ((64, 1), (64, 600), (8, 51200), (4, 1 << 20)))
def test_batched_kary_grid_rows_on_card(cuda, n_tables, nq):
    """The batched k-ary kernel's grid: one row of blocks taking the
    tables in turn when one table's queries fill the resident blocks
    (2^20), else rows side by side, one table a row (1 and 600 queries
    over 64 tables) or several in turn (51,200 queries: 100 blocks a
    table, a few rows over 8 tables).  131,073 keys: three global trips
    (a window of 129 -> 65 -> 33 -> 17 keys) before the sweep."""
    from repro_torch.core import keys
    from repro_torch.kernels.kary_search import batched_kary_search, batched_kary_search_plain

    rng = np.random.default_rng(38)
    tables = np.stack([edge_table(131073) + np.uint64(i) for i in range(n_tables)])
    qs = np.stack([rng.choice(t, nq) + rng.integers(0, 2, nq).astype(np.uint64) for t in tables])
    t, q = keys.encode(tables, cuda), keys.encode(qs, cuda)
    kernels.reset_launches()
    got = batched_kary_search(t, q).long()
    assert kernels.launches()["batched_kary_search"] == 1
    assert torch.equal(got, torch.searchsorted(t, q, right=True) - 1)
    assert torch.equal(got, batched_kary_search_plain(t, q).long())


# -- the LM serving path's kernels: decode attention and embedding bag ----------------
#
# Float kernels: held against their plain twins on the card within stated
# tolerances.  f32: the kernel's sums run in another order than the twin's
# products (2e-5).  bf16: both compute in f32 and round the output once to
# bf16, so they differ by at most one bf16 ulp, 2^-7 of the value (rtol
# 8e-3), plus f32 noise near 0 (atol 1e-4; the card measured 2.44e-4 at
# values near 0.05, one ulp).  The embedding bag adds with atomics in a
# run-dependent order (3e-5, the reference test's tolerance).

ATT_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 8e-3)}  # (atol, rtol)


def _attention_inputs(rng, b, hq, hkv, d, s, dtype, dev):
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("hq,hkv,d", ((4, 4, 16), (8, 2, 32), (16, 1, 64), (14, 2, 64),
                                      (32, 8, 128), (28, 4, 128)))
def test_decode_attention_kernel_matches_twin_on_card(cuda, monkeypatch, hq, hkv, d, dtype):
    """Groups 1, 4, 7 and 16, head dims 16 to 128; ragged lengths with 0, 1,
    a tile edge, S, and S not a multiple of the 256-position tile."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(41)
    s = 600
    q, k, v = _attention_inputs(rng, 6, hq, hkv, d, s, dtype, cuda)
    kv_len = torch.tensor([0, 1, 256, 257, s, 433], dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    got = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert kernels.launches()["decode_attention"] == 1
    assert got.dtype == dtype and got.shape == (6, hq, d)
    want = _decode_body(q, k, v, kv_len)
    atol, rtol = ATT_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    assert (got[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", (None, 1, 2, 5, MAX_SPLIT))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("hq,hkv,d", ((14, 2, 64), (32, 8, 128), (16, 1, 64), (4, 4, 256),
                                      (8, 8, 8)))
def test_decode_attention_split_edges_on_card(cuda, monkeypatch, hq, hkv, d, dtype, n_split):
    """The split over the sequence: lengths 0, 1, a tile - 1, + 0 and + 1,
    S, past S, and rows shorter than n_split tiles (empty shares); groups
    7, 4, 16 and 1, head dims 8 to 256 (tiles 8 to 64).  A given n_split
    replaces ``split_plan``'s (the wrapper's tile kept).  Two calls in a row
    check that the combining blocks leave the ticket counters at 0."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(46)
    s = 700
    tile, _ = split_plan(9, hkv, d, s, torch.tensor([], dtype=dtype).element_size(), 132)
    if n_split is not None:
        plan = att.split_plan
        monkeypatch.setattr(att, "split_plan", lambda *a: (plan(*a)[0], n_split))
    q, k, v = _attention_inputs(rng, 9, hq, hkv, d, s, dtype, cuda)
    kv_len = torch.tensor([0, 1, tile - 1, tile, tile + 1, s, s + 5, 3 * tile - 1, 2],
                          dtype=torch.int32, device=cuda)
    atol, rtol = ATT_TOL[dtype]
    want = _decode_body(q, k, v, kv_len).float().cpu().numpy()
    kernels.reset_launches()
    for _ in range(2):
        got = decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=rtol, atol=atol)
        assert (got[0] == 0).all()
    assert kernels.launches()["decode_attention"] == 2
    if n_split is not None:
        split = _decode_split_body(q, k, v, kv_len, n_split, tile).float().cpu().numpy()
        np.testing.assert_allclose(got.float().cpu().numpy(), split, rtol=rtol, atol=atol)


def combine_blocks(outs, lses):
    """One row's attention from its sequence blocks' ``(out, lse)`` (the
    single-process form of ``layers.combine_softmax_shards``): weights
    ``exp(lse - max lse)``, the weighted mean of the outputs, in f32."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))[..., None]
    return (w * torch.stack(outs)).sum(dim=0) / w.sum(dim=0)


def blocks_of(k, v, kv_len, n: int):
    """``k``/``v`` cut into ``n`` contiguous sequence blocks, each with its
    local lengths ``clamp(kv_len - offset, 0, S / n)``."""
    s_loc = k.shape[1] // n
    cut = [slice(i * s_loc, (i + 1) * s_loc) for i in range(n)]
    return [(k[:, c].contiguous(), v[:, c].contiguous(),
             torch.clamp(kv_len - c.start, 0, s_loc).to(torch.int32)) for c in cut]


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", (None, 1, 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("hq,hkv,d", ((14, 2, 64), (32, 8, 128), (16, 1, 64), (4, 4, 256),
                                      (8, 8, 8)))
def test_decode_attention_lse_matches_twin_on_card(cuda, monkeypatch, hq, hkv, d, dtype, n_split):
    """``return_lse=True``: one launch, the output in f32 and the (B, Hq)
    log-sum-exp within ``ATT_TOL[f32]`` of the twin's, at the tensor-core
    head dims (bf16 at 64 and 128) and the CUDA cores' (f32; bf16 at 8 and
    256), through the one-share path and the combining block (a given
    n_split replaces the plan's); ``NEG_INF`` and 0 at ``kv_len = 0``.
    With it off, the output is the lse path's rounded to the input dtype,
    bit for bit (the default path's arithmetic is the same)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(49)
    s = 700
    tile, _ = split_plan(9, hkv, d, s, torch.tensor([], dtype=dtype).element_size(), 132)
    if n_split is not None:
        plan = att.split_plan
        monkeypatch.setattr(att, "split_plan", lambda *a: (plan(*a)[0], n_split))
    q, k, v = _attention_inputs(rng, 9, hq, hkv, d, s, dtype, cuda)
    kv_len = torch.tensor([0, 1, tile - 1, tile, tile + 1, s, s + 5, 3 * tile - 1, 2],
                          dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    got, lse = decode_attention(q, k, v, kv_len, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launches()["decode_attention"] == 1
    assert got.dtype == lse.dtype == torch.float32 and lse.shape == (9, hq)
    want, want_lse = _decode_body(q, k, v, kv_len, return_lse=True)
    atol, rtol = ATT_TOL[torch.float32]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), rtol=rtol, atol=atol)
    assert (got[0] == 0).all() and (lse[0] == att.NEG_INF).all()
    assert torch.equal(decode_attention(q, k, v, kv_len), got.to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", (2, 4))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("hq,hkv,d", ((14, 2, 64), (16, 16, 128), (8, 8, 8)))
def test_decode_attention_blocks_combine_to_one_call_on_card(cuda, hq, hkv, d, dtype, n_blocks):
    """The kernel with ``return_lse`` on each of 2 or 4 sequence blocks,
    combined on the card, == the one call on the whole cache within
    ``ATT_TOL`` of the dtype: rows that end in the first block (the
    others empty), on a block edge, inside the last block, and at 0."""
    rng = np.random.default_rng(50)
    s = 1024
    q, k, v = _attention_inputs(rng, 6, hq, hkv, d, s, dtype, cuda)
    kv_len = torch.tensor([0, 1, s // 4, s // 2 + 1, s - 3, s], dtype=torch.int32, device=cuda)
    parts = [decode_attention(q, kb, vb, n, return_lse=True) for kb, vb, n in
             blocks_of(k, v, kv_len, n_blocks)]
    got = combine_blocks(*zip(*parts)).to(dtype)
    want = decode_attention(q, k, v, kv_len)
    atol, rtol = ATT_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    assert (got[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_decode_attention_on_a_slice_of_kv_heads_on_card(cuda, dtype):
    """K/V given as a slice of a cache's KV heads (positions ``Hkv * D``
    apart, not contiguous) == the kernel on a contiguous copy of it."""
    rng = np.random.default_rng(51)
    q, k, v = _attention_inputs(rng, 4, 16, 16, 128, 600, dtype, cuda)
    kv_len = torch.tensor([600, 1, 333, 17], dtype=torch.int32, device=cuda)
    ks, vs = k[:, :, 4:12], v[:, :, 4:12]
    assert not ks.is_contiguous()
    qs = q[:, 4:12].contiguous()
    got = decode_attention(qs, ks, vs, kv_len)
    assert torch.equal(got, decode_attention(qs, ks.contiguous(), vs.contiguous(), kv_len))
    with pytest.raises(ValueError, match="contiguous"):  # rows not S positions apart
        decode_attention(qs[::2].contiguous(), ks[::2], vs[::2], kv_len[::2].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_decode_attention_two_streams_on_card(cuda, dtype):
    """Calls on two streams at once, each split over the sequence, do not
    share ticket counters or partials: both streams' outputs match the
    twin."""
    rng = np.random.default_rng(47)
    s = 4096
    inputs = [_attention_inputs(rng, 4, 14, 2, 64, s, dtype, cuda) for _ in range(2)]
    kv_len = torch.tensor([s, s - 17, 1000, 3], dtype=torch.int32, device=cuda)
    assert split_plan(4, 2, 64, s, inputs[0][0].element_size(), 132)[1] > 1
    wants = [_decode_body(*t, kv_len).float().cpu().numpy() for t in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(decode_attention(*inputs[i], kv_len))
    torch.cuda.synchronize()
    atol, rtol = ATT_TOL[dtype]
    for want, got in zip(wants, outs):
        for g in got:
            np.testing.assert_allclose(g.float().cpu().numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_decode_attention_in_cuda_graph_on_card(cuda):
    """A captured call replays right, also after an eager call of a larger
    shape has grown the stream's cached counters."""
    rng = np.random.default_rng(48)
    q, k, v = _attention_inputs(rng, 2, 14, 2, 64, 2048, torch.bfloat16, cuda)
    kv_len = torch.tensor([2048, 700], dtype=torch.int32, device=cuda)
    want = _decode_body(q, k, v, kv_len).float().cpu().numpy()
    atol, rtol = ATT_TOL[torch.bfloat16]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, k, v, kv_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = [decode_attention(q, k, v, kv_len) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for o in out:
            np.testing.assert_allclose(o.float().cpu().numpy(), want, rtol=rtol, atol=atol)
        # 1,280 (row, KV head) pairs: more counters than the stream had cached
        big = _attention_inputs(rng, 640, 14, 2, 64, 32, torch.bfloat16, cuda)
        decode_attention(*big, torch.full((640,), 32, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_decode_attention_ops_entry_and_limits_on_card(cuda):
    rng = np.random.default_rng(42)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((3, 8, 32), (3, 300, 2, 32), (3, 300, 2, 32)))
    kvl = np.array([350, 20, 300], np.int32)  # past S: the zero rows of the padding count
    got = ops.decode_attention(q, k, v, kvl, s_tile=128)
    assert got.device.type == "cuda"
    cpu = ops.decode_attention(q, k, v, kvl, s_tile=128, device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), rtol=2e-5, atol=2e-5)
    qq, kk, vv = _attention_inputs(rng, 1, 34, 2, 64, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="query heads"):
        decode_attention(qq, kk, vv, torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("v_,d,n_items,bags,sort", ((100, 8, 50, 4, True), (1000, 64, 300, 16, True),
                                                   (513, 32, 128, 8, True), (513, 32, 128, 8, False),
                                                   (4096, 128, 8192, 1024, False)))
def test_embedding_bag_kernel_matches_twin_on_card(cuda, v_, d, n_items, bags, sort):
    rng = np.random.default_rng(43)
    table = torch.from_numpy(rng.normal(size=(v_, d)).astype(np.float32)).to(cuda)
    ids = rng.integers(0, v_, n_items).astype(np.int32)
    ids[:3] = [-1, v_, v_ + 100]  # out of range: add nothing
    seg = rng.integers(-1, bags + 1, n_items).astype(np.int32)  # some bags out of range too
    if sort:
        seg = np.sort(seg)
    w = rng.normal(size=n_items).astype(np.float32)
    ids_t, seg_t, w_t = (torch.from_numpy(x).to(cuda) for x in (ids, seg, w))
    kernels.reset_launches()
    got = embedding_bag(table, ids_t, seg_t, w_t, num_bags=bags)
    torch.cuda.synchronize()
    assert kernels.launches()["embedding_bag"] == 1
    want = _bag_body(table, ids_t, seg_t, w_t, num_bags=bags)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-5, atol=3e-5)
    ones = ops.embedding_bag(table, ids_t, seg_t, num_bags=bags)
    want1 = _bag_body(table, ids_t, seg_t, torch.ones_like(w_t), num_bags=bags)
    np.testing.assert_allclose(ones.cpu().numpy(), want1.cpu().numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", (True, False), ids=("aligned", "offset"))
@pytest.mark.parametrize("sort", (True, False), ids=("sorted", "unsorted"))
@pytest.mark.parametrize("d", (1, 3, 4, 128, 130, 256))
def test_embedding_bag_paths_on_card(cuda, d, sort, aligned):
    """The kernel's float4 path (D % 4 == 0 and a 16-byte aligned table)
    and its scalar path (any other D, or a table at a storage offset of one
    float): sorted bags (runs summed in registers), unsorted ones (runs of
    one), ids and bags out of range, bags longer than a warp's 32-item
    chunk, and empty bags."""
    rng = np.random.default_rng(49)
    v_, n_items, bags = 777, 3000, 40
    data = torch.from_numpy(rng.normal(size=(v_, d)).astype(np.float32)).to(cuda)
    if aligned:
        table = data
    else:
        table = torch.empty(v_ * d + 1, device=cuda)[1:].view(v_, d)
        table.copy_(data)
        assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    ids = rng.integers(0, v_, n_items).astype(np.int32)
    ids[:5] = [-1, v_, v_ + 1, 2**31 - 1, -(2**31)]
    seg = rng.integers(-1, bags + 1, n_items).astype(np.int32)
    seg[seg == 7] = 8  # bag 7 stays empty
    if sort:
        seg = np.sort(seg)
    w = rng.normal(size=n_items).astype(np.float32)
    ids_t, seg_t, w_t = (torch.from_numpy(x).to(cuda) for x in (ids, seg, w))
    kernels.reset_launches()
    got = embedding_bag(table, ids_t, seg_t, w_t, num_bags=bags)
    torch.cuda.synchronize()
    assert kernels.launches()["embedding_bag"] == 1
    want = _bag_body(data, ids_t, seg_t, w_t, num_bags=bags)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-5, atol=3e-5)
    assert bool((got[7] == 0).all())


def _tiny_lm(dtype):
    return dataclasses.replace(configs.get("qwen2-0.5b", reduced=True).config, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_step_kernel_matches_ref_on_card(cuda, monkeypatch, dtype):
    """A 2-layer reduced qwen2-0.5b: the kernel's logits against the
    reference math (``backend="ref"``) over 6 positions, from equal caches.
    bf16: the reference math rounds logits and softmax weights to bf16,
    the kernel does not (0.1 absolute, 0.05 relative on logits ~4)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _tiny_lm(dtype)
    params = transformer.cast_params(
        transformer.init(torch.Generator(device=cuda).manual_seed(0), cfg),
        getattr(torch, dtype))
    caches = [transformer.init_cache(cfg, 3, 40, device=cuda) for _ in range(2)]
    rng = np.random.default_rng(44)
    tol = (2e-5, 2e-5) if dtype == "float32" else (0.1, 0.05)
    kernels.reset_launches()
    for pos in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)).to(cuda)
        got, caches[0] = transformer.decode_step(params, caches[0], tok, pos, cfg, backend="kernel")
        want, caches[1] = transformer.decode_step(params, caches[1], tok, pos, cfg, backend="ref")
        caches[1] = {kv: c.clone() for kv, c in caches[0].items()}  # the next step from equal caches
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol[0], rtol=tol[1])
        assert torch.isfinite(got).all()
    assert kernels.launches()["decode_attention"] == 6 * cfg.n_layers


@pytest.mark.gpu
def test_engine_serves_through_the_kernel_on_card(cuda):
    cfg = _tiny_lm("bfloat16")
    params = transformer.init(torch.Generator(device=cuda).manual_seed(1), cfg)
    eng = DecodeEngine(params, cfg, batch_slots=4, max_seq=64)
    rng = np.random.default_rng(45)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(3, 10)).astype(np.int32),
                    max_new_tokens=6) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    eng.run_until_drained()
    steps = sum(len(r.prompt) for r in reqs) + eng.ticks
    assert kernels.launches()["decode_attention"] == cfg.n_layers * steps
    assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
    assert eng.metrics()["requests_finished"] == 6


# -- the interval backends (xla, bbs) and the one-process sharded tier -----------------
#
# xla and bbs are tensor ops on the card (no kernel of the port): the
# windows equal the CPU's, bit for bit, and the ranks equal the kernel's and
# torch.searchsorted.  The sharded tier's kernel path is one batched launch.


def _windows_hold(lo, hi, want):
    """The bounded search finds ``rank + 1`` in ``[lo, hi + 1]``."""
    return bool(((lo - 1 <= want) & (want <= hi)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("table_kind", ("uniform", "lognormal", "clustered", "bursty", "sequential"))
@pytest.mark.parametrize("kind", KINDS)
def test_interval_backends_match_searchsorted_on_card(cuda, kind, table_kind):
    from repro_torch.core import keys

    rng = np.random.default_rng(61)
    table = _table(rng, table_kind, 65536)
    qs = _queries(rng, table)
    idx = tix.build(kind, table, device=cuda)
    twin = tix.Index.from_numpy(idx.kind, idx.static, idx.to_numpy(), idx.info, device="cpu")
    t, q = keys.encode(table, cuda), keys.encode(qs, cuda)
    want = torch.searchsorted(t, q, right=True) - 1
    lo, hi = idx.intervals(t, q)
    cpu_lo, cpu_hi = twin.intervals(table, qs)
    assert torch.equal(lo.cpu(), cpu_lo) and torch.equal(hi.cpu(), cpu_hi)
    assert _windows_hold(lo, hi, want)
    kernels.reset_launches()
    for backend in tix.INTERVAL_BACKENDS:
        got = idx.lookup(t, q, backend=backend)
        assert got.device.type == "cuda" and got.dtype == torch.int64
        assert torch.equal(got, want), (kind, table_kind, backend)
    assert sum(kernels.launches().values()) == 0  # tensor ops, no kernel of the port
    assert torch.equal(idx.lookup(t, q, backend="kernel"), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_batched_interval_backends_on_card(cuda, kind):
    rng = np.random.default_rng(62)
    tables = [_table(rng, k, n) for k, n in (("clustered", 65536), ("bursty", 5000),
                                             ("lognormal", 30001))]
    bm = tune.build_many(kind, tables, device=cuda)
    twin = tune.build_many(kind, tables, device="cpu")
    qs = _queries(rng, np.concatenate(tables))
    for backend in tix.INTERVAL_BACKENDS:
        got = bm.lookup(qs, backend=backend).cpu().numpy()
        np.testing.assert_array_equal(got, twin.lookup(qs, backend=backend).numpy())
        for i, t in enumerate(tables):
            np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=f"{kind}/{backend}")


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", (4, 160))
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_lookup_on_card(cuda, kind, n_shards):
    """Every backend of ``sharded_lookup`` equals ``torch.searchsorted`` on
    the whole table, fence keys included; ``backend="kernel"`` is exactly
    one launch of the kind's batched kernel.  160 shards take the router's
    k-ary branch."""
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    rng = np.random.default_rng(63)
    table = _table(rng, "lognormal", 40000 if n_shards == 4 else 64000)
    sidx = tsi.ShardedIndex.build(kind, table, n_shards, device=cuda)
    fences = keys.decode(sidx.fences)
    qs = np.concatenate([_queries(rng, table), fences, fences - np.uint64(1), fences + np.uint64(1)])
    t, q = keys.encode(table, cuda), keys.encode(qs, cuda)
    want = torch.searchsorted(t, q, right=True) - 1
    for backend in tsi.TIER_BACKENDS:
        kernels.reset_launches()
        got = tsi.sharded_lookup(sidx, q, backend=backend)
        torch.cuda.synchronize()
        counts = kernels.launches()
        assert got.device.type == "cuda" and got.dtype == torch.int64
        assert torch.equal(got, want), (kind, n_shards, backend)
        expected = {_batched_kernel(kind): 1} if backend == "kernel" else {}
        assert {k: v for k, v in counts.items() if v} == expected, (kind, backend, counts)


# -- spawned ranks over gloo: the tier's collective modes ----------------------------------


def run_ranks(target, world: int, work_dir, *args, timeout: float = 600.0) -> None:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    joined in one gloo process group (``file://`` rendezvous in
    ``work_dir``, so parallel test workers never share a port).  The
    first failure of any rank is raised here; past ``timeout`` seconds
    every rank is killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    init = Path(work_dir) / "pg_init"
    procs = mp.start_processes(_rank_main, args=(world, str(init), target, args), nprocs=world,
                               join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {target.__name__} ran past {timeout} s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)


def _rank_main(rank: int, world: int, init_file: str, target, args) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _case_ctx(ctxs: dict, case: dict, world: int, dev):
    """The case's sharding context (one per mesh and rules: building one
    is collective, and every rank replays the same cases in order)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import ShardingCtx

    names = tuple(case.get("names", ("data", "model")))
    key = json.dumps([case["mesh"], names, case.get("rules"), case.get("profile", "tp_fsdp")])
    if key not in ctxs:
        mesh = DeviceMesh(dev.type, torch.arange(world).reshape(case["mesh"]),
                          mesh_dim_names=names)
        ctxs[key] = ShardingCtx(mesh=mesh, profile=case.get("profile", "tp_fsdp"),
                                rules=case.get("rules") or {})
    return ctxs[key]


def received_requests_check(sidx, queries, ctx, cap_factor: float) -> dict:
    """Hold this rank's single-table kernel against its twin, and against
    ``searchsorted`` of the padded shard table, on the exact requests the
    a2a exchange delivers to it (fill rows included), before the clamp.
    Returns the request count and the kernel's launches; raises on a
    difference."""
    from repro_torch.dist import collectives
    from repro_torch.dist import sharded_index as tsi

    group, me = ctx.axes_group(ctx.mesh_axes("tp"))
    n = sidx.n_shards
    q = tsi.keymod.as_keys(queries, sidx.device)
    q = torch.cat([q, q.new_full(((-q.numel()) % n,), tsi.PAD_KEY)])
    b_loc = q.numel() // n
    cap = collectives.exchange_capacity(b_loc, n, cap_factor)
    received = tsi.a2a_requests(sidx, q[me * b_loc:(me + 1) * b_loc], cap, group)[0].reshape(-1)
    impl = tix.impls.query_impl(sidx.kind)
    table = sidx.tables[sidx._row(me)]
    args, kwargs = impl.operands(sidx.shard(me), table, received)
    kernels.reset_launches()
    raw = impl.search(*args, **kwargs).long()
    launched = kernels.launches()[KERNEL_OF[sidx.kind]]
    twin = impl.plain(*args, **kwargs).long()
    local = torch.searchsorted(table, received, right=True) - 1
    if not (torch.equal(raw, twin) and torch.equal(raw, local)):
        raise AssertionError(f"rank {me}: {sidx.kind} kernel != twin or searchsorted on its "
                             f"{received.numel()} received requests")
    return {"requests": received.numel(), "launches": launched}


def replay_cases(rank: int, world: int, work_dir: str, device: str) -> None:
    """One rank of a case list (``work_dir/cases.json``): each case builds
    or reuses its mesh's :class:`ShardingCtx`, loads the rank's shard of a
    saved tier, optionally refreshes or rebalances it or inserts key
    batches into its shards (``insert``: one batch a shard, then the listed
    shards compacted, every rank alike under the context), and runs
    ``sharded_lookup``; or, with ``probe``, resolves every logical axis.
    Writes ``out{rank}.npz`` (answers; a refreshed, rebalanced or mutated
    shard's leaves and the tier's vectors) and ``out{rank}.json`` (probes,
    insert reports, request checks, launches of the collective paths)."""
    from repro_torch.core import keys
    from repro_torch.dist import (ShardedIndex, compact_shard, insert_into_shard, rebalance_shards,
                                  refresh_shard, sharded_lookup)
    from repro_torch.index import registry

    work, dev = Path(work_dir), torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    spec = json.loads((work / "cases.json").read_text())
    ctxs, arrays, notes = {}, {}, {}
    for case in spec["cases"]:
        name = case["name"]
        ctx = _case_ctx(ctxs, case, world, dev)
        if "probe" in case:
            notes[name] = {lg: [list(ctx.mesh_axes(lg)), ctx.n(lg), ctx.index(lg)]
                           for lg in case["probe"]}
            continue
        me = ctx.index("tp")
        sidx = ShardedIndex.load(work / case["tier"], device=dev, shard=me)
        if "refresh" in case:
            r = case["refresh"]
            refresh_shard(sidx, r["shard"], tix.Index.load(work / r["index"], device=dev),
                          np.load(work / r["table"]))
        if "rebalance" in case:
            r = case["rebalance"]
            shard_spec = registry.spec_for(r["kind"], **r["params"])
            rebalance_shards(sidx, np.load(work / r["merged"]), np.load(work / r["bounds"]),
                             lambda part: tix.build(shard_spec, part, device=dev))
        if "refresh" in case or "rebalance" in case:
            for k, v in sidx.shard(me).to_numpy().items():
                arrays[f"{name}/idx_{k}"] = v
            arrays[f"{name}/table"] = keys.decode(sidx.tables[0])
            for k in ("fences", "lasts"):
                arrays[f"{name}/{k}"] = keys.decode(getattr(sidx, k))
            for k in ("counts", "offsets"):
                arrays[f"{name}/{k}"] = getattr(sidx, k).cpu().numpy()
        if "insert" in case:  # every rank alike: the holder writes, all update the vectors
            r = case["insert"]
            with np.load(work / r["batches"]) as z:
                batches = [z[f"shard{s}"] for s in range(sidx.n_shards)]
            reports = [dataclasses.astuple(insert_into_shard(sidx, s, b, ctx)[1])
                       for s, b in enumerate(batches)]
            for s in r.get("compact", ()):
                compact_shard(sidx, s, ctx)
            notes[f"{name}/reports"] = reports
            for k, v in sidx.shard(me).to_numpy().items():
                arrays[f"{name}/idx_{k}"] = v
            for k in ("fences", "lasts"):
                arrays[f"{name}/{k}"] = keys.decode(getattr(sidx, k))
            for k in ("counts", "offsets"):
                arrays[f"{name}/{k}"] = getattr(sidx, k).cpu().numpy()
        qs = np.load(work / case["queries"])
        kernels.reset_launches()
        got = sharded_lookup(sidx, qs, ctx, mode=case["mode"], backend=case["backend"],
                             cap_factor=case.get("cap_factor", 2.0))
        launches = kernels.launches()
        arrays[name] = got.cpu().numpy()
        mine = launches.get(KERNEL_OF.get(sidx.kind), 0)  # GAPPED has no kernel
        notes[name] = {"launches": mine, "others": sum(launches.values()) - mine}
        if case.get("check_requests"):
            notes[name].update(received_requests_check(sidx, qs, ctx, case["cap_factor"]))
    np.savez(work / f"out{rank}.npz", **arrays)
    (work / f"out{rank}.json").write_text(json.dumps(notes))


def embedding_rank_cases(rank: int, world: int, work_dir: str, device: str) -> None:
    """One rank of the mega-table lookup cases (``work_dir/emb_cases.json``):
    each case builds or reuses its mesh's :class:`ShardingCtx` and either
    runs ``models.embedding.sharded_lookup`` on this rank's row shard of a
    saved table (``lookup``) or scores a batch with ``recsys.score_fn`` on
    this rank's shard of saved parameters (``score``).  Writes
    ``emb_out{rank}.npz``: every case's ``(B, ...)`` answer."""
    from repro_torch.models import embedding, recsys

    work, dev = Path(work_dir), torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    spec = json.loads((work / "emb_cases.json").read_text())
    with np.load(work / spec["arrays"]) as z:
        data = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
    ctxs, out = {}, {}
    for case in spec["cases"]:
        ctx = _case_ctx(ctxs, case, world, dev)
        if "score" in case:
            s = case["score"]
            cfg = dataclasses.replace(configs.get(s["arch"], reduced=True).config,
                                      lookup_mode=case["mode"])
            params = torch.load(work / s["params"], map_location=dev, weights_only=True)
            batch = {k: data[v] for k, v in s["batch"].items()}
            got = recsys.score_fn(recsys.local_params(params, ctx), batch, cfg, ctx)
        else:
            table = embedding.local_rows(data[case["table"]], ctx)
            got = embedding.sharded_lookup(table, data[case["ids"]], ctx, mode=case["mode"],
                                           cap_factor=case["cap_factor"])
        out[case["name"]] = got.cpu().numpy()
    np.savez(work / f"emb_out{rank}.npz", **out)


def _rank_ctx(case: dict, world: int, dev):
    """The case's context on the first ``prod(case["mesh"])`` ranks of the
    world (None on a rank outside them).  Every rank builds the mesh (its
    groups are collective); a case's rules name one mesh dim a logical
    axis where the mesh is a subset of the world."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import ShardingCtx

    shape = tuple(case["mesh"])
    mesh = DeviceMesh(dev.type, torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=("data", "model"))
    if mesh.get_coordinate() is None:
        return None
    return ShardingCtx(mesh=mesh, profile=case.get("profile", "tp_fsdp"),
                       rules=case.get("rules") or {})


def _case_spec(case: dict):
    """The reduced arch of a step case, with its config overrides."""
    spec = configs.get(case["arch"], reduced=True)
    cfg = dataclasses.replace(spec.config, **case.get("config", {}))
    return dataclasses.replace(spec, config=cfg)


def train_rank_cases(rank: int, world: int, work_dir: str, device: str) -> None:
    """One rank of the training cases over ranks (``work_dir/train_cases.json``),
    each on its context (:func:`_rank_ctx`; a rank outside a case's mesh
    skips it):

    * ``step``: one ``launch.steps.build_step`` step of the case's cell and
      ``TrainConfig`` from the saved state (recsys: this rank's row shard of
      it; a placed LM: this rank's blocks, ``StatePlacement.shard``) on the
      saved global batch; the new state (a placed LM's gathered whole) and
      the metrics;
    * ``lookup``: ``models.embedding.sharded_lookup`` of this rank's row
      shard of a saved table on the saved ids (``local``: this rank's block
      of them, under ``ctx.local_view()``), ``cap_factor`` 4.0, and the
      gradient of ``sum(out * w)`` with respect to the shard;
    * ``restore``: the saved state placed as ``state_shardings`` says on the
      case's mesh (``DTensor`` leaves), saved by ``checkpoint.save``, then
      restored under each mesh of ``restore_meshes``: every leaf's local
      shape, and whether its ``full_tensor()`` is bit-equal to the saved one.

    A recsys step's lookups run at ``cap_factor`` 4.0 (nothing drops on 4
    ranks).  Writes ``train_out{rank}.pt``."""
    import functools

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist.sharding import StatePlacement
    from repro_torch.launch import steps
    from repro_torch.models import embedding, recsys
    from repro_torch.train import TrainConfig, checkpoint

    import os

    work, dev = Path(work_dir), torch.device(device)
    if dev.type == "cuda":  # cuBLAS is deterministic only with this workspace config
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.cuda.set_device(0)
    else:  # the ranks share the host's cores
        torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    spec_list = json.loads((work / "train_cases.json").read_text())
    lookup = recsys.sharded_lookup
    recsys.sharded_lookup = functools.partial(lookup, cap_factor=4.0)
    out = {}
    try:
        for case in spec_list:
            ctx = _rank_ctx(case, world, dev)
            if ctx is None:
                dist.barrier()
                continue
            data = torch.load(work / case["inputs"], map_location=dev, weights_only=True)
            if case["kind"] == "step":
                data = {"state": tree.tree_map(lambda t: t.to(dev), data["state"]),
                        "batch": {k: v.to(dev) for k, v in data["batch"].items()}}
                spec = _case_spec(case)
                cell = next(c for c in spec.shapes if c.name == case["cell"])
                bundle = steps.build_step(spec, cell, ctx, TrainConfig(**case["tcfg"]))
                state = data["state"]
                if spec.family == "recsys":
                    state = dict(state, params=recsys.local_params(state["params"], ctx))
                    state = tree.tree_map(lambda t: t.clone(), state)
                    state["opt"] = {k: (recsys.local_params(v, ctx) if k in ("m", "v") else v)
                                    for k, v in state["opt"].items()}
                    if "comp_err" in state:
                        state["comp_err"] = recsys.local_params(state["comp_err"], ctx)
                placement = None
                if getattr(bundle.init_fn, "whole", None) is not None:  # a placed LM
                    placement = StatePlacement(ctx, "lm", state)
                    state = placement.shard(state)
                new, metrics = bundle.fn(state, data["batch"])
                if placement is not None:  # the whole state, gathered over the mesh
                    new = placement.gather(new)
                out[case["name"]] = {"state": tree.tree_map(lambda t: t.cpu(), new),
                                     "metrics": {k: float(v) for k, v in metrics.items()}}
            elif case["kind"] == "lookup":
                shard = embedding.local_rows(data["table"], ctx).detach().clone()
                shard.requires_grad_(True)
                ids, w = data["ids"], data["w"]
                view = ctx
                if case["local"]:
                    b = ids.shape[0] // ctx.n("row")
                    me = ctx.index("row")
                    ids, w, view = ids[me * b:(me + 1) * b], w[me * b:(me + 1) * b], ctx.local_view()
                got = embedding.sharded_lookup(shard, ids, view, mode=case["mode"], cap_factor=4.0)
                (grad,) = torch.autograd.grad((got * w).sum(), shard)
                out[case["name"]] = {"out": got.detach().cpu(), "grad": grad.cpu()}
            else:  # restore
                out[case["name"]] = _restore_case(case, world, data["state"], work, dev)
            dist.barrier()
    finally:
        recsys.sharded_lookup = lookup
    torch.save(out, work / f"train_out{rank}.pt")


def _restore_case(case: dict, world: int, state, work: Path, dev) -> dict:
    """The restore case on this rank: ``state`` placed as
    ``state_shardings`` says over the case's mesh on the host (gloo cannot
    gather a ``DTensor`` held on the card: its ``all_gather_into_tensor``
    of CUDA tensors crashed a rank), saved, and restored under each mesh of
    ``restore_meshes``: on the host, each leaf's local shape and whether its
    ``full_tensor()`` is bit-equal to the saved leaf; and, on the card,
    whether each local block is bit-equal to the saved leaf's block."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.train import checkpoint

    host = torch.device("cpu")
    state = tree.tree_map(lambda t: t.cpu(), state)
    ctx = _rank_ctx(case, world, host)
    shard = steps.fit_tree(state, steps.state_shardings(state, "lm", ctx), ctx.mesh)
    coord = ctx.coordinate()
    placed = tree.unflatten(state, [
        _dtensor(s.local_block(t, coord).contiguous(), s, t)
        for t, s in zip(tree.leaves(state), tree.flatten_up_to(state, shard))])
    checkpoint.save(work / "ckpt", placed, 1).join(timeout=120)
    dist.barrier()
    shapes, same, on_dev = {}, {}, {}
    for m in case["restore_meshes"]:
        key = "x".join(map(str, m))
        for where in {host, dev}:
            rctx = _rank_ctx(dict(case, mesh=m), world, where)
            rshard = steps.fit_tree(state, steps.state_shardings(state, "lm", rctx), rctx.mesh)
            got, _ = checkpoint.restore(work / "ckpt", state, shardings=rshard)
            if where == host:
                shapes[key] = [list(t.to_local().shape) for t in tree.leaves(got)]
                same[key] = [bool(torch.equal(t.full_tensor(), w))
                             for t, w in zip(tree.leaves(got), tree.leaves(state))]
            if where == dev:
                c = rctx.coordinate()
                on_dev[key] = [t.to_local().device.type == dev.type and bool(torch.equal(
                    t.to_local().cpu(), s.local_block(w, c)))
                    for t, w, s in zip(tree.leaves(got), tree.leaves(state),
                                       tree.flatten_up_to(state, rshard))]
    return {"shapes": shapes, "same": same, "on_device": on_dev}


def _dtensor(local, sharding, whole):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def placed_grads(loss_fn, params, batch, ctx, plan):
    """The loss and the global gradient of a placed LM on this rank, as
    ``make_train_step`` forms them: this rank's ``dp`` slice in the local
    view (the global view when it does not divide), each block's gradient
    summed over the ``dp`` axes that do not split it and divided by
    ``n(dp)``; the loss the ``dp`` mean."""
    from repro_torch import tree
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import split_axes
    from repro_torch.train.step import local_batch, value_and_grad

    mine = local_batch(batch, ctx, "lm")
    view = ctx.local_view() if mine is not batch else ctx
    loss, grads = value_and_grad(lambda p, b: loss_fn(p, b, view), params, mine)
    dp, n = ctx.mesh_axes("dp"), ctx.n("dp")
    out = [collectives.psum_if_mapped(g, tuple(a for a in dp if a not in split_axes(
        pl.sharding)), ctx) / n for g, pl in zip(tree.leaves(grads), tree.leaves(plan))]
    return collectives.psum_if_mapped(loss, dp, ctx) / n, tree.unflatten(grads, out)


def placed_rank_cases(rank: int, world: int, work_dir: str, device: str) -> None:
    """One rank of the placed-LM cases (``work_dir/placed_cases.json``),
    each on its mesh (:func:`_rank_ctx`, ``tp_fsdp``):

    * ``step``: the saved whole state placed (``StatePlacement.shard``) and
      one ``build_step`` train step of the case's arch, config and
      ``TrainConfig`` on the saved global batch; the new state gathered
      whole, the metrics, and the loss and global gradient of the placed
      loss (:func:`placed_grads`), gathered whole;
    * ``roundtrip``: the saved state (tensors, and numpy leaves) placed and
      gathered back: bit-equal or not; and whether no split leaf's block
      is its whole;
    * ``ckpt``: the saved state placed, checkpointed (gathered on the host,
      rank 0 writes), then restored with the placement of each mesh of
      ``restore_meshes``: whether every block is bit-equal to the saved
      whole leaf's block there.

    Writes ``placed_out{rank}.pt``."""
    import os

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist.sharding import StatePlacement
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.train import TrainConfig, checkpoint, init_train_state

    work, dev = Path(work_dir), torch.device(device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:  # the ranks share the host's cores
        torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for case in json.loads((work / "placed_cases.json").read_text()):
        ctx = _rank_ctx(dict(case, profile="tp_fsdp"), world, dev)
        if ctx is None:
            dist.barrier()
            continue
        data = torch.load(work / case["inputs"], map_location=dev, weights_only=True)
        spec = _case_spec(case)
        cell = next(c for c in spec.shapes if c.kind == "train")
        tcfg = TrainConfig(**case.get("tcfg", {}))
        bundle = steps.build_step(spec, cell, ctx, tcfg)
        whole = init_train_state(None, lambda _: bundle.init_fn.whole, tcfg)
        placement = StatePlacement(ctx, "lm", whole)
        state = data["state"]
        if case["kind"] == "step":
            local = placement.shard(state)
            new, metrics = bundle.fn(local, data["batch"])
            plan = transformer.placement(spec.config, ctx)
            loss, grads = placed_grads(
                lambda p, b, v: transformer.loss_fn(p, b, spec.config, v), local["params"],
                data["batch"], ctx, plan)
            pwhole = StatePlacement(ctx, "lm", whole["params"])
            out[case["name"]] = {"state": placement.gather(new),
                                 "metrics": {k: float(v) for k, v in metrics.items()},
                                 "loss": float(loss), "grads": pwhole.gather(grads),
                                 "local_bytes": sum(t.numel() * t.element_size()
                                                    for t in tree.leaves(local)),
                                 "shapes": [list(t.shape) for t in tree.leaves(local)]}
        elif case["kind"] == "roundtrip":
            local = placement.shard(state)
            as_np = tree.unflatten(state, [t.cpu().numpy() if t.dtype != torch.bfloat16 else t
                                           for t in tree.leaves(state)])
            local_np = placement.shard(as_np, device=dev)
            back = placement.gather(local)
            split = [any(a for _, a in pl.dims) for pl in tree.leaves(
                transformer.placement(spec.config, ctx))]
            out[case["name"]] = {
                "same": all(torch.equal(a, b.cpu()) for a, b in zip(tree.leaves(back),
                                                                    tree.leaves(state))),
                "same_np": all(torch.equal(a, b) for a, b in zip(tree.leaves(local_np),
                                                                 tree.leaves(local))),
                "no_whole": all(tuple(t.shape) != tuple(w.shape) for t, w, sp in zip(
                    tree.leaves(local["params"]), tree.leaves(state["params"]), split) if sp),
                "n_split": sum(split)}
        else:  # ckpt
            ckpt = work / case["name"]
            checkpoint.save(ckpt, placement.shard(state), 1, placement=placement).join(
                timeout=120)
            dist.barrier()
            same = {}
            for m in case["restore_meshes"]:
                rctx = _rank_ctx(dict(case, mesh=m, profile="tp_fsdp"), world, dev)
                key = "x".join(map(str, m))
                if rctx is None:
                    same[key] = None
                    continue
                rplace = StatePlacement(rctx, "lm", whole)
                want = rplace.shard(state)
                got, _ = checkpoint.restore(ckpt, want, placement=rplace)
                same[key] = all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                                  tree.leaves(want)))
            out[case["name"]] = {"same": same}
        dist.barrier()
    torch.save(out, work / f"placed_out{rank}.pt")


def decode_rank_cases(rank: int, world: int, work_dir: str, device: str) -> None:
    """One rank of the placed-decode cases (``work_dir/decode_cases.json``),
    each on a (2, 2) ``tp_fsdp`` mesh with the case's rules (``seqm`` or
    ``sp`` named for the sequence-split layouts):

    * ``steps``: the saved whole parameters and cache placed
      (``shard_state``, ``transformer.shard_cache``), then ``steps``
      placed ``decode_step`` calls on the saved global tokens at ``pos0``,
      ``pos0 + 1``, ...: each step's logits, the cache block after them,
      its shape, and the whole cache gathered back
      (``transformer.gather_cache``);
    * ``engine``: ``DecodeEngine(ctx=...)`` on the placed parameters,
      serving the saved requests: their tokens, and the engine's counters.

    Writes ``decode_out{rank}.pt``."""
    from repro_torch.dist.sharding import _rules_for, shard_state
    from repro_torch.models import transformer

    work, dev = Path(work_dir), torch.device(device)
    torch.set_num_threads(1)
    out = {}
    for case in json.loads((work / "decode_cases.json").read_text()):
        rules = dict(_rules_for("tp_fsdp", ("data", "model")), **case["rules"])
        ctx = _rank_ctx({"mesh": case["mesh"], "rules": rules}, world, dev)
        data = torch.load(work / f"{case['name']}.pt", map_location=dev, weights_only=True)
        cfg = _case_spec(case).config
        params = shard_state(data["params"], ctx, "lm")
        if case["kind"] == "steps":
            cache = transformer.shard_cache(data["cache"], cfg, ctx, case["seq_shard"])
            logits = []
            for i, toks in enumerate(data["tokens"]):
                lg, cache = transformer.decode_step(params, cache, toks, case["pos0"] + i, cfg,
                                                    ctx, seq_shard=case["seq_shard"])
                logits.append(lg)
            b, s = data["cache"]["k"].shape[1:3]
            out[case["name"]] = {"logits": torch.stack(logits), "cache": cache,
                                 "shape": list(cache["k"].shape), "coord": list(ctx.coordinate()),
                                 "whole": transformer.gather_cache(cache, cfg, ctx, b, s,
                                                                   case["seq_shard"])}
        else:
            eng = DecodeEngine(params, cfg, ctx=ctx, batch_slots=case["slots"],
                               max_seq=case["max_seq"])
            reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=case["max_new"])
                    for i, p in enumerate(case["prompts"])]
            for r in reqs:
                eng.submit(r)
            ticks = eng.run_until_drained()
            out[case["name"]] = {"tokens": [r.out_tokens for r in reqs], "ticks": ticks,
                                 "shape": list(eng.cache["k"].shape)}
    torch.save(out, work / f"decode_out{rank}.pt")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("a2a", "allgather"))
def test_collective_modes_two_ranks_on_card(cuda, tmp_path, mode):
    """Two gloo ranks on the one card, one shard each: ``sharded_lookup``
    in ``mode`` on ``backend="kernel"`` equals ``torch.searchsorted`` on
    the whole table for the headline kind of each single-table kernel,
    launches that kernel on every rank and nothing else, and (a2a) the
    kernel equals its twin on each rank's received requests."""
    from repro_torch.core import keys
    from repro_torch.dist import ShardedIndex

    rng = np.random.default_rng(64)
    table = _table(rng, "lognormal", 40000)
    qs = _queries(rng, table)[:-1]  # an odd batch: the a2a path pads it
    np.save(tmp_path / "qs.npy", qs)
    cases = []
    for kind in ("SY-RMI", "PGM_M", "RS", "KO"):
        ShardedIndex.build(kind, table, 2, device="cpu").save(tmp_path / f"{kind}.npz")
        cases.append({"name": kind, "tier": f"{kind}.npz", "queries": "qs.npy", "mesh": [1, 2],
                      "mode": mode, "backend": "kernel", "cap_factor": 2.0,
                      "check_requests": mode == "a2a"})
    (tmp_path / "cases.json").write_text(json.dumps({"cases": cases}))
    run_ranks(replay_cases, 2, tmp_path, str(tmp_path), "cuda")
    t = keys.encode(table, cuda)
    want = (torch.searchsorted(t, keys.encode(qs, cuda), right=True) - 1).cpu().numpy()
    for rank in range(2):
        notes = json.loads((tmp_path / f"out{rank}.json").read_text())
        with np.load(tmp_path / f"out{rank}.npz") as out:
            for case in cases:
                np.testing.assert_array_equal(out[case["name"]], want, err_msg=case["name"])
                note = notes[case["name"]]
                assert note["launches"] == 1 and note["others"] == 0, (case["name"], note)
                if mode == "a2a":  # every slot of the (2, cap) requests, cap = half the batch
                    assert note["requests"] == len(qs) + 1, (case["name"], note)


# -- GAPPED, the updatable kind: no kernel, tensor ops on the card ----------------------


def fresh_keys(rng, table, n: int) -> np.ndarray:
    """Up to ``n`` keys absent from the sorted ``table``: midpoints of
    random gaps of two or more."""
    i = rng.choice(len(table) - 1, min(n, len(table) - 1), replace=False)
    gap = table[i + 1] - table[i]
    i, gap = i[gap >= 2], gap[gap >= 2]
    return np.unique(table[i] + gap // np.uint64(2))


def packed_batch(index, live, extra: int) -> np.ndarray:
    """Fresh keys packed into the widest key range of one leaf of a GAPPED
    index (not its last), ``extra`` more than the leaf's free slots: the
    leaf absorbs all or nothing, so the batch overflows into the delta."""
    from repro_torch.core import keys

    a = index.arrays
    counts = a["counts"].cpu().numpy()
    lo, hi = keys.decode(a["fences"]), keys.decode(a["route"])
    width = np.where((counts > 0) & (hi != np.uint64(2**64 - 1)), hi - lo, 0)
    leaf = int(np.argmax(width))
    k = int(a["keys"].shape[1]) - int(counts[leaf]) + extra
    step = (hi[leaf] - lo[leaf] - np.uint64(1)) // np.uint64(k + 1)
    assert step >= 1, "no leaf range wide enough"
    return np.setdiff1d(lo[leaf] + np.uint64(1) + np.arange(k, dtype=np.uint64) * step, live)


def _same_leaves(a, b) -> bool:
    x, y = a.to_numpy(), b.to_numpy()
    return set(x) == set(y) and all(x[k].tobytes() == y[k].tobytes() for k in x)


@pytest.mark.gpu
def test_gapped_insert_and_compact_on_card(cuda):
    """One table: after every insert batch (fresh keys, duplicates, a batch
    packed into one leaf that overflows into the delta) and the
    compaction, the card's leaves and reports equal the CPU's on the same
    inputs, and ``xla``/``bbs``/``ref`` equal the CPU's ranks and
    ``searchsorted`` over the live keys; ``kernel`` raises, no kernel of
    the port launches."""
    rng = np.random.default_rng(70)
    table = _table(rng, "lognormal", 40000)
    spec = tix.GappedSpec(leaf_cap=64, fill=0.75, delta_cap=256)
    g, twin = tix.build(spec, table, device=cuda), tix.build(spec, table, device="cpu")
    live = table
    kernels.reset_launches()
    for step in range(4):
        if step == 3:
            batch = packed_batch(twin, live, 16)
        else:
            batch = np.concatenate([fresh_keys(rng, table, 300 * 4**step), rng.choice(live, 50)])
        g, rep = g.insert_batch(batch)
        twin, rep_cpu = twin.insert_batch(batch)
        assert dataclasses.astuple(rep) == dataclasses.astuple(rep_cpu)
        assert _same_leaves(g, twin), step
        live = np.union1d(live, batch)
        qs = np.concatenate([_queries(rng, live), batch])
        for backend in ("xla", "bbs", "ref"):
            got = g.lookup(table, qs, backend=backend)
            assert got.device == g.device
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          twin.lookup(table, qs, backend=backend).numpy())
            np.testing.assert_array_equal(got.cpu().numpy(), true_ranks(live, qs), err_msg=backend)
    assert rep.overflowed == len(batch) and int(g.arrays["delta_count"]) == len(batch)
    g, twin = g.compact(), twin.compact()
    assert _same_leaves(g, twin) and int(g.arrays["delta_count"]) == 0
    np.testing.assert_array_equal(g.lookup(table, qs, backend="xla").cpu().numpy(),
                                  true_ranks(live, qs))
    with pytest.raises(ValueError, match="supports backends"):
        g.lookup(table, qs)
    torch.cuda.synchronize()
    assert sum(kernels.launches().values()) == 0


@pytest.mark.gpu
def test_gapped_stack_on_card(cuda):
    """``build_many`` over equal and ragged tables: every backend GAPPED
    claims equals the CPU's stack and each table's ``searchsorted``."""
    rng = np.random.default_rng(71)
    for sizes in ((20000, 20000, 20000), (65536, 5000, 30001)):
        tables = [_table(rng, k, n) for k, n in zip(("clustered", "bursty", "lognormal"), sizes)]
        tables = [t[:min(sizes)] for t in tables] if len(set(sizes)) == 1 else tables
        bm = tune.build_many("GAPPED", tables, device=cuda)
        twin = tune.build_many("GAPPED", tables, device="cpu")
        qs = _queries(rng, np.concatenate(tables))
        for backend in ("xla", "bbs", "ref"):
            got = bm.lookup(qs, backend=backend).cpu().numpy()
            np.testing.assert_array_equal(got, twin.lookup(qs, backend=backend).numpy())
            for i, t in enumerate(tables):
                np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=backend)
        with pytest.raises(ValueError, match="supports backends"):
            bm.lookup(qs)


@pytest.mark.gpu
def test_gapped_tier_mutation_on_card(cuda, tmp_path):
    """A 4-shard GAPPED tier: routed inserts, a batch packed into one leaf
    of shard 2 (its delta populated) and ``compact_shard`` of shard 1 give
    the CPU tier's leaves and vectors, every backend GAPPED claims equals
    ``searchsorted`` over the live keys, and the tier survives ``save`` ->
    ``load`` and ``load(path, shard=s)``."""
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    rng = np.random.default_rng(72)
    table = _table(rng, "lognormal", 40000)
    tiers = [tsi.ShardedIndex.build("GAPPED", table, 4, device=d) for d in (cuda, "cpu")]
    fresh = fresh_keys(rng, table, 4000)
    owners = tsi.route_owners(tiers[1].fences, keys.encode(fresh, "cpu")).numpy()
    live = np.union1d(table, fresh)
    packed = packed_batch(tiers[1].shard(2), live, 8)
    live = np.union1d(live, packed)
    for sidx in tiers:
        for s in range(4):
            tsi.insert_into_shard(sidx, s, fresh[owners == s])
        _, rep = tsi.insert_into_shard(sidx, 2, packed)
        assert rep.overflowed == len(packed)
        tsi.compact_shard(sidx, 1)
    gpu, cpu = tiers
    assert _same_leaves(gpu.index, cpu.index)
    for k in ("fences", "counts", "offsets", "lasts"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    qs = np.concatenate([_queries(rng, live), packed, fresh])
    gpu.save(tmp_path / "t.npz")
    for backend in ("xla", "bbs", "ref"):
        got = tsi.sharded_lookup(gpu, qs, backend=backend).cpu().numpy()
        np.testing.assert_array_equal(got, true_ranks(live, qs), err_msg=backend)
        back = tsi.ShardedIndex.load(tmp_path / "t.npz", device=cuda)
        again = tsi.sharded_lookup(back, qs, backend=backend)
        np.testing.assert_array_equal(again.cpu().numpy(), got)
    for s in range(4):
        one = tsi.ShardedIndex.load(tmp_path / "t.npz", device=cuda, shard=s)
        assert torch.equal(one.lasts, gpu.lasts) and _same_leaves(one.shard(s), gpu.shard(s))


# -- the device fits: the corridor-scan kernel and the programs around it ------------------


def _corridor_rows(rng, n_tables: int, n: int, dev):
    """``(n_tables, n)`` f64 key rows of three table shapes (the third
    with f64 collisions: adjacent keys at 2^60), one ε and one live count
    a row."""
    rows = []
    for i in range(n_tables):
        if i % 3 == 2:
            t = (np.uint64(1) << np.uint64(60)) + np.arange(n, dtype=np.uint64)
        else:
            t = _table(rng, ("uniform", "clustered")[i % 3], 2 * n)
            t = t[np.linspace(0, len(t) - 1, n).astype(np.int64)]
        rows.append(t)
    from repro_torch.core import keys

    stack = keys.to_f64(keys.encode(np.stack(rows), dev))
    eps = torch.tensor([(4.0, 16.0, 64.0)[i % 3] for i in range(n_tables)], dtype=torch.float64,
                       device=dev)
    count = torch.tensor([(n, n // 3, 1)[i % 3] for i in range(n_tables)], device=dev)
    return stack, eps, count


@pytest.mark.gpu
@pytest.mark.parametrize("form", ("exact", "blocked", "block-of-7"))
@pytest.mark.parametrize("recurrence", ("pgm", "rs"))
def test_corridor_scan_matches_twin_on_card(cuda, recurrence, form):
    from repro_torch.kernels.corridor_scan import corridor_scan, corridor_scan_twin

    stack, eps, count = _corridor_rows(np.random.default_rng(80), 6, 4096, cuda)
    length = 4096 if recurrence == "pgm" else 4095
    chunk = {"exact": length, "blocked": 256, "block-of-7": 7}[form]
    for cnt in ((None, count) if recurrence == "pgm" else (None,)):
        kernels.reset_launches()
        got = corridor_scan(stack, eps, recurrence=recurrence, length=length, chunk=chunk,
                            count=cnt)
        torch.cuda.synchronize()
        assert kernels.launches()["corridor_scan"] == 1
        want = corridor_scan_twin(stack, eps, recurrence=recurrence, length=length, chunk=chunk,
                                  count=cnt)
        assert got.dtype == torch.bool and torch.equal(got, want), (recurrence, form)


@pytest.mark.gpu
@pytest.mark.parametrize("recurrence", ("pgm", "rs"))
def test_corridor_scan_past_65535_rows_on_card(cuda, recurrence):
    """2^17 block rows in one launch (the fast fit of a tier has 65,536),
    against the twin."""
    from repro_torch.kernels.corridor_scan import corridor_scan, corridor_scan_twin

    stack, eps, _ = _corridor_rows(np.random.default_rng(81), 2, 1 << 18, cuda)
    length = (1 << 18) - (recurrence == "rs")
    got = corridor_scan(stack, eps, recurrence=recurrence, length=length, chunk=4)
    want = corridor_scan_twin(stack, eps, recurrence=recurrence, length=length, chunk=4)
    assert torch.equal(got, want)


def _exact_on_card(stack, eps, recurrence, length, count, chunk):
    """One ``corridor_scan_exact`` call under ``set_sync_debug_mode("error")``
    (a host sync raises), held to one launch."""
    from repro_torch.kernels.corridor_scan import corridor_scan_exact

    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = corridor_scan_exact(stack, eps, recurrence=recurrence, length=length, count=count,
                                  chunk=chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = kernels.launches()
    assert launches["corridor_scan"] == launches["corridor_scan_exact"] == 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("recurrence", ("pgm", "rs"))
def test_corridor_scan_exact_matches_the_oracle_on_card(cuda, recurrence):
    """The exact form (speculate, correct, resolve in one launch, no host
    sync) against the one-thread oracle (``corridor_scan`` with ``chunk =
    length``) and its twin, on rows of which every third collides in f64
    (a NaN cone from its first keys), with and without a live count, at
    chunks of 1, 7, the default and one past the row."""
    from repro_torch.kernels.corridor_scan import (
        EXACT_CHUNK, corridor_scan, corridor_scan_exact_twin)

    stack, eps, count = _corridor_rows(np.random.default_rng(84), 6, 4096, cuda)
    length = 4096 if recurrence == "pgm" else 4095
    for cnt in (None, count):
        oracle = corridor_scan(stack, eps, recurrence=recurrence, length=length, chunk=length,
                               count=cnt)
        for chunk in (1, 7, EXACT_CHUNK, length + 1):
            got = _exact_on_card(stack, eps, recurrence, length, cnt, chunk)
            assert torch.equal(got, oracle), (cnt is not None, chunk)
        twin = corridor_scan_exact_twin(stack, eps, recurrence=recurrence, length=length,
                                        count=cnt)
        assert torch.equal(twin, oracle)


@pytest.mark.gpu
@pytest.mark.parametrize("recurrence", ("pgm", "rs"))
def test_corridor_scan_exact_on_rows_of_2_to_the_22_on_card(cuda, recurrence):
    """Three rows of 2^22 keys: amzn64 (segments of thousands of keys at
    ε 64), osm at ε 16 (hundreds), and amzn64 whose second half collides
    in f64 (a NaN cone from 2^21 on), whole and with live counts of 2^20 + 5
    and 2^21 + 3: the exact form == the oracle == the twin."""
    from repro_torch.core import keys
    from repro_torch.kernels.corridor_scan import corridor_scan, corridor_scan_exact_twin

    n = 1 << 22
    rows = np.stack([generate("amzn64", n), generate("osm", n), generate("amzn64", n)])
    rows[2, n // 2:] = (np.uint64(1) << np.uint64(60)) + np.arange(n // 2, dtype=np.uint64)
    stack = keys.to_f64(keys.encode(rows, cuda))
    eps = torch.tensor([64.0, 16.0, 64.0], dtype=torch.float64, device=cuda)
    length = n if recurrence == "pgm" else n - 1
    for cnt in (None, torch.tensor([n, (1 << 20) + 5, (1 << 21) + 3], device=cuda)):
        got = _exact_on_card(stack, eps, recurrence, length, cnt, 256)
        oracle = corridor_scan(stack, eps, recurrence=recurrence, length=length, chunk=length,
                               count=cnt)
        assert torch.equal(got, oracle), cnt is not None
        twin = corridor_scan_exact_twin(stack, eps, recurrence=recurrence, length=length,
                                        count=cnt)
        assert torch.equal(twin, oracle), cnt is not None


@pytest.mark.gpu
@pytest.mark.parametrize("kind,fit", [(k, "vmap") for k in ("RMI", "SY-RMI", "PGM", "PGM_M", "RS")]
                         + [(k, "fast") for k in ("PGM", "PGM_M", "RS")])
def test_device_fits_on_card(cuda, kind, fit):
    """``build_many``'s device fits on the card give the CPU's leaves (RMI:
    the host build's too, and two builds agree: the sorted-segment sums
    are deterministic) and exact ranks; one corridor launch a batch for
    PGM and RS (PGM_M: one a bisection step)."""
    rng = np.random.default_rng(82)
    tables = [_table(rng, k, 65536) for k in ("uniform", "clustered", "bursty")]
    tables = [t[:min(len(t) for t in tables)] for t in tables]
    kernels.reset_launches()
    gpu = tune.build_many(kind, tables, fit=fit, device=cuda)
    launches = kernels.launches()["corridor_scan"]
    if kind in ("PGM", "RS"):
        assert launches == 1
    cpu = tune.build_many(kind, tables, fit=fit, device="cpu")
    if kind in ("RMI", "SY-RMI"):
        assert launches == 0
        again = tune.build_many(kind, tables, fit=fit, device=cuda)
        assert _same_leaves(gpu.index, again.index)
        host = tune.build_many(kind, tables, device="cpu")
        assert np.array_equal(gpu.index.to_numpy()["leaf_r"], host.index.to_numpy()["leaf_r"])
    else:
        assert _same_leaves(gpu.index, cpu.index)
    qs = _queries(rng, np.concatenate(tables))
    got = gpu.lookup(qs, backend="kernel").cpu().numpy()
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=f"{kind}/{i}")


@pytest.mark.gpu
@pytest.mark.parametrize("fit", ("fast", "scan"))
@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_device_refresh_on_card(cuda, kind, fit):
    """The refresh program runs under ``torch.cuda.set_sync_debug_mode
    ("error")`` after the merged row's copy (no host sync), installs the
    CPU program's leaves bit for bit, serves the merged keys exactly, and
    a refused refresh (the row crosses the next fence) changes nothing."""
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    rng = np.random.default_rng(83)
    table = generate("osm", 1 << 16)
    held = rng.choice(np.arange((1 << 14) + 8, (1 << 15) - 8), 512, replace=False)
    base = np.delete(table, held)
    bounds = [0, 1 << 14, (1 << 15) - 512, (3 << 14) - 512, len(base)]
    eps = 64 if kind == "PGM" else 32
    tiers = [tsi.ShardedIndex.build(kind, base, 4, bounds=bounds, device=d) for d in (cuda, "cpu")]
    merged = table[1 << 14:1 << 15]
    row = keys.encode(merged, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, ok = tune.device_refresh(tiers[0], 1, row, eps, fit=fit)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _, ok_cpu = tune.device_refresh(tiers[1], 1, merged, eps, fit=fit)
    assert bool(ok) == bool(ok_cpu)
    if fit == "scan":
        assert bool(ok)
    assert _same_leaves(tiers[0].index, tiers[1].index)
    for k in ("tables", "fences", "counts", "offsets", "lasts"):
        assert torch.equal(getattr(tiers[0], k).cpu(), getattr(tiers[1], k)), k
    live = table if bool(ok) else base
    qs = _queries(rng, live)
    got = tsi.sharded_lookup(tiers[0], qs, backend="kernel").cpu().numpy()
    np.testing.assert_array_equal(got, true_ranks(live, qs))
    before = {k: v.clone() for k, v in tiers[0].index.arrays.items()}
    state = [getattr(tiers[0], k).clone() for k in ("tables", "fences", "counts", "offsets",
                                                     "lasts")]
    crossing = np.append(merged[1:], keys.decode(tiers[0].fences[2:3]))
    _, ok = tune.device_refresh(tiers[0], 1, crossing, eps, fit=fit)
    assert not bool(ok)
    assert all(torch.equal(before[k], v) for k, v in tiers[0].index.arrays.items())
    assert all(torch.equal(a, getattr(tiers[0], k)) for a, k in zip(
        state, ("tables", "fences", "counts", "offsets", "lasts")))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_device_refresh_fast_installs_on_card(cuda, kind):
    """A tier whose shard 0 holds 1.5 times shard 1's keys has leaf rows
    with room for the fast fit: the fast refresh installs on the card
    under the sync debug mode, every check passes, the leaves equal the
    CPU program's and the tier serves the merged keys exactly."""
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    rng = np.random.default_rng(84)
    table = generate("osm", 1 << 16)
    q = 1 << 14
    held = rng.choice(np.arange(3 * q // 2 + 8, 5 * q // 2 - 8), 512, replace=False)
    base = np.delete(table, held)
    bounds = [0, 3 * q // 2, 5 * q // 2 - 512, 13 * q // 4 - 512, len(base)]
    eps = 64 if kind == "PGM" else 32
    tiers = [tsi.ShardedIndex.build(kind, base, 4, bounds=bounds, device=d) for d in (cuda, "cpu")]
    merged = table[3 * q // 2:5 * q // 2]
    row = keys.encode(merged, cuda)
    checks = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, ok = tune.device_refresh(tiers[0], 1, row, eps, fit="fast", checks=checks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(ok) and all(bool(v) for v in checks.values()), checks
    _, ok_cpu = tune.device_refresh(tiers[1], 1, merged, eps, fit="fast")
    assert bool(ok_cpu) and _same_leaves(tiers[0].index, tiers[1].index)
    qs = _queries(rng, table)
    got = tsi.sharded_lookup(tiers[0], qs, backend="kernel").cpu().numpy()
    np.testing.assert_array_equal(got, true_ranks(table, qs))


# ---------------------------------------------------------------------------
# The tuner and the tier's telemetry on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_sweep_on_card(cuda):
    """Every candidate of the 2^16-key grid is exact on ``kernel`` and the
    frontier is strictly monotone; every budget pick fits its budget."""
    table = generate("amzn64", 1 << 16)
    cands = tune.sweep(table, n_queries=1 << 14, reps=2, check_exact=True, device=cuda)
    assert [c.spec.display_name() for c in cands] == [
        s.display_name() for s in tune.candidate_grid(len(table)) if s.kind != "GAPPED"]
    assert all(c.exact for c in cands), [c.spec.display_name() for c in cands if not c.exact]
    front = tune.pareto_frontier(cands)
    spaces, times = [c.space_bytes for c in front], [c.ns_per_query for c in front]
    assert spaces == sorted(set(spaces)) and all(a > b for a, b in zip(times, times[1:]))
    for pct in (0.05, 0.7, 2.0, 10.0):
        best = tune.best_candidate_for_budget(cands, len(table), pct)
        assert best is not None and best.space_bytes <= pct / 100.0 * len(table) * 8


@pytest.mark.gpu
def test_tuned_tier_device_refresh_on_card(cuda):
    """A PGM tier's refresh through the device arm (``scan``) installs on
    the card, counts one ``ok`` outcome and serves the merged keys exactly."""
    from repro_torch import obs

    rng = np.random.default_rng(85)
    table = generate("osm", 1 << 16)
    held = rng.choice(np.arange((1 << 14) + 8, (1 << 15) - 8), 400, replace=False)
    base = np.delete(table, held)
    tier = tune.TunedTier(base, 4, tune.RebuildPolicy(shard_refresh_frac=0.005, retune_frac=10.0,
                                                      device_refresh=True, device_fit="scan"),
                          spec=tix.PGMSpec(eps=64), name="gpu_device_refresh", device=cuda)
    before = obs.metric("device_refreshes").value(kind="PGM", outcome="ok")
    fresh = np.sort(table[held])
    owners = tier._owners(fresh)
    s = int(np.bincount(owners).argmax())
    room = int(tier.sidx.tables.shape[1]) - int(tier.sidx.counts[s])
    batch = fresh[owners == s][:room]  # past 0.005 of the shard, within its padded row
    assert len(batch) >= 0.005 * int(tier.sidx.counts[s])
    tier.insert_batch(batch)
    live = np.union1d(base, batch)
    assert obs.metric("device_refreshes").value(kind="PGM", outcome="ok") - before == 1
    assert tier.counters.shard_refreshes == 1 and tier.counters.pending == 0
    qs = _queries(rng, live)
    np.testing.assert_array_equal(tier.lookup(qs).cpu().numpy(), true_ranks(live, qs))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("SY-RMI", "PGM", "RS", "KO"))
def test_telemetry_adds_no_search_launch_on_card(cuda, kind):
    """A telemetry-on ``sharded_lookup`` launches the kind's batched kernel
    once, as a telemetry-off call does, gives the same ranks, and its
    counters equal a host model of the owner histogram."""
    from repro_torch.dist import sharded_index as tsi

    rng = np.random.default_rng(86)
    table = generate("amzn64", 1 << 16)
    sidx = tsi.ShardedIndex.build(kind, table, 4, device=cuda)
    qs = np.concatenate([rng.choice(table[: 1 << 14], 3000), rng.choice(table, 1000)])
    kernels.reset_launches()
    off = tsi.sharded_lookup(sidx, qs, backend="kernel").cpu().numpy()
    off_launches = kernels.launches()
    kernels.reset_launches()
    tsi.reset_tier_metrics()
    sink = tsi._fresh_tier_metrics()
    on = tsi.sharded_lookup(sidx, qs, backend="kernel", telemetry=True, telemetry_sink=sink,
                            telemetry_label="gpu_telemetry").cpu().numpy()
    assert kernels.launches() == off_launches
    assert sum(off_launches.values()) == 1
    np.testing.assert_array_equal(on, off)
    fences = np.asarray([table[i * (1 << 14)] for i in range(4)], dtype=np.uint64)
    hist = np.bincount(np.searchsorted(fences[1:], qs, side="right"), minlength=4)
    even = len(qs) / 4
    want = {"lookups": 1, "queries": len(qs), "dropped": 0, "routed_max": int(hist.max()),
            "routed_even": even, "imbalance_last": hist.max() / even,
            "imbalance_peak": hist.max() / even}
    assert sink == want
    assert tsi._tier_counters_from_obs("gpu_telemetry") == want
    np.testing.assert_array_equal(tsi.shard_query_weights("gpu_telemetry", 4), hist)


#: cycles the stream spins before the timed lookup (~20 ms on an H100)
SLEEP_CYCLES = 40_000_000


class _SpinThenLookup:
    """An index whose lookup first holds its stream (``torch.cuda._sleep``)
    and brackets the whole call in CUDA events: the card's time of each
    call, against which ``timed_lookup``'s phases are held."""

    kind = "SY-RMI"

    def __init__(self, idx):
        self.idx, self.events = idx, []

    def lookup(self, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        out = self.idx.lookup(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out


@pytest.mark.gpu
def test_timed_lookup_device_phase_on_card(cuda):
    """``timed_lookup`` on the card: the host phase ends while the card is
    still busy, and the device phase (after the sync) covers the card's
    time of the call, measured with CUDA events; one labelset each."""
    from repro_torch import obs
    from repro_torch.core import keys

    table = generate("amzn64", 1 << 20)
    qs = np.random.default_rng(87).choice(table, 1 << 20)
    idx = tix.build(tix.SYRMISpec(), table, device=cuda)
    t_dev, q_dev = keys.encode(table, cuda), keys.encode(qs, cuda)
    idx.lookup(t_dev, q_dev)  # the first call's preparation is not timed
    torch.cuda.synchronize(cuda)
    target, reg = _SpinThenLookup(idx), obs.Registry()
    for _ in range(3):
        out = obs.timed_lookup(target, t_dev, q_dev, tier="gpu", registry=reg)
    np.testing.assert_array_equal(out.cpu().numpy(), true_ranks(table, qs))
    card_us = sum(a.elapsed_time(b) for a, b in target.events) * 1e3
    snap = reg.snapshot()
    lab = dict(kind="SY-RMI", backend="kernel", tier="gpu")
    host = obs.find_sample(snap, "lookup_latency_us", **lab, phase="host")
    dev = obs.find_sample(snap, "lookup_latency_us", **lab, phase="device")
    assert host["count"] == dev["count"] == 3
    assert 0.0 < host["sum"] < card_us <= dev["sum"]


# -- the serving layer: the hot-key cache, MoE decode, group-1 attention ---------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("uniform", "flip"))
def test_hotcache_probe_on_card_equals_cpu(cuda, case):
    """The probe's ``(hit, rank)`` on the card equal the CPU's: one uint64 ->
    f64 conversion, a product and a sum with no fused multiply-add, then
    integer search."""
    from repro_torch.core import keys
    from repro_torch.serve import hotcache

    rng = np.random.default_rng(90)
    if case == "uniform":
        hot = as_table(rng.integers(1, 2**61, 3000, dtype=np.uint64))
    else:  # both sides of 2^63
        hot = as_table(np.uint64(2**63) + rng.integers(-2**40, 2**40, 3000).astype(np.int64)
                       .astype(np.uint64))
    cap = 4096
    padded = np.full(cap, np.iinfo(np.uint64).max, np.uint64)
    padded[: len(hot)] = hot
    ranks = np.arange(cap, dtype=np.int64) * 5 - 1
    q = np.concatenate([hot, hot + np.uint64(1), hot - np.uint64(1),
                        rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64)])
    model = hotcache._fit(hot, cap)
    out = []
    for dev in (torch.device("cpu"), cuda):
        hit, rank = hotcache._probe(keys.encode(padded, dev), torch.from_numpy(ranks).to(dev),
                                    hotcache._model_tensors(model, dev), len(hot),
                                    keys.encode(q, dev), steps=12)
        out.append((hit.cpu().numpy(), rank.cpu().numpy()))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_array_equal(out[1][0], np.isin(q, hot))


@pytest.mark.gpu
def test_hotcache_over_kernel_tier_stays_exact_on_card(cuda):
    """A 4-shard SY-RMI tier on ``kernel`` behind a ``HotKeyCache``: hits,
    misses through the batched kernel, an insert (buffered, then a shard
    refresh), the stale rebuild through the batched kernel; every answer
    equals ``searchsorted`` on the live keys."""
    from repro_torch.serve import HotKeyCache

    rng = np.random.default_rng(91)
    full = generate("amzn64", 1 << 16)
    held = full[1::64]
    base = np.setdiff1d(full, held)
    tier = tune.TunedTier(base, 4, tune.RebuildPolicy(shard_refresh_frac=0.001, retune_frac=10.0),
                          spec=tix.SYRMISpec(), name="gpu_hotcache", device=cuda)
    cache = HotKeyCache(tier, capacity=1024)
    hot = base[(1 << 13) + np.arange(512)]
    cache.sketch.update(hot, weight=8.0)
    kernels.reset_launches()
    cache.rebuild()
    assert kernels.launches()["batched_rmi_search"] == 1 and cache.n_hot == 512
    live = base
    for step in range(3):
        qs = np.concatenate([rng.choice(hot, 3000), rng.choice(live, 1000),
                             rng.integers(0, 2**64 - 1, 96, dtype=np.uint64)])
        got = cache.lookup(qs)
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy(), true_ranks(live, qs))
        if step == 0:
            cache.insert_batch(held)
            live = full
            assert tier.counters.shard_refreshes + tier.counters.forced_restacks >= 1
            assert cache.stale()
    m = cache.metrics()["hotcache"]
    assert m["stale_detected"] == 1 and m["rebuilds"] == 2 and m["hits"] >= 6000


def _tiny_moe(arch):
    return dataclasses.replace(configs.get(arch, reduced=True).config, dtype="float32")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"))
def test_moe_decode_step_kernel_matches_ref_on_card(cuda, monkeypatch, arch):
    """A 2-layer reduced MoE model in f32: the kernel's logits against the
    reference math over 6 positions from equal caches (2e-5)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _tiny_moe(arch)
    params = transformer.init(torch.Generator(device=cuda).manual_seed(2), cfg)
    caches = [transformer.init_cache(cfg, 8, 40, device=cuda) for _ in range(2)]
    rng = np.random.default_rng(92)
    kernels.reset_launches()
    for pos in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1)).astype(np.int32)).to(cuda)
        got, caches[0] = transformer.decode_step(params, caches[0], tok, pos, cfg, backend="kernel")
        want, caches[1] = transformer.decode_step(params, caches[1], tok, pos, cfg, backend="ref")
        caches[1] = {kv: c.clone() for kv, c in caches[0].items()}
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=2e-5)
    assert kernels.launches()["decode_attention"] == 6 * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_decode_attention_group_one_on_card(cuda, dtype):
    """moonshot-v1-16b-a3b's attention: 16 query heads on 16 KV heads
    (group 1), head dim 128, 8 rows of a 2,048-position cache.  bf16 takes
    the tensor-core kernel (16-position tiles); the split plan gives the
    128 (row, KV head) pairs 16 shares."""
    rng = np.random.default_rng(93)
    q, k, v = _attention_inputs(rng, 8, 16, 16, 128, 2048, dtype, cuda)
    kv_len = torch.tensor([1, 15, 16, 17, 300, 1024, 2047, 2048], dtype=torch.int32, device=cuda)
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile, n_split = split_plan(8, 16, 128, 2048, q.element_size(), sm)
    assert tile == (att.MMA_TILE if dtype == torch.bfloat16 else 16)
    assert n_split == min(att.MAX_SPLIT, -(-att.BLOCKS_PER_SM * sm // 128))
    kernels.reset_launches()
    got = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert kernels.launches()["decode_attention"] == 1
    atol, rtol = ATT_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               _decode_body(q, k, v, kv_len).float().cpu().numpy(),
                               rtol=rtol, atol=atol)


# -- the serving cells of the recsys and prefill slice ------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", (1, 4))
def test_learned_keyed_embedding_kernel_on_card(cuda, n_shards):
    """``LearnedKeyedEmbedding.lookup(backend="kernel")`` on the card: one
    ``rmi_search`` launch (one index) or one ``batched_rmi_search`` launch
    (a 4-shard tier), nothing else; ranks equal ``"ref"`` and
    ``torch.searchsorted``, each vector its key's row, absent ids the OOV
    row."""
    from repro_torch.core import keys as keymod
    from repro_torch.models.embedding import LearnedKeyedEmbedding

    rng = np.random.default_rng(120)
    raw = rng.integers(0, 2**64 - 1, 200_000, dtype=np.uint64)
    lke = LearnedKeyedEmbedding.build(raw, 18, n_shards=n_shards, device=cuda)
    keys = keymod.decode(lke.keys)
    queries = np.concatenate([rng.choice(keys, 30000), rng.integers(0, 2**64 - 1, 10000,
                                                                     dtype=np.uint64)])
    kernels.reset_launches()
    got = lke.lookup(queries)
    torch.cuda.synchronize()
    launches = kernels.launches()
    name = "rmi_search" if n_shards == 1 else "batched_rmi_search"
    assert launches[name] == 1 and sum(launches.values()) == 1, launches
    ranks = lke.translate(queries, backend="kernel")
    want = torch.searchsorted(lke.keys, keymod.encode(queries, cuda), right=True) - 1
    assert torch.equal(ranks, want) and torch.equal(ranks, lke.translate(queries, backend="ref"))
    assert torch.equal(got, lke.lookup(queries, backend="ref"))
    present = torch.from_numpy(np.isin(queries, keys)).to(cuda)
    row = torch.where(present, torch.clamp(want, min=0), lke.table.shape[0] - 1)
    assert torch.equal(got, lke.table[row])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("dlrm-mlperf", "din", "wide-deep", "sasrec"))
def test_recsys_cells_on_card_equal_cpu(cuda, monkeypatch, arch):
    """The reduced recsys archs' ``serve_bulk`` and ``retrieval_cand``
    cells on the card against the CPU, the same weights copied across,
    TF32 off (f32: 2e-5)."""
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = configs.get(arch, reduced=True)
    params = recsys.init(torch.Generator().manual_seed(6), spec.config)
    on_card = recsys.params_from_numpy(
        {k: ([{n: w.numpy() for n, w in d.items()} for d in v] if isinstance(v, list)
             else v.numpy()) for k, v in params.items()}, device=cuda)
    for cell in spec.shapes:
        if cell.kind not in ("serve", "retrieval"):
            continue
        step = steps.build_step(spec, cell).fn
        batch = steps.make_inputs(spec, cell, np.random.default_rng(6), device="cpu")
        want = step(params, batch)
        got = step(on_card, {k: v.to(cuda) for k, v in batch.items()})
        assert got.device.type == "cuda" and torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5, rtol=2e-5,
                                   err_msg=cell.name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_prefill_matches_decode_chain_on_card(cuda, monkeypatch, dtype):
    """The reduced qwen2-0.5b's prefill (``forward``, last position's
    logits through the head) against a ``decode_step`` chain over the same
    40 tokens, whose attention is the ``decode_attention`` kernel (40 x
    n_layers launches).  f32: 2e-5; bf16: 0.1 absolute, 0.05 relative
    (the two paths round to bf16 at different places)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(_tiny_lm(dtype), q_chunk=16)
    params = transformer.cast_params(
        transformer.init(torch.Generator(device=cuda).manual_seed(3), cfg), getattr(torch, dtype))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (3, 48))).to(cuda)
    h = transformer.forward(params, toks, cfg)
    want = (h[:, -1] @ params["head"]).float()
    cache = transformer.init_cache(cfg, 3, 64, device=cuda)
    kernels.reset_launches()
    for pos in range(48):
        got, cache = transformer.decode_step(params, cache, toks[:, pos:pos + 1], pos, cfg)
    assert kernels.launches()["decode_attention"] == 48 * cfg.n_layers
    tol = (2e-5, 2e-5) if dtype == "float32" else (0.1, 0.05)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol[0], rtol=tol[1])


# -- the training slice ------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("qwen2-0.5b", "moonshot-v1-16b-a3b", "din", "sasrec"))
def test_train_step_on_card_equals_cpu(cuda, monkeypatch, arch):
    """One ``train`` cell step of the reduced arch (f32 compute, TF32 off)
    on the card against the CPU from the same state and batch: loss and
    ``grad_norm`` within 1e-5 relative, AdamW's first moment (``0.1 *``
    the clipped gradients) within 1e-5 of each leaf's largest magnitude,
    the parameters within 2 lr (a gradient sign may differ where it is ~0:
    CUDA's scatter-adds sum in another order) and within 1e-2 lr on all
    but 0.1% of the elements."""
    from repro_torch.launch import steps
    from repro_torch import tree
    from repro_torch.train import TrainConfig, init_train_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = configs.get(arch, reduced=True)
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, dtype="float32"))
    cell = next(c for c in spec.shapes if c.kind == "train")
    tcfg = TrainConfig(total_steps=4, warmup=1)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    cpu = init_train_state(torch.Generator().manual_seed(4), bundle.init_fn, tcfg)
    card = tree.tree_map(lambda t: t.to(cuda), cpu)
    batch = steps.make_inputs(spec, cell, np.random.default_rng(4), device="cpu")
    want_s, want_m = bundle.fn(cpu, batch)
    got_s, got_m = bundle.fn(card, {k: v.to(cuda) for k, v in batch.items()})
    assert all(t.device.type == cuda.type for t in tree.leaves(got_s))
    for k in ("loss", "grad_norm"):
        assert float(got_m[k]) == pytest.approx(float(want_m[k]), rel=1e-5), k
    for g, w in zip(tree.leaves(got_s["opt"]["m"]), tree.leaves(want_s["opt"]["m"])):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=max(1e-5 * float(w.abs().max()), 1e-9))
    lr = tcfg.lr
    for g, w in zip(tree.leaves(got_s["params"]), tree.leaves(want_s["params"])):
        diff = (g.cpu() - w).abs()
        assert float(diff.max()) <= 2 * lr and float((diff > 1e-2 * lr).float().mean()) <= 1e-3


@pytest.mark.gpu
def test_checkpoint_of_card_tensors_restores_onto_the_card(cuda, tmp_path):
    """A train state on the card (f32, bf16 and int32 leaves) saved
    asynchronously and restored into a template on the card: every leaf
    back on the card, bit-equal, dtypes kept."""
    from repro_torch import tree
    from repro_torch.train import checkpoint

    gen = torch.Generator(device=cuda).manual_seed(5)
    state = {"params": {"w": torch.randn(64, 32, generator=gen, device=cuda),
                        "h": torch.randn(16, generator=gen, device=cuda).to(torch.bfloat16)},
             "step": torch.tensor(3, dtype=torch.int32, device=cuda)}
    checkpoint.save(tmp_path, state, 3).join(timeout=60)
    got, step = checkpoint.restore(tmp_path, tree.tree_map(torch.zeros_like, state))
    assert step == 3
    for g, w in zip(tree.leaves(got), tree.leaves(state)):
        assert g.device.type == cuda.type and g.dtype == w.dtype and torch.equal(g, w)


# -- the DimeNet slice -------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("padded", "flat"))
def test_dimenet_step_on_card_equals_cpu(cuda, monkeypatch, layout):
    """One ``graph_train`` step of each reduced DimeNet cell on the card
    against the CPU from the same state and batch (TF32 off): loss within
    5e-5 relative (the forward's f32 segment sums are CUDA ``index_add_``,
    in no fixed order, carried on by the multiplying gate of every
    block); ``grad_norm`` and AdamW's first moment within 2e-3 (of
    each leaf's largest magnitude for the moment): the padded layout's
    message gather reads a bf16 copy, so its backward is a bf16
    scatter-add, which CUDA's ``index_add_`` sums in no fixed order; the
    parameters within 2 lr, and within 1e-2 lr on all but 1% of a leaf
    (a gradient sign may differ where it is ~0)."""
    from repro_torch.launch import steps
    from repro_torch import tree
    from repro_torch.train import TrainConfig, init_train_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = configs.get("dimenet", reduced=True)
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config,
                                                                triplet_layout=layout))
    tcfg = TrainConfig(total_steps=4, warmup=1)
    for cell in spec.shapes:
        bundle = steps.build_step(spec, cell, tcfg=tcfg)
        cpu = init_train_state(torch.Generator().manual_seed(4), bundle.init_fn, tcfg)
        card = tree.tree_map(lambda t: t.to(cuda), cpu)
        batch = steps.make_inputs(spec, cell, np.random.default_rng(4), device="cpu")
        want_s, want_m = bundle.fn(cpu, batch)
        got_s, got_m = bundle.fn(card, {k: v.to(cuda) for k, v in batch.items()})
        assert all(t.device.type == cuda.type for t in tree.leaves(got_s))
        assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]), rel=5e-5), cell.name
        assert float(got_m["grad_norm"]) == pytest.approx(float(want_m["grad_norm"]), rel=2e-3)
        for g, w in zip(tree.leaves(got_s["opt"]["m"]), tree.leaves(want_s["opt"]["m"])):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                       atol=max(2e-3 * float(w.abs().max()), 1e-9))
        lr = tcfg.lr
        for g, w in zip(tree.leaves(got_s["params"]), tree.leaves(want_s["params"])):
            diff = (g.cpu() - w).abs()
            assert float(diff.max()) <= 2 * lr and float((diff > 1e-2 * lr).float().mean()) <= 1e-2


@pytest.mark.gpu
def test_dimenet_minibatch_lg_forward_at_full_width_on_card(cuda, monkeypatch):
    """``minibatch_lg`` at DimeNet's published widths (6 blocks, d 128,
    n_bilinear 8, padded triplets; 169,984 nodes, 168,960 edges): one
    forward pass and its loss on the card, finite, with no intermediate
    past ``(E * t_max, n_bilinear * d)`` (the bilinear contraction's two
    products)."""
    from repro_torch.launch import steps
    from repro_torch.models import dimenet

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = configs.get("dimenet")
    cell = next(c for c in spec.shapes if c.name == "minibatch_lg")
    bundle = steps.build_step(spec, cell)
    params = bundle.init_fn(torch.Generator(device=cuda).manual_seed(0))
    batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=cuda)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = dimenet.forward(params, batch, bundle.cfg)
        loss = dimenet.loss_fn(params, batch, bundle.cfg)
    assert tuple(out.shape) == (cell.dims["n_nodes"], cell.dims["n_out"])
    assert bool(torch.isfinite(out).all()) and np.isfinite(float(loss))
    e, t = batch["tri_kj"].shape
    cap = e * t * bundle.cfg.n_bilinear * bundle.cfg.d_hidden * 4
    assert torch.cuda.max_memory_allocated() < 4 * cap


# -- gradients over ranks (phase 10's gates at the reduced size) ----------------------------------

#: (name, case) of the spawned-rank cases on the card: the reduced archs in
#: f32, a step from a seeded state over the 4 gloo ranks on the one card
_CARD_RANK_CASES = (
    ("lm-4", dict(arch="qwen2-0.5b", family="lm", cell="train_4k", mesh=[4, 1],
                  profile="tp_fsdp", config={"dtype": "float32"})),
    ("lm-int8-4", dict(arch="qwen2-0.5b", family="lm", cell="train_4k", mesh=[4, 1],
                       profile="tp_fsdp", config={"dtype": "float32"},
                       tcfg={"grad_compression": "int8"})),
    ("wide-deep-a2a-4", dict(arch="wide-deep", family="recsys", cell="train_batch",
                             mesh=[1, 4], profile="flat_dp", config={"lookup_mode": "a2a"})),
    ("wide-deep-allreduce-4", dict(arch="wide-deep", family="recsys", cell="train_batch",
                                   mesh=[1, 4], profile="flat_dp",
                                   config={"lookup_mode": "allreduce"})),
    ("dimenet-padded-4", dict(arch="dimenet", family="gnn", cell="molecule", mesh=[4, 1],
                              profile="flat_dp", config={"triplet_layout": "padded"})),
    ("dimenet-flat-4", dict(arch="dimenet", family="gnn", cell="full_graph_sm", mesh=[1, 4],
                            profile="flat_dp", config={"triplet_layout": "flat"})),
)
#: first-moment tolerance of each family against the one-rank step on the
#: card (of each leaf's largest magnitude): sums over ranks reorder, and
#: DimeNet's padded layout reduce-scatters its message gradients in bf16
_CARD_GRAD_RTOL = {"lm": 1e-5, "recsys": 1e-5, "gnn": 2e-3}


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Every card case once on 4 gloo ranks on the one card, and each
    step's one-rank twin on the card (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    work = tmp_path_factory.mktemp("card_ranks")
    want, lookup, restore_state = card_rank_inputs(work)
    run_ranks(train_rank_cases, 4, work, str(work), "cuda", timeout=900)
    got = [torch.load(work / f"train_out{r}.pt", weights_only=False) for r in range(4)]
    return want, got, lookup, restore_state


def card_rank_inputs(work: Path):
    """Write the card cases (``work/train_cases.json`` and their inputs) and
    return each step's one-rank result on the card, the lookup inputs and
    the restore case's state."""
    import os

    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.train import TrainConfig, init_train_state

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases, want = [], {}
    for name, c in _CARD_RANK_CASES:
        tcfg = dict(total_steps=4, warmup=1, **c.get("tcfg", {}))
        spec = _case_spec(c)
        cell = next(x for x in spec.shapes if x.name == c["cell"])
        one = steps.build_step(spec, cell, None, TrainConfig(**tcfg))
        init = one.init_fn
        if c["family"] == "recsys":  # rows rounded to 4 shards, as the ranks' are
            from repro_torch.dist.sharding import AbstractMesh, ShardingCtx

            shaped = ShardingCtx(mesh=AbstractMesh((1, 4), ("data", "model")), profile="flat_dp")
            init = lambda g, cfg=spec.config, s=shaped: recsys.init(g, cfg, s)  # noqa: E731
        state = init_train_state(torch.Generator().manual_seed(7), init, TrainConfig(**tcfg))
        batch = steps.make_inputs(spec, cell, np.random.default_rng(7), device="cpu")
        torch.save({"state": state, "batch": batch}, work / f"{name}.pt")
        cases.append(dict(c, name=name, kind="step", inputs=f"{name}.pt", tcfg=tcfg))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ws, wm = one.fn(tree.tree_map(lambda t: t.to("cuda"), state),
                            {k: v.to("cuda") for k, v in batch.items()})
        finally:
            torch.use_deterministic_algorithms(False)
        want[name] = (tree.tree_map(lambda t: t.cpu(), ws), {k: float(v) for k, v in wm.items()})
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(0, 1, (64, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (32, 5)))
    w = torch.from_numpy(rng.normal(0, 1, (32, 5, 6)).astype(np.float32))
    torch.save({"table": table, "ids": ids, "w": w}, work / "lookup.pt")
    for mode in ("a2a", "allreduce"):
        cases.append(dict(name=f"lookup-{mode}", kind="lookup", inputs="lookup.pt", mesh=[1, 4],
                          profile="flat_dp", mode=mode, local=True))
    gen = torch.Generator().manual_seed(3)
    restore_state = {"params": {"embed": torch.randn(64, 8, generator=gen),
                                "layers": {"wq": torch.randn(2, 8, 16, generator=gen)},
                                "ln_f": torch.randn(8, generator=gen)},
                     "step": torch.tensor(2, dtype=torch.int32)}
    torch.save({"state": restore_state}, work / "restore.pt")
    cases.append(dict(name="restore", kind="restore", inputs="restore.pt", mesh=[2, 2],
                      profile="tp_fsdp", restore_meshes=[[1, 4], [4, 1]]))
    (work / "train_cases.json").write_text(json.dumps(cases))
    return want, (table, ids, w), restore_state


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _ in _CARD_RANK_CASES])
def test_train_step_over_ranks_on_card(card_ranks, name):
    """Phase 10a-10c's gates at the reduced size: a train step over 4 gloo
    ranks on the card (the LM data-parallel, also under int8
    compression; wide & deep's exchanges under autograd in both lookup
    modes at ``cap_factor`` 4.0; DimeNet's edges split in both layouts)
    leaves every rank holding the same replicated leaves, bit for bit, and
    equals the one-rank step on the card: loss and ``grad_norm`` within
    1e-5 relative (2e-3 for ``grad_norm`` under compression or DimeNet's
    bf16 gathers), the first moment within ``_CARD_GRAD_RTOL`` of each
    leaf's largest magnitude (under int8, one quantum ``G / 127`` where a
    rounding tie fell the other way)."""
    from repro_torch import tree

    c = dict(_CARD_RANK_CASES)[name]
    want_s, want_m = card_ranks[0][name]
    got = [g.get(name) for g in card_ranks[1] if g.get(name) is not None]
    rows = c["family"] == "recsys"
    paths = tree.flatten_with_paths(got[0]["state"])[0]
    for i, p in enumerate(paths):
        if rows and p.endswith(("['embed']", "['wide']")):
            continue
        assert all(torch.equal(tree.leaves(g["state"])[i], tree.leaves(got[0]["state"])[i])
                   for g in got), p
    state = got[0]["state"]
    if rows:  # the row shards in rank order
        state = tree.unflatten(state, [
            torch.cat([tree.leaves(g["state"])[i] for g in got]) if p.endswith(("['embed']",
                                                                                 "['wide']"))
            else tree.leaves(state)[i] for i, p in enumerate(paths)])
    loose = c["family"] == "gnn" or c.get("tcfg", {}).get("grad_compression")
    m = got[0]["metrics"]
    assert m["loss"] == pytest.approx(want_m["loss"], rel=1e-5 if c["family"] != "gnn" else 5e-5)
    assert m["grad_norm"] == pytest.approx(want_m["grad_norm"], rel=2e-3 if loose else 1e-5)
    rtol = _CARD_GRAD_RTOL[c["family"]]
    for p, g, w in zip(*tree.flatten_with_paths(state["opt"]["m"]),
                       tree.leaves(want_s["opt"]["m"])):
        big = max(float(w.abs().max()), 1e-9)  # 0.1 * clip * G: a quantum is big / 127
        allowed = rtol * big + (big / 127 * 1.01 if c.get("tcfg") else 0)
        assert float((g - w).abs().max()) <= allowed, p


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("a2a", "allreduce"))
def test_sharded_lookup_gradients_over_ranks_on_card(card_ranks, mode):
    """``sharded_lookup`` on 4 gloo ranks on the card, each rank its
    quarter of the ids: the rows equal the gather bit for bit, the shards'
    gradients put together equal the gather's within 1e-6."""
    table, ids, w = card_ranks[2]
    outs = [g[f"lookup-{mode}"] for g in card_ranks[1]]
    assert torch.equal(torch.cat([o["out"] for o in outs]), table[ids])
    leaf = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((leaf[ids] * w).sum(), leaf)
    np.testing.assert_allclose(torch.cat([o["grad"] for o in outs]).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_elastic_restore_over_ranks_on_card(card_ranks):
    """A state placed over a (2, 2) mesh of 4 gloo ranks as ``DTensor``
    leaves on the host (gloo gathers no ``DTensor`` held on the card),
    saved, and restored onto (1, 4) and (4, 1): on the host every
    ``full_tensor()`` bit-equal to the saved leaf, on the card every local
    block bit-equal to the saved leaf's block; the (1, 4) layout splits
    the embedding's rows (``tp`` over ``model``)."""
    for g in card_ranks[1]:
        r = g["restore"]
        assert all(all(v) for v in r["same"].values())
        assert all(all(v) for v in r["on_device"].values()) and set(r["on_device"]) == {"1x4",
                                                                                      "4x1"}
        assert r["shapes"]["1x4"][0] == [16, 8]


@pytest.mark.gpu
def test_dryrun_flops_equal_the_step_on_card(cuda, monkeypatch):
    """The dry run of the reduced qwen2-0.5b ``train_4k`` (fake tensors, one
    rank) counts the same FLOPs as ``FlopCounterMode`` around the real step
    on the card, within 1e-6, and predicts a peak no lower than the state
    it holds."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, steps
    from repro_torch.train import TrainConfig, init_train_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = configs.get("qwen2-0.5b", reduced=True)
    cell = next(c for c in spec.shapes if c.kind == "train")
    tcfg = TrainConfig()
    entry = dryrun.run_cell(spec, cell, (1, 1), tcfg=tcfg, verbose=False)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=cuda).manual_seed(0), bundle.init_fn, tcfg)
    batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=cuda)
    with FlopCounterMode(display=False) as fc:
        bundle.fn(state, batch)
    assert entry["flops"] == pytest.approx(fc.get_total_flops(), rel=1e-6)
    assert entry["memory"]["peak_bytes"] >= entry["memory"]["argument_bytes"]


# -- parameters placed over fsdp, tp and ep (phase 10e's gates at the reduced size) -----------

#: (name, arch, microbatches of the one-rank twin): the MoE's twin takes one
#: microbatch a dp shard, so each routes at the shard's capacity as a rank does
_PLACED_CARD_CASES = (("granite", "granite-3-8b", 1), ("moonshot", "moonshot-v1-16b-a3b", 2))


@pytest.fixture(scope="module")
def placed_card_ranks(tmp_path_factory):
    """The placed cases on a (2, 2) ``tp_fsdp`` mesh of 4 gloo ranks on the
    one card (f32), and each step's one-rank twin on the card (TF32 off):
    returns ``(want, got_by_rank)``, ``want[name] = (state, metrics, the
    mean of the twin's microbatch losses)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt
    from repro_torch.train import TrainConfig, init_train_state

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    work = tmp_path_factory.mktemp("placed_card")
    cases, want = [], {}
    for name, arch, mb in _PLACED_CARD_CASES:
        c = dict(arch=arch, config={"dtype": "float32"})
        spec = _case_spec(c)
        cell = next(x for x in spec.shapes if x.kind == "train")
        tcfg = dict(total_steps=4, warmup=1)
        state = init_train_state(torch.Generator().manual_seed(7),
                                 lambda g, cfg=spec.config: tt.init(g, cfg), TrainConfig(**tcfg))
        batch = steps.make_inputs(spec, cell, np.random.default_rng(7), device="cpu")
        torch.save({"state": state, "batch": batch}, work / f"{name}.pt")
        cases.append(dict(c, name=name, kind="step", inputs=f"{name}.pt", mesh=[2, 2], tcfg=tcfg))
        one = steps.build_step(spec, cell, None, TrainConfig(**tcfg, microbatches=mb))
        dev_state = tree.tree_map(lambda t: t.to("cuda"), state)
        dev_batch = {k: v.to("cuda") for k, v in batch.items()}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ws, wm = one.fn(dev_state, dev_batch)
            rows = batch["tokens"].shape[0] // mb
            with torch.no_grad():
                loss = np.mean([float(tt.loss_fn(dev_state["params"], {
                    k: v[i * rows:(i + 1) * rows] for k, v in dev_batch.items()}, spec.config))
                    for i in range(mb)])
        finally:
            torch.use_deterministic_algorithms(False)
        want[name] = (tree.tree_map(lambda t: t.cpu(), ws), {k: float(v) for k, v in wm.items()},
                      float(loss))
    cases.append(dict(name="roundtrip-moonshot", kind="roundtrip", inputs="moonshot.pt",
                      mesh=[2, 2], arch="moonshot-v1-16b-a3b", config={"dtype": "float32"},
                      tcfg={}))
    cases.append(dict(name="ckpt", kind="ckpt", inputs="granite.pt", mesh=[2, 2],
                      arch="granite-3-8b", config={"dtype": "float32"}, tcfg={},
                      restore_meshes=[[1, 1], [4, 1], [1, 4]]))
    (work / "placed_cases.json").write_text(json.dumps(cases))
    run_ranks(placed_rank_cases, 4, work, str(work), "cuda", timeout=900)
    return want, [torch.load(work / f"placed_out{r}.pt", weights_only=False) for r in range(4)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _, _ in _PLACED_CARD_CASES])
def test_placed_step_over_ranks_on_card(placed_card_ranks, name):
    """Phase 10e's gates at the reduced size: a train step of the reduced
    granite (its one KV head gathered on both ``tp`` ranks) and moonshot
    (8 experts over ``ep``) placed on a (2, 2) mesh of 4 gloo ranks on the
    card: every rank gathers the same state, bit for bit, and the step ==
    the one-rank step on the card (moonshot's in one microbatch a ``dp``
    shard: the same capacity): the loss (the ``dp`` mean) and
    ``grad_norm`` within 1e-5 relative, the first moment within 1e-5 of
    each leaf's largest magnitude."""
    from repro_torch import tree

    want_s, want_m, want_loss = placed_card_ranks[0][name]
    got = [g[name] for g in placed_card_ranks[1]]
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g["state"]),
                                                     tree.leaves(got[0]["state"])))
    m = got[0]["metrics"]
    assert m["loss"] == pytest.approx(want_loss, rel=1e-5)
    assert m["grad_norm"] == pytest.approx(want_m["grad_norm"], rel=1e-5)
    for p, g, w in zip(*tree.flatten_with_paths(got[0]["state"]["opt"]["m"]),
                       tree.leaves(want_s["opt"]["m"])):
        assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-9), p


@pytest.mark.gpu
def test_placed_state_round_trips_and_restores_on_card(placed_card_ranks):
    """On the card: the reduced moonshot's state placed over (2, 2) and
    gathered back bit for bit (no split leaf held whole), and the placed
    granite's checkpoint restored onto (1, 1), (4, 1) and (1, 4) block by
    block, bit-equal."""
    for g in placed_card_ranks[1]:
        r = g["roundtrip-moonshot"]
        assert r["same"] and r["same_np"] and r["no_whole"]
        assert all(v for v in g["ckpt"]["same"].values() if v is not None)
    assert all(placed_card_ranks[1][0]["ckpt"]["same"].values())
