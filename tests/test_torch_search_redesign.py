"""The redesigned model-free, PGM and RS search kernels' twins held against
the JAX package's Pallas kernels in interpret mode.

``pgm_search``: the twins take the raw queries and the index's f64
``pk_kmin``/``pk_inv_span`` and compute ``u`` themselves (the kernel's
first step), read the int64 level directories, and stop each level's
search once its window is one key wide.  ``rs_search``: the same, and the
unsigned radix prefix from the key ``kmin`` and ``shift`` leaves; both
the knot search and the table search stop at a one-key window.  ``kary_search``: the first trips
come from the top of the implicit search tree (staged in shared memory by
the kernel, in Eytzinger order) and the last ones become one sweep of at
most ``SWEEP`` keys.  Ranks are integers: no tolerance.
"""

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as rix
from repro import tune as rtune
from repro.core import true_ranks
from repro.kernels.kary_search import LANES, kary_search_pallas
from repro.kernels.ops import split_u64
from repro_torch import index as tix
from repro_torch import tune as ttune
from repro_torch.core import keys
from repro_torch.core.cdf import ceil_log2
from repro_torch.kernels.kary_search import (
    SWEEP,
    TREE_LEVELS,
    _kary_body,
    kary_search_plain,
    search_plan,
    tree_levels,
    tree_positions,
)
from repro_torch.kernels.pgm_search import _pgm_level_window
from repro_torch.kernels.rs_search import _rs_window_body, radix_prefix

from conftest import TABLE_KINDS, make_table
from test_torch_batched import _tables
from test_torch_build import edge_queries
from test_torch_gpu import (
    EDGE_NS,
    RS_SHIFT0,
    clamp_table,
    edge_table,
    every_key_queries,
    rs_span_table,
)
from test_torch_kernels import _early_exit_ranks

PGM_KINDS = ("PGM", "PGM_M")


def _port_of(ref):
    leaves = {k: np.asarray(v) for k, v in ref.arrays.items()}
    return tix.Index.from_numpy(ref.kind, ref.static, leaves, ref.info, device="cpu")


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("kind", PGM_KINDS)
def test_pgm_twin_computes_u_and_matches_pallas(kind, table_kind):
    """The single-table twin on the raw queries (u its own) equals the
    reference's ``fused_pgm_search_pallas`` fed the reference's u, and the
    true ranks; the dispatch passes no u and no int32 copy."""
    rng = np.random.default_rng(51)
    table = make_table(rng, table_kind, 8192)
    qs = edge_queries(rng, table)
    ref = rix.build(kind, table)
    port = _port_of(ref)
    impl = tix.impls.query_impl(kind)
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    args, kwargs = impl.operands(port, t, q)
    assert args[0] is q and args[2].dtype == torch.float64 and args[3].dtype == torch.float64
    assert all(d.dtype == torch.int64 for d in args[7:11])  # rank0, off, off_r, sizes
    got = impl.plain(*args, **kwargs).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.lookup(table, qs, backend="pallas")))
    np.testing.assert_array_equal(got, true_ranks(table, qs))


@pytest.mark.parametrize("kind", PGM_KINDS)
def test_batched_pgm_twin_computes_u_and_matches_pallas(kind):
    """The batched twin on a stack whose shallow tables were lifted equals
    the reference's ``batched_pgm_search_pallas`` fed the reference's u
    (after the count clamp both apply)."""
    rng = np.random.default_rng(52)
    tables = _tables(rng)
    levels = [tix.build(kind, t, device="cpu").s("levels") for t in tables]
    assert len(set(levels)) > 1  # the stack lifts the shallow tables
    qs = np.concatenate([rng.choice(np.concatenate(tables), 1500),
                         np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64)]).astype(np.uint64)
    rb = rtune.build_many(rix.spec_for(kind), tables)
    tb = ttune.build_many(tix.spec_for(kind), tables, device="cpu")
    impl = tix.impls.query_impl(kind)
    q = tb.queries_for(keys.encode(qs, "cpu"))
    args, kwargs = impl.batched_operands(tb.index, tb.tables, q)
    assert args[0] is q and args[2].shape == (3,) and args[2].dtype == torch.float64
    assert all(d.dtype == torch.int64 for d in args[7:11])
    got = torch.minimum(impl.batched_plain(*args, **kwargs).long(), tb.counts[:, None] - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rb.lookup(qs, backend="pallas")))
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i].numpy(), true_ranks(t, qs))


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("kind", PGM_KINDS)
def test_pgm_trips_per_query_fit_under_steps(kind, table_kind):
    """The kernel stops each level's search once the query's window is one
    key wide, ``pksteps`` only the cap.  Level by level, the widest
    window needs ``ceil_log2(hi - lo + 1) <= pksteps`` trips, and a
    per-query early-exit loop gives the twin's ranks; the twin's probe
    list counts exactly the table trips taken."""
    rng = np.random.default_rng(53)
    table = make_table(rng, table_kind, 20000)
    qs = edge_queries(rng, table)
    idx = tix.build(kind, table, device="cpu")
    impl = tix.impls.query_impl(kind)
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    args, kwargs = impl.operands(idx, t, q)
    _, _, kmin, inv_span, seg_keys, u0, slope, rank0, off, off_r, sizes, eps = args
    steps, levels = kwargs["steps"], kwargs["levels"]
    u = keys.unit_f32(q, kmin, inv_span)
    off32, off_r32 = off.to(torch.int32), off_r.to(torch.int32)
    seg = torch.zeros(len(qs), dtype=torch.int32)
    for lvl in range(levels):
        lo, hi = _pgm_level_window(u, seg, lvl, u0, slope, rank0, off32, off_r32, eps)
        if lvl + 1 < levels:
            base = int(off[lvl + 1])
            arr = seg_keys.numpy()
        else:
            lo, hi = torch.clamp(lo, 0, len(table) - 1), torch.clamp(hi, 0, len(table) - 1)
            base, arr = 0, t.numpy()
        assert ceil_log2(int((hi - lo + 1).max())) <= steps, lvl
        ranks, trips = _early_exit_ranks(arr, q.numpy(), lo.numpy() + base, hi.numpy() + base,
                                         steps)
        assert trips.max() <= steps
        if lvl + 1 < levels:
            seg = torch.from_numpy(np.clip(ranks - base, 0, int(sizes[lvl + 1]) - 1)).to(torch.int32)
    probes = []
    twin = impl.plain(*args, **kwargs, probes=probes).numpy()
    np.testing.assert_array_equal(twin, true_ranks(table, qs))
    np.testing.assert_array_equal(ranks, twin)
    assert sum(int(p.numel()) for p in probes) == int(trips.sum()) + len(qs)


def _rs_case(name: str):
    """(table, queries, reference spec) of one RS case: a ``make_table``
    kind, the pinned clamp table, a key span of 2^63 or more, or shift 0."""
    rng = np.random.default_rng(55)
    if name == "pinned clamp":
        table, qs = clamp_table()
        return table, qs, rix.spec_for("RS")
    if name == "span >= 2^63":
        table = rs_span_table()
        return table, edge_queries(rng, table), rix.RSSpec(eps=16, r_bits=10)
    if name == "shift 0":
        return RS_SHIFT0 + (rix.RSSpec(eps=4, r_bits=12),)
    table = make_table(rng, name, 8192)
    return table, edge_queries(rng, table), rix.spec_for("RS")


@pytest.mark.parametrize("case", TABLE_KINDS + ("pinned clamp", "span >= 2^63", "shift 0"))
def test_rs_twin_on_raw_queries_matches_pallas(case):
    """The single-table twin on the raw queries (``u`` and the prefix its
    own) equals the reference's ``fused_rs_search_pallas`` (through its
    ``_rs_pallas`` dispatch, which computes both outside the kernel) and
    the true ranks.  The dispatch passes the queries and the index's own
    leaf tensors: no ``u``, no prefix, no cast."""
    table, qs, spec = _rs_case(case)
    ref = rix.build(spec, table)
    port = _port_of(ref)
    impl = tix.impls.query_impl("RS")
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    args, kwargs = impl.operands(port, t, q)
    assert args[0] is q and args[1] is t
    a = port.arrays
    for arg, leaf in zip(args[2:], ("kmin", "shift", "rk_kmin", "rk_inv_span", "knot_keys", "rk_u0",
                                   "rk_slope", "knot_ranks", "radix_table", "m_valid", "rk_eps")):
        assert arg.data_ptr() == a[leaf].data_ptr() and arg.dtype == a[leaf].dtype, leaf
    assert kwargs["r_bits"] == port.s("r_bits")
    got = impl.plain(*args, **kwargs).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.lookup(table, qs, backend="pallas")))
    np.testing.assert_array_equal(got, true_ranks(table, qs))


@pytest.mark.parametrize("stack", ("ragged", "span >= 2^63", "shift 0"))
def test_batched_rs_twin_on_raw_queries_matches_pallas(stack):
    """The batched twin, each row's ``u`` and prefix from its own table's
    leaves, equals the reference's ``batched_rs_search_pallas`` (after the
    count clamp both apply) on a ragged stack, on a stack of key spans of
    2^63 or more, and on a stack of shift-0 tables (equal pow2 lengths, so
    that no padding widens their span)."""
    rng = np.random.default_rng(56)
    params = {"ragged": {}, "span >= 2^63": {"eps": 16, "r_bits": 10},
              "shift 0": {"eps": 4, "r_bits": 12}}[stack]
    if stack == "ragged":
        tables = _tables(rng)
    elif stack == "span >= 2^63":
        tables = [rs_span_table(), rs_span_table()[1::2]]
    else:
        tables = [np.arange(100, 484, 3, dtype=np.uint64), np.arange(5000, 5384, 3, dtype=np.uint64)]
    qs = np.concatenate([rng.choice(np.concatenate(tables), 1500), RS_SHIFT0[1]]).astype(np.uint64)
    rb = rtune.build_many(rix.spec_for("RS", **params), tables)
    tb = ttune.build_many(tix.spec_for("RS", **params), tables, device="cpu")
    assert bool((tb.index.arrays["shift"] == 0).all()) == (stack == "shift 0")
    impl = tix.impls.query_impl("RS")
    q = tb.queries_for(keys.encode(qs, "cpu"))
    args, kwargs = impl.batched_operands(tb.index, tb.tables, q)
    assert args[0] is q and args[2].shape == (len(tables),) and args[2].dtype == torch.int64
    assert all(x.dtype == torch.int64 for x in (args[3], args[9], args[10], args[11]))
    got = torch.minimum(impl.batched_plain(*args, **kwargs).long(), tb.counts[:, None] - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rb.lookup(qs, backend="pallas")))
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i].numpy(), true_ranks(t, qs))


@pytest.mark.parametrize("case", TABLE_KINDS + ("span >= 2^63",))
def test_rs_trips_per_query_fit_under_caps(case):
    """The kernel stops the knot search and the table search once the
    query's window is one key wide, ``ksteps`` and ``rk_epi`` only the
    caps.  The widest radix bucket needs ``ceil_log2(len) <= ksteps``
    knot trips and the widest ε-window ``ceil_log2(hi - lo + 1) <=
    rk_epi`` table trips; a per-query early-exit loop gives the knot
    search's upper bound (``np.searchsorted`` inside the bucket) and the
    twin's ranks; the twin's probe list counts exactly the table trips
    taken."""
    rng = np.random.default_rng(57)
    if case == "span >= 2^63":
        table = rs_span_table()
        idx = tix.build(tix.RSSpec(eps=16, r_bits=10), table, device="cpu")
    else:
        table = make_table(rng, case, 20000)
        idx = tix.build("RS", table, device="cpu")
    qs = edge_queries(rng, table)
    impl = tix.impls.query_impl("RS")
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    args, kwargs = impl.operands(idx, t, q)
    _, _, kmin, shift, rk_kmin, rk_inv_span, knots, *leaves = args
    ksteps, steps = kwargs["ksteps"], kwargs["steps"]
    radix = leaves[3]
    prefix = radix_prefix(q, kmin, shift, kwargs["r_bits"])
    p = torch.clamp(prefix, 0, radix.numel() - 2)
    lo_k = torch.clamp(radix[p] - 1, min=0)
    len_k = torch.clamp(radix[p + 1] - lo_k, min=1)
    assert ceil_log2(int(len_k.max())) <= ksteps
    knot_ranks, knot_trips = _early_exit_ranks(knots.numpy(), q.numpy(), lo_k.numpy(),
                                               (lo_k + len_k - 1).numpy(), ksteps)
    assert knot_trips.max() <= ksteps
    ub = np.clip(np.searchsorted(knots.numpy(), q.numpy(), side="right"), lo_k.numpy(),
                 (lo_k + len_k).numpy())
    np.testing.assert_array_equal(knot_ranks, ub - 1)
    u = keys.unit_f32(q, rk_kmin, rk_inv_span)
    lo, hi = _rs_window_body(u, q, prefix, knots, *leaves, n=len(table), ksteps=ksteps)
    assert ceil_log2(int((hi - lo + 1).max())) <= steps
    ranks, trips = _early_exit_ranks(t.numpy(), q.numpy(), lo.numpy(), hi.numpy(), steps)
    assert trips.max() <= steps
    probes = []
    twin = impl.plain(*args, **kwargs, probes=probes).numpy()
    np.testing.assert_array_equal(twin, true_ranks(table, qs))
    np.testing.assert_array_equal(ranks, twin)
    assert sum(int(p.numel()) for p in probes) == int(trips.sum()) + len(qs)


@pytest.mark.parametrize("n", EDGE_NS)
def test_kary_sweep_twin_matches_pallas_and_searchsorted(n):
    """Tree trips, global trips down to a window of at most ``SWEEP`` keys,
    then the sweep: the ranks of ``kary_search_pallas`` (k = 128 fences a
    trip and a 128-key sweep) in interpret mode and of ``np.searchsorted``,
    for every key, key +- 1, 0 and 2^64 - 1.  The plan's window is
    ``ceil(n / 2^(levels + trips))`` keys, and one more global trip would
    not have been needed; the probes are a binary search's (the bound's
    count), one a trip and the last compare."""
    table = edge_table(n)
    qs = every_key_queries(table)
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    probes = []
    got = kary_search_plain(t, q, probes=probes).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(table, qs, side="right") - 1)
    tile = 2048
    pad = np.zeros((-len(qs)) % tile, dtype=np.uint64)
    qhi, qlo = split_u64(jnp.asarray(np.concatenate([qs, pad])))
    thi, tlo = split_u64(jnp.asarray(table))
    want = kary_search_pallas(qhi, qlo, thi, tlo, k=LANES, tile_q=tile, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want)[: len(qs)])
    levels, trips, length = search_plan(n)
    assert levels == tree_levels(n) and 1 <= length <= SWEEP
    assert length == -(-n // (1 << (levels + trips)))
    assert trips == 0 or -(-n // (1 << (levels + trips - 1))) > SWEEP
    assert len(probes) == levels + trips + (length - 1).bit_length() + 1
    assert all(p.numel() == len(qs) for p in probes)
    idx = torch.cat(probes)
    assert int(idx.min()) >= 0 and int(idx.max()) < n


@pytest.mark.parametrize("n", EDGE_NS + (2**24 + 5, 2**31 - 1))
def test_kary_staged_tree_is_the_first_trips_probes(n):
    """A Python replay of the plain Khuong–Morin loop over ``[0, n)``: the
    positions its first ``tree_levels(n)`` trips probe, node by node of
    the path (node = 2 node + right), are the staged tree's entries
    (``tree_positions``, Eytzinger order), every node is reached, and the
    twin walks the staged keys to the same probes."""
    levels = tree_levels(n)
    assert levels == min(TREE_LEVELS, ceil_log2(n) if n > 1 else 0)
    pos = tree_positions(n)
    assert pos.numel() == 1 << levels
    rng = np.random.default_rng(54)
    # over the table 0 .. n-1 a query's predecessor is the query itself
    q = torch.from_numpy(np.unique(np.concatenate([
        np.arange(-1, min(n, 70000)), rng.integers(-1, n, 200000)]))).to(torch.int64)
    base, length = torch.zeros_like(q), n
    node = torch.ones_like(q)
    seen = set()
    mids = []
    for _ in range(levels):
        half = length >> 1
        mid = base + half
        assert torch.equal(mid, pos[node])
        seen.update(node.unique().tolist())
        mids.append(mid)
        right = (mid <= q).long()
        node = 2 * node + right
        base = torch.where(right.bool(), mid, base)
        length -= half
    assert seen == set(range(1, 1 << levels))
    assert bool((pos[1:] >= 0).all()) and int(pos.max()) < n
    if n <= max(EDGE_NS):
        t = torch.arange(n, dtype=torch.int64)
        probes = []
        got = _kary_body(q, t, n=n, probes=probes)
        np.testing.assert_array_equal(got.numpy(), np.clip(q.numpy(), -1, n - 1))
        for j, mid in enumerate(mids):
            assert torch.equal(probes[j].long(), mid), j
