"""The port's batched path held against the JAX reference:
``repro_torch.tune.build_many`` → ``BatchedIndexes.lookup(backend="kernel")``.

For all ten static kinds: the stacked leaves (key leaves after decoding)
and the merged statics equal those of the reference's ``build_many``,
``unstack()`` is bit-exact with per-table builds (inverting the PGM level
lift), and the batched twins that the wrappers run on CPU tensors give
the ranks of the reference's batched Pallas kernels in interpret mode,
including the clamp of ragged batches to each table's real keys.  Ranks
are integers: no tolerance.
"""

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import numpy as np
import pytest
import torch

from repro import index as rix
from repro import tune as rtune
from repro.core import true_ranks
from repro_torch import index as tix
from repro_torch import kernels
from repro_torch import tune as ttune
from repro_torch.core import keys
from repro_torch.dist import sharded_index as tsi
from repro_torch.kernels.kary_search import batched_kary_search
from repro_torch.kernels.pgm_search import batched_pgm_search
from repro_torch.kernels.rmi_search import batched_rmi_search

from conftest import make_table
from test_torch_build import ref_leaves

#: the reference tests' parameters (tests/test_tune.py:PARAMS)
PARAMS = {
    "L": {},
    "Q": {},
    "C": {},
    "KO": {"k": 7},
    "RMI": {"b": 64},
    "SY-RMI": {"space_pct": 2.0, "ub": 0.04},
    "PGM": {"eps": 16},
    "PGM_M": {"space_pct": 2.0, "a": 1.0},
    "RS": {"eps": 16, "r_bits": 8},
    "BTREE": {"fanout": 8},
}
KINDS = tuple(PARAMS)


def _tables(rng, n=2048):
    # different PGM segment structures, so stacking lifts levels and
    # unstack lowers them again
    return [make_table(rng, k, n) for k in ("uniform", "sequential", "clustered")]


def _queries(rng, tables, n=512):
    qs = rng.choice(np.concatenate(tables), size=n).astype(np.uint64)
    return np.concatenate([qs, qs - np.uint64(1),
                           np.array([0, 1, 2**63, np.iinfo(np.uint64).max], dtype=np.uint64)])


def _both(kind, tables):
    rspec, tspec = rix.spec_for(kind, **PARAMS[kind]), tix.spec_for(kind, **PARAMS[kind])
    return rtune.build_many(rspec, tables), ttune.build_many(tspec, tables, device="cpu")


def _assert_same_leaves(want: dict, got: dict, what):
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, (what, k)
        assert got[k].tobytes() == w.tobytes(), (what, k)


def _assert_batched_ranks(rb, tb, tables, qs, what):
    before = kernels.launches()
    got = tb.lookup(qs, backend="kernel")
    assert kernels.launches() == before  # the CPU path runs the twin, launches nothing
    assert got.dtype == torch.int64 and tuple(got.shape) == (len(tables), len(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rb.lookup(qs, backend="pallas")),
                                  err_msg=what)
    np.testing.assert_array_equal(got.numpy(), tb.lookup(qs, backend="ref").numpy(), err_msg=what)
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i].numpy(), true_ranks(t, qs), err_msg=f"{what}/{i}")


@pytest.mark.parametrize("kind", KINDS)
def test_build_many_bit_exact_all_kinds(kind):
    rng = np.random.default_rng(41)
    tables = _tables(rng)
    qs = _queries(rng, tables)
    rb, tb = _both(kind, tables)
    assert tb.index.static == rb.index.static
    _assert_same_leaves(ref_leaves(rb.index), tb.index.to_numpy(), kind)
    np.testing.assert_array_equal(keys.decode(tb.tables), np.asarray(rb.tables))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(rb.counts))
    singles = [tix.build(tix.spec_for(kind, **PARAMS[kind]), t, device="cpu") for t in tables]
    for i, (got, want, ref) in enumerate(zip(tb.unstack(), singles, rb.unstack())):
        assert got.kind == want.kind and got.static == want.static, (kind, i)
        _assert_same_leaves(want.to_numpy(), got.to_numpy(), (kind, i))
        _assert_same_leaves(ref_leaves(ref), got.to_numpy(), (kind, i))
    assert tb.space_bytes() == rb.space_bytes() == sum(s.space_bytes() for s in singles)
    _assert_batched_ranks(rb, tb, tables, qs, kind)


@pytest.mark.parametrize("kind", ("RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE", "KO"))
def test_build_many_ragged_tables_lookup_exact(kind):
    """Ragged batches pad to a common power-of-two length; ranks that land
    in a table's padded tail clamp back to its last real key."""
    rng = np.random.default_rng(42)
    tables = [make_table(rng, "uniform", n) for n in (1500, 700, 1024)]
    qs = _queries(rng, tables, n=256)
    rb, tb = _both(kind, tables)
    assert tb.index.static == rb.index.static
    _assert_same_leaves(ref_leaves(rb.index), tb.index.to_numpy(), kind)
    np.testing.assert_array_equal(keys.decode(tb.tables), np.asarray(rb.tables))
    np.testing.assert_array_equal(tb.counts.numpy(), [1500, 700, 1024])
    _assert_batched_ranks(rb, tb, tables, qs, kind)


@pytest.mark.parametrize("kind", ("PGM", "PGM_M"))
def test_pgm_level_lift_and_lower_round_trip(kind):
    """Members with different level counts: stacking lifts the shallow
    ones (``_lift_pgm_levels``), unstack lowers them again
    (``_lower_pgm_arrays``), both bit-exact with the reference."""
    rng = np.random.default_rng(43)
    tables = [make_table(rng, "sequential", 2048), make_table(rng, "clustered", 2048),
              make_table(rng, "lognormal", 2048)]
    singles = [tix.build(tix.spec_for(kind, **PARAMS[kind]), t, device="cpu") for t in tables]
    levels = [s.s("levels") for s in singles]
    assert len(set(levels)) > 1, levels  # the batch exercises the lift
    rb, tb = _both(kind, tables)
    assert tb.index.s("levels") == max(levels)
    _assert_same_leaves(ref_leaves(rb.index), tb.index.to_numpy(), kind)
    for got, want in zip(tb.unstack(), singles):
        assert got.static == want.static
        _assert_same_leaves(want.to_numpy(), got.to_numpy(), kind)
    # the lift alone, on one member, is the reference's lift
    from repro.dist import sharded_index as rsi

    shallow = int(np.argmin(levels))
    ref_single = rix.build(rix.spec_for(kind, **PARAMS[kind]), tables[shallow])
    want = rsi._lift_pgm_levels(ref_single, max(levels))
    static, arrays = tsi._lift_pgm_levels(singles[shallow].static,
                                          singles[shallow].to_numpy(), max(levels))
    assert static == want.static
    _assert_same_leaves(ref_leaves(want), arrays, kind)
    qs = _queries(rng, tables)
    _assert_batched_ranks(rb, tb, tables, qs, kind)


@pytest.mark.parametrize("kind", ("RMI", "SY-RMI", "PGM", "PGM_M", "RS"))
def test_batched_fused_kernel_twins_merge_trip_counts(kind):
    """Port twins of ``test_batched_{rmi,pgm,rs}_kernel``: the fused batched
    twin answers every table of the stack with one merged (max) trip
    count, equal to the reference's batched Pallas kernel."""
    rng = np.random.default_rng(44)
    tables = [make_table(rng, k, 2048) for k in ("uniform", "clustered", "bursty")]
    qs = _queries(rng, tables)
    rb, tb = _both(kind, tables)
    singles = [tix.build(tix.spec_for(kind, **PARAMS[kind]), t, device="cpu") for t in tables]
    for step in {"RMI": ("ksteps",), "SY-RMI": ("ksteps",), "PGM": ("levels", "pksteps"),
                 "PGM_M": ("levels", "pksteps"), "RS": ("ksteps", "rk_epi")}[kind]:
        assert tb.index.s(step) == max(s.s(step) for s in singles), step
    impl = tix.impls.query_impl(kind)
    assert impl.batched_search.__name__ == {"RMI": "batched_rmi_search",
                                            "SY-RMI": "batched_rmi_search",
                                            "PGM": "batched_pgm_search",
                                            "PGM_M": "batched_pgm_search",
                                            "RS": "batched_rs_search"}[kind]
    _assert_batched_ranks(rb, tb, tables, qs, kind)


def test_broadcast_queries_equal_packed_rows():
    rng = np.random.default_rng(45)
    tables = _tables(rng, n=1024)
    qs = _queries(rng, tables, n=200)
    for kind in ("KO", "RMI", "PGM", "RS"):
        tb = ttune.build_many(tix.spec_for(kind, **PARAMS[kind]), tables, device="cpu")
        q = keys.encode(qs, "cpu")
        packed = tb.lookup(q[None, :].repeat(len(tables), 1))
        broadcast = tb.lookup(q)
        assert tb.queries_for(q).stride(0) == 0  # expand: no copy
        np.testing.assert_array_equal(packed.numpy(), broadcast.numpy(), err_msg=kind)
        # per-row query batches: row t answered against table t only
        rows = np.stack([rng.choice(t, 64) for t in tables])
        got = tb.lookup(keys.encode(rows, "cpu")).numpy()
        for i, t in enumerate(tables):
            np.testing.assert_array_equal(got[i], true_ranks(t, rows[i]), err_msg=kind)


def test_build_many_needs_the_card_unless_asked_and_rejects_unported_options():
    rng = np.random.default_rng(46)
    tables = _tables(rng, n=256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttune.build_many("PGM", tables)
    # the device fits are ported (parity in test_torch_device_fit.py); what
    # a kind has no fit for is refused
    for fit in ("vmap", "fast", "auto"):
        fitted = ttune.build_many("PGM", tables, fit=fit, device="cpu")
        np.testing.assert_array_equal(fitted.lookup(tables[0]).numpy(),
                                      np.stack([true_ranks(t, tables[0]) for t in tables]))
    with pytest.raises(ValueError, match="fit='vmap' is not supported"):
        ttune.build_many("BTREE", tables, fit="vmap", device="cpu")
    with pytest.raises(ValueError, match="fit='fast' is not supported"):
        ttune.build_many("RMI", tables, fit="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown fit"):
        ttune.build_many("PGM", tables, fit="scan", device="cpu")
    tb = ttune.build_many("BTREE", tables, device="cpu")
    # every backend is ported: xla and bbs answer (parity in test_torch_intervals.py)
    assert ttune.BATCH_BACKENDS == tix.BACKENDS
    want = np.stack([true_ranks(t, tables[0]) for t in tables])
    for backend in ("xla", "bbs"):
        np.testing.assert_array_equal(tb.lookup(tables[0], backend=backend).numpy(), want)
    with pytest.raises(ValueError, match="unknown batched backend"):
        tb.lookup(tables[0], backend="pallas")
    with pytest.raises(ValueError, match="expected"):
        tb.lookup(np.stack(tables[:2]))


def test_stack_indexes_matches_reference():
    from repro.dist import sharded_index as rsi

    rng = np.random.default_rng(47)
    tables = [make_table(rng, "uniform", 1024), make_table(rng, "uniform", 900)]
    for kind in ("PGM", "RS", "KO"):
        ref = rsi.stack_indexes([rix.build(kind, t) for t in tables])
        got = tsi.stack_indexes([tix.build(kind, t, device="cpu") for t in tables])
        assert got.static == ref.static and got.info == ref.info
        _assert_same_leaves(ref_leaves(ref), got.to_numpy(), kind)
    # PGMs of different depths stack only after the lift
    deep = [tix.build("PGM", t, eps=8, device="cpu")
            for t in (make_table(rng, "sequential", 1024), tables[0])]
    assert deep[0].s("levels") != deep[1].s("levels")
    with pytest.raises(ValueError, match="differs across tables"):
        tsi.stack_indexes(deep)
    with pytest.raises(ValueError, match="different kinds"):
        tsi.stack_indexes([tix.build("PGM", tables[0], device="cpu"),
                           tix.build("RS", tables[0], device="cpu")])
    with pytest.raises(ValueError, match="differs across tables"):
        tsi.stack_indexes([tix.build("BTREE", t, fanout=4, device="cpu")
                           for t in (tables[0], tables[0][:16])])


def test_pad_sorted_table_matches_reference():
    from repro.dist import sharded_index as rsi

    rng = np.random.default_rng(48)
    t = make_table(rng, "lognormal", 700)
    for m in (700, 1024, 4096):
        np.testing.assert_array_equal(tsi._pad_sorted_table(t, m), rsi._pad_sorted_table(t, m))
    top = np.array([2**64 - 3, 2**64 - 2], dtype=np.uint64)
    np.testing.assert_array_equal(tsi._pad_sorted_table(top, 8), rsi._pad_sorted_table(top, 8))


def test_batched_wrappers_validate_operands():
    t = keys.encode(np.arange(1, 65, dtype=np.uint64), "cpu").reshape(2, 32).contiguous()
    q = t.clone()
    with pytest.raises(ValueError, match=r"\(2, B\)"):
        batched_kary_search(t, q[:1])
    with pytest.raises(ValueError, match="packed rows or one row broadcast"):
        batched_kary_search(t, torch.zeros(2, 64, dtype=torch.int64)[:, ::2].contiguous()
                            .as_strided((2, 16), (40, 1)))
    f, i = torch.zeros(2, 4, dtype=torch.float32), torch.zeros(2, 4, dtype=torch.int32)
    two = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="4 columns"):
        batched_rmi_search(q, t, two, two, f[:, :3].contiguous(), f, f, i, i, i, steps=4)
    with pytest.raises(ValueError, match="2 elements"):  # one kmin a table
        batched_rmi_search(q, t, two[:1], two, f, f, f, i, i, i, steps=4)
    seg, d = torch.zeros(2, 32), torch.zeros(2, 2, dtype=torch.int64)
    e = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="3 columns"):  # off needs levels + 1
        batched_pgm_search(q, t, two, two, t, seg, seg, d, d, d, d, e, levels=2, steps=4)
    with pytest.raises(ValueError, match="2 elements"):  # one kmin a table
        batched_pgm_search(q, t, two[:1], two, t, seg, seg, d, d, d, d, e, levels=1, steps=4)
