"""The port's RS and BTREE kinds held against the JAX reference.

For both kinds on every ``TABLE_KINDS`` table: the port's host build
gives the reference's leaves bit for bit (key leaves after decoding), the
same statics, ``space_bytes`` and ``nbytes``, and npz files load both
ways.  RS has its own kernel: the twin ``_rs_body`` that the kernel
wrapper runs on CPU tensors must give the ranks of the reference's fused
Pallas kernel in interpret mode, exactly (integer ranks, no tolerance).
BTREE answers through the model-free search, as the reference's does.
The pinned cases cover what RS is the first kind to need: the unsigned
radix prefix on a key span of 2^63 or more, and gathers that stay in
range at the edges of the radix table and of the knots.
"""

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import numpy as np
import pytest
import torch

from repro import index as rix
from repro.core import true_ranks
from repro_torch import index as tix
from repro_torch import kernels
from repro_torch.core import keys
from repro_torch.kernels import rs_search as trs

from conftest import TABLE_KINDS, make_table
from test_torch_build import assert_same_index, edge_queries
from test_torch_gpu import RS_SHIFT0, clamp_table, rs_span_table

KINDS = ("RS", "BTREE")


def _lookup_matches_reference(ref, port, table, qs):
    before = kernels.launches()
    got = port.lookup(table, qs, backend="kernel")
    assert kernels.launches() == before  # the CPU path runs the twin, launches nothing
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.lookup(table, qs, backend="pallas")))
    np.testing.assert_array_equal(got.numpy(), true_ranks(table, qs))
    ref_ranks = port.lookup(table, qs, backend="ref").numpy()
    np.testing.assert_array_equal(ref_ranks, np.asarray(ref.lookup(table, qs, backend="ref")))


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("kind", KINDS)
def test_build_and_lookup_match_reference(kind, table_kind):
    rng = np.random.default_rng(13)
    table = make_table(rng, table_kind, 8192)
    qs = edge_queries(rng, table)
    ref = rix.build(kind, table)
    port = tix.build(kind, table, device="cpu")
    assert_same_index(ref, port)
    _lookup_matches_reference(ref, port, table, qs)


@pytest.mark.parametrize("kind", KINDS)
def test_pinned_clamp_table_matches_reference(kind):
    table, qs = clamp_table()
    ref = rix.build(kind, table)
    port = tix.build(kind, table, device="cpu")
    assert_same_index(ref, port)
    _lookup_matches_reference(ref, port, table, qs)


@pytest.mark.parametrize("kind", KINDS)
def test_npz_round_trips_both_ways(kind, tmp_path):
    rng = np.random.default_rng(6)
    table = make_table(rng, "bursty", 4096)
    qs = edge_queries(rng, table, n_random=50)
    ref = rix.build(kind, table)
    port = tix.build(kind, table, device="cpu")

    ref.save(tmp_path / "ref.npz")
    loaded = tix.Index.load(tmp_path / "ref.npz", device="cpu")
    assert_same_index(ref, loaded)

    port.save(tmp_path / "port.npz")
    back = rix.Index.load(tmp_path / "port.npz")
    assert_same_index(back, port)
    np.testing.assert_array_equal(
        np.asarray(back.lookup(table, qs, backend="pallas")),
        port.lookup(table, qs, backend="kernel").numpy(),
    )


@pytest.mark.parametrize("spec", [tix.RSSpec(eps=8, r_bits=4), tix.RSSpec(eps=64, r_bits=16),
                                  tix.BTreeSpec(fanout=4), tix.BTreeSpec(fanout=64)])
def test_non_default_specs_match_reference(spec):
    rng = np.random.default_rng(14)
    table = make_table(rng, "lognormal", 5000)
    qs = edge_queries(rng, table)
    ref = rix.build(rix.spec_for(spec.kind, **spec.__dict__), table)
    port = tix.build(spec, table, device="cpu")
    assert_same_index(ref, port)
    _lookup_matches_reference(ref, port, table, qs)


def _numpy_prefix(table, qs, shift, r_bits):
    """The reference's prefix, on uint64."""
    kmin = table[0]
    d = np.maximum(qs, kmin) - kmin
    return np.minimum(d >> np.uint64(shift), np.uint64((1 << r_bits) - 1)).astype(np.int64)


def test_rs_prefix_is_unsigned_on_a_span_of_2_63_or_more():
    """Keys from near 0 to near 2^64: ``q - kmin`` has its top bit set for
    the upper half of the key space.  The prefix must be the unsigned
    shift; torch's arithmetic ``>>`` on the int64 difference would
    sign-extend it into a negative prefix and a wrong knot range."""
    rng = np.random.default_rng(15)
    table = rs_span_table()
    assert int(table[-1]) - int(table[0]) >= 2**63
    qs = edge_queries(rng, table)
    ref = rix.build(rix.RSSpec(eps=16, r_bits=10), table)
    port = tix.build(tix.RSSpec(eps=16, r_bits=10), table, device="cpu")
    assert_same_index(ref, port)
    shift, r_bits = int(ref.arrays["shift"]), port.s("r_bits")
    q = keys.encode(qs, "cpu")
    d_top_bit = (np.maximum(qs, table[0]) - table[0]) >= np.uint64(2**63)
    assert d_top_bit.sum() > 100  # the case the test is about

    got = trs.radix_prefix(q, port.arrays["kmin"], port.arrays["shift"], r_bits)
    np.testing.assert_array_equal(got.numpy(), _numpy_prefix(table, qs, shift, r_bits))
    _lookup_matches_reference(ref, port, table, qs)

    # a plain arithmetic shift is wrong exactly where the top bit is set
    kmin = port.arrays["kmin"]
    naive = torch.clamp((torch.maximum(q, kmin) - kmin) >> shift, max=(1 << r_bits) - 1)
    wrong = naive.numpy() != got.numpy()
    assert wrong.any() and not wrong[~d_top_bit].any()
    # fed to the kernel's stages (the twin's body) in place of the prefix
    impl = tix.impls.query_impl("RS")
    t = keys.encode(table, "cpu")
    args, kwargs = impl.operands(port, t, q)
    _, _, _, _, rk_kmin, rk_inv_span, *leaves = args
    u = keys.unit_f32(q, rk_kmin, rk_inv_span)
    naive_ranks = trs._rs_body(u, q, naive.to(torch.int32), t, *leaves, n=len(table),
                               ksteps=kwargs["ksteps"], steps=kwargs["steps"]).numpy()
    assert (naive_ranks != true_ranks(table, qs)).any()


def test_rs_prefix_with_shift_zero_clamps_huge_differences():
    """A key span below 2^r gives shift 0; a query far above the table
    then has an unsigned difference of 2^63 or more, which must clamp to
    the top prefix, not go negative."""
    table, qs = RS_SHIFT0
    ref = rix.build(rix.RSSpec(eps=4, r_bits=12), table)
    port = tix.build(tix.RSSpec(eps=4, r_bits=12), table, device="cpu")
    assert_same_index(ref, port)
    assert int(ref.arrays["shift"]) == 0
    got = trs.radix_prefix(keys.encode(qs, "cpu"), port.arrays["kmin"], port.arrays["shift"],
                           port.s("r_bits"))
    np.testing.assert_array_equal(got.numpy(), _numpy_prefix(table, qs, 0, port.s("r_bits")))
    _lookup_matches_reference(ref, port, table, qs)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 300])
def test_rs_gathers_stay_in_range(n):
    """The radix gather at ``prefix + 1`` and the knot gathers at ``j`` (the
    spline's segment ``j .. j + 1``) index inside their arrays for the
    extreme queries 0 and 2^64 - 1, down to one-knot tables, where the
    reference's ``jnp.take`` would fill or wrap instead."""
    rng = np.random.default_rng(16)
    table = np.unique(rng.integers(2**10, 2**60, n, dtype=np.uint64))
    qs = np.concatenate([edge_queries(rng, table, n_random=20),
                         np.array([0, 2**64 - 1], dtype=np.uint64)])
    ref = rix.build(rix.RSSpec(eps=4, r_bits=6), table)
    port = tix.build(tix.RSSpec(eps=4, r_bits=6), table, device="cpu")
    assert_same_index(ref, port)
    a = port.arrays
    prefix = trs.radix_prefix(keys.encode(qs, "cpu"), a["kmin"], a["shift"], port.s("r_bits"))
    assert int(prefix.min()) >= 0 and int(prefix.max()) + 1 < a["radix_table"].numel()
    # 2^64 - 1 takes the top prefix, whose upper bound is the radix table's last entry
    assert int(prefix.max()) == (1 << port.s("r_bits")) - 1
    _lookup_matches_reference(ref, port, table, qs)
    probes = []
    impl = tix.impls.query_impl("RS")
    args, kwargs = impl.operands(port, keys.encode(table, "cpu"), keys.encode(qs, "cpu"))
    impl.plain(*args, **kwargs, probes=probes)
    idx = torch.cat(probes)
    assert int(idx.min()) >= 0 and int(idx.max()) < len(table)


def test_rs_kernel_f32_widening():
    """Port twin of ``test_pgm_rs_kernel_f32_widening`` for RS: the f32
    re-encoding carries its own re-measured ε, which stays a sane bound
    (not the whole table) on a benign clustered table, and the re-encoded
    leaves and trip count equal the reference's."""
    from repro.kernels import ops as rops
    from repro.core import radix_spline as rrs
    from repro_torch.core import radix_spline as trs_core
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(7)
    table = make_table(rng, "clustered", 20000)
    rs = tix.build(tix.RSSpec(eps=16, r_bits=10), table, device="cpu")
    assert 1 <= int(rs.arrays["rk_eps"]) < len(table)
    assert rs.s("rk_epi") >= 4
    want, want_steps = rops.rs_kernel_arrays(rrs.build_rs(table, eps=16, r_bits=10), table)
    got, got_steps = tops.rs_kernel_arrays(trs_core.build_rs(table, eps=16, r_bits=10), table)
    assert got_steps == want_steps
    for k in ("u0", "slope"):
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
    for k in ("eps", "kmin", "inv_span"):
        assert got[k] == want[k], k
    qs = edge_queries(rng, table)
    np.testing.assert_array_equal(rs.lookup(table, qs, backend="kernel").numpy(),
                                  true_ranks(table, qs))


def test_core_rs_and_btree_fits_match_reference():
    from repro.core import btree as rbt
    from repro.core import radix_spline as rrs
    from repro_torch.core import btree as tbt
    from repro_torch.core import radix_spline as trs_core

    rng = np.random.default_rng(17)
    table = make_table(rng, "bursty", 6000)
    keys_f64 = table.astype(np.float64)
    for eps in (1, 8, 64):
        np.testing.assert_array_equal(trs_core.spline_knots(keys_f64, eps),
                                      rrs.spline_knots(keys_f64, eps))
    want, got = rrs.build_rs(table, eps=8, r_bits=9), trs_core.build_rs(table, eps=8, r_bits=9)
    assert (got.eps_eff, got.shift, got.r_bits, got.m) == (want.eps_eff, want.shift, want.r_bits,
                                                           want.m)
    assert got.space_bytes() == want.space_bytes()
    want_b, got_b = rbt.build_btree(table, fanout=8), tbt.build_btree(table, fanout=8)
    assert got_b.valid == want_b.valid and got_b.space_bytes() == want_b.space_bytes()
    for g, w in zip(got_b.levels, want_b.levels):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_rs_wrapper_validates_operands():
    """The wrapper takes the leaves as the index holds them (int64 knot
    ranks and radix table, f64 ``rk_kmin``/``rk_inv_span``) and raises on
    anything else, on the CPU as on the card."""
    t = keys.encode(np.arange(1, 65, dtype=np.uint64), "cpu")
    f64 = torch.ones(1, dtype=torch.float64)
    f = torch.zeros(8, dtype=torch.float32)
    i = torch.zeros(8, dtype=torch.int64)

    def call(r_bits=3, **changed):
        ops = dict(queries=t, table=t, kmin=t[:1], shift=torch.ones(1, dtype=torch.int64),
                   rk_kmin=f64, rk_inv_span=f64, knots=t[:8], u0=f, slope=f, ranks=i, radix=i,
                   m_valid=torch.ones(1, dtype=torch.int64), eps=torch.ones(1, dtype=torch.int32))
        ops.update(changed)
        return trs.rs_search(*ops.values(), r_bits=r_bits, ksteps=4, steps=4)

    assert call().shape == (64,)
    with pytest.raises(ValueError, match="8 elements"):  # ranks per knot
        call(ranks=i[:4])
    with pytest.raises(TypeError, match="int64"):  # no int32 copy of a leaf
        call(ranks=i.int())
    with pytest.raises(TypeError, match="float64"):
        call(rk_kmin=f64.float())
    with pytest.raises(ValueError, match="radix"):
        call(radix=i[:1])
    with pytest.raises(ValueError, match="r_bits"):
        call(r_bits=31)
