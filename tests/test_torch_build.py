"""The PyTorch port's index builds and lookups held against the JAX reference.

For every ported kind on every ``TABLE_KINDS`` table: the port's host
build must give the reference's leaves bit for bit (key leaves after
decoding the sign-flipped encoding), the same statics, ``space_bytes``
and ``nbytes``; and ``lookup(backend="kernel")`` / ``"ref"`` on the CPU
must give the reference's ``"pallas"`` / ``"ref"`` ranks on the edge
query mix.  The npz files of either package load in the other.
"""

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import numpy as np
import pytest
import torch

from repro import index as rix
from repro.core import true_ranks
from repro_torch import index as tix

from conftest import TABLE_KINDS, make_table
from test_torch_gpu import clamp_table

PORTED = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M")


def edge_queries(rng, table, n_random=200):
    """Exact keys, keys ± 1, uniform misses and the extremes (the mix of
    ``tests/test_kernels.py:_edge_queries``)."""
    keys = rng.choice(table, min(len(table), 150)).astype(np.uint64)
    with np.errstate(over="ignore"):
        extremes = np.array(
            [0, table.min() - np.uint64(1), table.min(), table.max(),
             table.max() + np.uint64(1), 2**64 - 1],
            dtype=np.uint64,
        )
    return np.concatenate(
        [
            keys,
            keys - np.uint64(1),
            keys + np.uint64(1),
            rng.integers(0, 2**64 - 1, n_random, dtype=np.uint64),
            extremes,
        ]
    ).astype(np.uint64)


def ref_leaves(idx) -> dict:
    return {k: np.asarray(v) for k, v in idx.arrays.items()}


def assert_same_index(ref, port):
    """Leaves bit for bit (dtype, shape, bytes), statics, space and nbytes."""
    want, got = ref_leaves(ref), port.to_numpy()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert port.kind == ref.kind
    assert port.static == ref.static
    assert port.space_bytes() == ref.space_bytes()
    assert port.nbytes() == ref.nbytes()


def test_registry_order_matches_reference():
    # every kind of the reference, in its order: RS and BTREE are held in
    # test_torch_rs_btree.py, the updatable GAPPED (last) in
    # test_torch_updatable.py
    assert tix.kinds() == PORTED + ("RS", "BTREE", "GAPPED")
    assert rix.kinds() == tix.kinds()


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("kind", PORTED)
def test_build_and_lookup_match_reference(kind, table_kind):
    rng = np.random.default_rng(11)
    table = make_table(rng, table_kind, 8192)
    qs = edge_queries(rng, table)
    ref = rix.build(kind, table)
    port = tix.build(kind, table, device="cpu")
    assert_same_index(ref, port)

    assert port.arrays[next(iter(port.arrays))].device.type == "cpu"
    want = true_ranks(table, qs)
    got_kernel = port.lookup(table, qs, backend="kernel")
    got_ref = port.lookup(table, qs, backend="ref")
    assert got_kernel.dtype == got_ref.dtype == torch.int64
    np.testing.assert_array_equal(got_kernel.numpy(), np.asarray(ref.lookup(table, qs, backend="pallas")))
    np.testing.assert_array_equal(got_ref.numpy(), np.asarray(ref.lookup(table, qs, backend="ref")))
    np.testing.assert_array_equal(got_kernel.numpy(), want)


@pytest.mark.parametrize("kind", PORTED)
def test_pinned_clamp_table_matches_reference(kind):
    table, qs = clamp_table()
    ref = rix.build(kind, table)
    port = tix.build(kind, table, device="cpu")
    assert_same_index(ref, port)
    got = port.lookup(table, qs, backend="kernel").numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.lookup(table, qs, backend="pallas")))
    np.testing.assert_array_equal(got, true_ranks(table, qs))


@pytest.mark.parametrize("kind", PORTED)
def test_npz_round_trips_both_ways(kind, tmp_path):
    rng = np.random.default_rng(5)
    table = make_table(rng, "lognormal", 4096)
    qs = edge_queries(rng, table, n_random=50)
    ref = rix.build(kind, table)
    port = tix.build(kind, table, device="cpu")

    ref.save(tmp_path / "ref.npz")
    loaded = tix.Index.load(tmp_path / "ref.npz", device="cpu")
    assert_same_index(ref, loaded)
    assert loaded.info["n"] == ref.info["n"]

    port.save(tmp_path / "port.npz")
    back = rix.Index.load(tmp_path / "port.npz")
    assert_same_index(back, port)
    np.testing.assert_array_equal(
        np.asarray(back.lookup(table, qs, backend="pallas")),
        port.lookup(table, qs, backend="kernel").numpy(),
    )


def test_from_numpy_takes_reference_leaves():
    rng = np.random.default_rng(3)
    table = make_table(rng, "bursty", 2048)
    ref = rix.build(rix.PGMSpec(eps=16), table)
    port = tix.Index.from_numpy(ref.kind, ref.static, ref_leaves(ref), ref.info, device="cpu")
    assert_same_index(ref, port)
    # key leaves hold the order-preserving signed encoding
    keys = port.arrays["keys"]
    assert keys.dtype == torch.int64 and bool((keys[1:] >= keys[:-1]).all())


def test_from_numpy_rejects_unported_kinds_and_stray_uint64():
    """GAPPED, the last kind ported, loads from the reference's leaves;
    a kind neither package has and a stray uint64 leaf are refused."""
    rng = np.random.default_rng(4)
    table = make_table(rng, "uniform", 1024)
    gapped = rix.build("GAPPED", table, leaf_cap=64, delta_cap=128)
    port = tix.Index.from_numpy(gapped.kind, gapped.static, ref_leaves(gapped), gapped.info,
                                device="cpu")
    assert_same_index(gapped, port)
    # GAPPED's key leaves, its routing fences and delta included, hold the encoding
    for k in ("keys", "fences", "route", "delta"):
        assert port.arrays[k].dtype == torch.int64, k
    assert port.arrays["kmin"].dtype == torch.float64
    with pytest.raises(ValueError, match="unknown index kind"):
        tix.Index.from_numpy("NOPE", gapped.static, ref_leaves(gapped), device="cpu")
    ko = rix.build(rix.KOSpec(k=4), table)
    leaves = ref_leaves(ko)
    leaves["coef"] = leaves["fences"]  # a uint64 array where no key leaf belongs
    with pytest.raises(ValueError, match="not a key leaf"):
        tix.Index.from_numpy("KO", ko.static, leaves, device="cpu")


def test_core_fits_match_reference():
    """The host pieces not reached through ``build``: the RMI root fit,
    the CDFShop sweep and UB mining, PGM slopes from given starts, and the
    bi-criteria ε range (with the reference's 512-byte granularity)."""
    from repro.core import pgm as rpgm
    from repro.core import rmi as rrmi
    from repro.core import sy_rmi as rsy
    from repro_torch.core import pgm as tpgm
    from repro_torch.core import rmi as trmi
    from repro_torch.core import sy_rmi as tsy

    rng = np.random.default_rng(9)
    table = make_table(rng, "lognormal", 4096)
    for root in trmi.ROOT_TYPES:
        want, got = rrmi.fit_root(table, root), trmi.fit_root(table, root)
        for w, g in zip(want, got):
            assert np.asarray(w).tobytes() == np.asarray(g).tobytes(), root

    want_sweep, got_sweep = rsy.cdfshop_sweep(table), tsy.cdfshop_sweep(table)
    assert [(m.root_type, m.b, m.space_bytes()) for m in got_sweep] == [
        (m.root_type, m.b, m.space_bytes()) for m in want_sweep
    ]
    assert tsy.mine_ub(got_sweep) == rsy.mine_ub(want_sweep)

    keys_f64 = table.astype(np.float64)
    starts, slopes = tpgm.pla_segments(keys_f64, 16)
    want_starts, want_slopes = rpgm.pla_segments(keys_f64, 16)
    np.testing.assert_array_equal(starts, want_starts)
    assert slopes.tobytes() == want_slopes.tobytes()
    assert tpgm.segment_slopes(keys_f64, starts, 16).tobytes() == slopes.tobytes()

    assert tpgm.TPU_CLS_BYTES == rpgm.TPU_CLS_BYTES == 512
    for n, a in ((4096, 1.0), (10, 1.0), (1 << 24, 0.5)):
        assert tpgm.bicriteria_eps_bounds(n, a) == rpgm.bicriteria_eps_bounds(n, a)
