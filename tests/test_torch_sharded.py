"""The port's one-process sharded tier held against the JAX reference:
``ShardedIndex.build`` (stacked leaves, tables, fences, counts, offsets),
``sharded_lookup`` on every backend against the reference's
``sharded_lookup(mode="ref")`` and numpy, routing at fence keys, explicit
``bounds``, save/load across the two packages, and both branches of the
router ``kary_owner_route``.  Ranks are integers: equal, no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cdf import true_ranks
from repro.dist import sharded_index as rsi
from repro.kernels.kary_search import kary_owner_route as ref_route
from repro_torch import dist as tdist
from repro_torch import index as tix
from repro_torch import kernels
from repro_torch.core import keys
from repro_torch.dist import sharded_index as tsi
from repro_torch.kernels.kary_search import kary_owner_route

from conftest import make_queries, make_table

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE")
#: port backend -> reference backend
BACKEND_NAMES = {"xla": "xla", "bbs": "bbs", "kernel": "pallas", "ref": "ref"}


def _table(seed, n=6000, kind="lognormal"):
    return make_table(np.random.default_rng(seed), kind, n)


def _tier_queries(rng, table, fences):
    """``make_queries`` plus every fence key, each ± 1."""
    with np.errstate(over="ignore"):
        at = np.concatenate([fences, fences - np.uint64(1), fences + np.uint64(1)])
    return np.concatenate([make_queries(rng, table, 400), at]).astype(np.uint64)


def assert_same_tier(ref, port):
    """Stacked leaves (keys decoded), statics, info, tables, fences,
    counts and offsets equal bit for bit; space equal."""
    want = {k: np.asarray(v) for k, v in ref.index.arrays.items()}
    got = port.index.to_numpy()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert port.index.static == ref.index.static
    assert port.index.info == ref.index.info and port.info == ref.info
    np.testing.assert_array_equal(keys.decode(port.tables), np.asarray(ref.tables))
    np.testing.assert_array_equal(keys.decode(port.fences), np.asarray(ref.fences))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(port.offsets.numpy(), np.asarray(ref.offsets))
    assert port.counts.dtype == port.offsets.dtype == torch.int64
    assert port.space_bytes() == ref.space_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_build_and_lookup_match_reference(kind):
    """A 4-shard tier of a 6,000-key table (shards of 1,500 keys padded to
    2,048): the build equals the reference's, and ``sharded_lookup`` on
    every backend equals the reference's ``mode="ref"``, ``Index.lookup``
    on the whole table and numpy, fences included."""
    table = _table(KINDS.index(kind))
    ref = rsi.ShardedIndex.build(kind, table, 4)
    port = tsi.ShardedIndex.build(kind, table, 4, device="cpu")
    assert_same_tier(ref, port)
    rng = np.random.default_rng(KINDS.index(kind))
    qs = _tier_queries(rng, table, np.asarray(ref.fences))
    want = true_ranks(table, qs)
    whole = tix.build(kind, table, device="cpu").lookup(table, qs).numpy()
    np.testing.assert_array_equal(whole, want)
    for backend, ref_backend in BACKEND_NAMES.items():
        got = tsi.sharded_lookup(port, qs, backend=backend, mode="ref")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(rsi.sharded_lookup(ref, qs, backend=ref_backend, mode="ref")),
            err_msg=backend)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)


@pytest.mark.parametrize("kind", ("KO", "SY-RMI", "PGM", "RS"))
def test_tier_of_more_than_129_shards(kind):
    """160 shards: the router takes its k-ary branch (more than 128
    boundaries); every backend still equals the reference and numpy."""
    table = _table(40 + len(kind), n=16000, kind="bursty")
    ref = rsi.ShardedIndex.build(kind, table, 160)
    port = tsi.ShardedIndex.build(kind, table, 160, device="cpu")
    assert_same_tier(ref, port)
    rng = np.random.default_rng(7)
    qs = _tier_queries(rng, table, np.asarray(ref.fences))
    want = true_ranks(table, qs)
    for backend, ref_backend in BACKEND_NAMES.items():
        got = tsi.sharded_lookup(port, qs, backend=backend).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(rsi.sharded_lookup(ref, qs, backend=ref_backend, mode="ref")),
            err_msg=backend)
        np.testing.assert_array_equal(got, want, err_msg=backend)


def test_routing_at_fence_keys():
    """Exact fence keys route to the shard that starts with them; queries
    outside the table resolve to NO_PRED / n - 1; a fence key's global rank
    is its shard's offset."""
    table = _table(50)
    sidx = tsi.ShardedIndex.build("RMI", table, 4, b=64, device="cpu")
    fences = keys.decode(sidx.fences)
    owners = tsi.route_owners(sidx.fences, sidx.fences)
    assert owners.dtype == torch.int32
    np.testing.assert_array_equal(owners.numpy(), np.arange(4))
    qs = np.concatenate([fences, fences - np.uint64(1), fences + np.uint64(1),
                         np.array([0, table.min(), table.max(), 2**64 - 1], np.uint64)])
    got = tsi.sharded_lookup(sidx, qs).numpy()
    np.testing.assert_array_equal(got, true_ranks(table, qs))
    assert got[len(fences)] == tsi.NO_PRED or fences[0] == 0  # below the global min
    np.testing.assert_array_equal(got[:4], sidx.offsets.numpy())
    ref = rsi.ShardedIndex.build("RMI", table, 4, b=64)
    np.testing.assert_array_equal(
        owners.numpy(), np.asarray(rsi.route_owners(ref.fences, ref.fences)))


def test_explicit_bounds_and_their_validation():
    table = _table(51)
    n = len(table)
    bounds = [0, 17, 2500, 2501, n]
    ref = rsi.ShardedIndex.build("PGM", table, 4, bounds=bounds, eps=16)
    port = tsi.ShardedIndex.build("PGM", table, 4, bounds=np.asarray(bounds), eps=16,
                                  device="cpu")
    assert_same_tier(ref, port)
    np.testing.assert_array_equal(port.counts.numpy(), np.diff(bounds))
    qs = _tier_queries(np.random.default_rng(51), table, keys.decode(port.fences))
    for backend in ("xla", "bbs", "kernel"):
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=backend).numpy(),
                                      true_ranks(table, qs), err_msg=backend)
    for bad in ([0, 10, n], [1, 10, 20, 30, n], [0, 10, 10, 30, n], [0, 10, 20, 30, n - 1]):
        with pytest.raises(ValueError, match="bounds must be"):
            tsi.ShardedIndex.build("PGM", table, 4, bounds=bad, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        tsi.ShardedIndex.build("PGM", table, 0, device="cpu")


@pytest.mark.parametrize("kind", ("PGM", "RS", "BTREE"))
def test_save_load_across_packages(kind, tmp_path):
    table = _table(52, kind="clustered")
    ref = rsi.ShardedIndex.build(kind, table, 3)
    port = tsi.ShardedIndex.build(kind, table, 3, device="cpu")
    ref.save(tmp_path / "ref.npz")
    port.save(tmp_path / "port.npz")
    for name in ("ref.npz", "port.npz"):  # each package reads either file
        assert_same_tier(rsi.ShardedIndex.load(tmp_path / name),
                         tsi.ShardedIndex.load(tmp_path / name, device="cpu"))
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("nb", (0, 1, 3, 128, 129, 300))
def test_kary_owner_route_both_branches(nb):
    """Up to 128 boundaries one compare-and-sum, beyond that a k-ary
    search: owners (int32) equal the reference's and ``#{b <= q}``."""
    rng = np.random.default_rng(nb)
    bounds = np.unique(rng.integers(0, 2**64 - 1, nb, dtype=np.uint64))
    with np.errstate(over="ignore"):
        qs = np.concatenate([bounds, bounds - np.uint64(1), bounds + np.uint64(1),
                             rng.integers(0, 2**64 - 1, 500, dtype=np.uint64),
                             np.array([0, 2**64 - 1], np.uint64)])
    got = kary_owner_route(keys.encode(bounds, "cpu"), keys.encode(qs, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_route(jnp.asarray(bounds),
                                                                    jnp.asarray(qs))))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(bounds, qs, side="right"))


def test_kernel_tier_is_one_batched_call_and_later_modes_raise(monkeypatch):
    """``backend="kernel"`` answers the whole tier with one call of the
    lookup body on the stacked ``(n_shards, m)`` tables, which is one
    launch of the kind's batched kernel on the card (on the CPU its twin
    runs and nothing launches); the collective modes without a context
    whose ``tp`` extent equals the shard count raise the reference's mesh
    error, and a telemetry-on call answers the same with no second call of
    the lookup body."""
    table = _table(53)
    sidx = tsi.ShardedIndex.build("SY-RMI", table, 4, device="cpu")
    calls = []

    def counting(index, tables, queries, backend):
        calls.append((tuple(tables.shape), tuple(queries.shape), backend))
        return tix.lookup_impl(index, tables, queries, backend)

    monkeypatch.setattr(tsi, "lookup_impl", counting)
    qs = make_queries(np.random.default_rng(53), table, 200)
    kernels.reset_launches()
    got = tsi.sharded_lookup(sidx, qs, backend="kernel").numpy()
    assert calls == [((4, sidx.tables.shape[1]), (4, len(qs)), "kernel")]
    assert kernels.launches()["batched_rmi_search"] == 0  # CPU tensors run the twin
    np.testing.assert_array_equal(got, true_ranks(table, qs))
    assert tsi.MODES == rsi.MODES and tdist.DROPPED == rsi.DROPPED
    assert tdist.NO_PRED == rsi.NO_PRED
    assert tsi.TIER_BACKENDS == ("xla", "bbs", "kernel", "ref")
    class TwoWay:  # a context whose tp extent (2) is not the tier's 4 shards
        def n(self, logical):
            return 2

        def mesh_axes(self, logical):
            return ("model",)

    for kwargs, msg in (({"mode": "a2a"}, r"mesh tp extent \(1\) to equal n_shards \(4\)"),
                        ({"mode": "allgather"}, r"mesh tp extent \(1\)"),
                        ({"ctx": TwoWay(), "mode": "a2a"}, r"mesh tp extent \(2\)"),
                        ({"mode": "bogus"}, "unknown mode"),
                        ({"backend": "pallas"}, "unknown tier backend")):
        with pytest.raises(ValueError, match=msg):
            tsi.sharded_lookup(sidx, qs, **kwargs)
    with pytest.raises(ValueError, match=r"mesh tp extent \(1\)"):
        rsi.sharded_lookup(rsi.ShardedIndex.build("SY-RMI", table, 4), qs, mode="a2a")
    calls.clear()
    np.testing.assert_array_equal(tsi.sharded_lookup(sidx, qs, telemetry=True).numpy(), got)
    assert len(calls) == 1
    # with a context of another extent, "auto" stays the one-process sweep
    np.testing.assert_array_equal(tsi.sharded_lookup(sidx, qs, TwoWay()).numpy(), got)
    with pytest.raises(ValueError, match="flat"):
        tsi.sharded_lookup(sidx, keys.encode(qs[:200].reshape(2, 100), "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsi.ShardedIndex.build("PGM", table, 2)
