"""The port's updatable GAPPED kind held against the JAX reference.

The same seeded numpy inputs go through both packages: the build's
leaves, statics, info, ``space_bytes`` and ``nbytes``; the mutation
cases of ``tests/test_updatable.py`` (empty batch, fence keys, keys just
below the fences and below the minimum, duplicates within a batch and
across tiers, an overfull leaf diverted wholesale, a delta filled to
exactly its capacity, ``NeedsRebuild`` with and without
``auto_compact``), where after every batch the leaves, the
``InsertReport`` and the ``xla``/``bbs``/``ref`` ranks equal the
reference's and ``kernel`` raises; ``compact`` and ``live_keys``; npz
files across packages; ``build_many``; the sharded tier's build,
``insert_into_shard``, ``compact_shard``, refusals, ``shard_build_table``,
``refresh_shard`` and ``rebalance_shards``; and the trouble spots of the
port (saturating pads in the encoded key space, the f64 root model above
2^53 and 2^63, the reference's pow2 batch padding, a large absorb).
Ranks, keys and counts are integers: equal, no tolerance.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import index as rix
from repro import tune as rtune
from repro.core.cdf import true_ranks
from repro.dist import sharded_index as rsi
from repro.index import updatable as rupd
from repro_torch import index as tix
from repro_torch import tune as ttune
from repro_torch.core import keys
from repro_torch.dist import sharded_index as tsi
from repro_torch.index import updatable as tupd

from conftest import TABLE_KINDS, make_queries, make_table
from test_torch_gpu import fresh_keys, packed_batch

MAXKEY = np.uint64(2**64 - 1)
GAPPED_BACKENDS = ("xla", "bbs", "ref")
#: a placeholder table: GAPPED answers from its own leaves
NO_TABLE = np.zeros(1, dtype=np.uint64)


def leaves(idx) -> dict:
    """An index's leaves in the reference's numpy layout, either package."""
    if isinstance(idx, tix.Index):
        return idx.to_numpy()
    return {k: np.asarray(v) for k, v in idx.arrays.items()}


def assert_same_leaves(ref, port, what=""):
    want, got = leaves(ref), leaves(port)
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (what, k)
        assert got[k].tobytes() == want[k].tobytes(), (what, k)
    assert port.static == ref.static, what


def assert_same_ranks(ref, port, qs, what=""):
    """``xla``/``bbs``/``ref`` equal the reference's; ``kernel`` raises."""
    for b in GAPPED_BACKENDS:
        want = np.asarray(ref.lookup(jnp.zeros(1, jnp.uint64), jnp.asarray(qs), backend=b))
        got = port.lookup(NO_TABLE, qs, backend=b)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what} {b}")
    with pytest.raises(ValueError, match="supports backends"):
        port.lookup(NO_TABLE, qs)


def probe_queries(rng, live):
    """Every live key, each +- 1, random keys, 0 and the max key."""
    with np.errstate(over="ignore"):
        return np.concatenate([live, live - np.uint64(1), live + np.uint64(1),
                               rng.integers(0, 2**64 - 1, 200, dtype=np.uint64),
                               np.array([0, MAXKEY], dtype=np.uint64)])


def assert_same_report(ref_report, port_report):
    assert dataclasses.astuple(port_report) == dataclasses.astuple(ref_report)
    assert port_report.delta_fill == ref_report.delta_fill
    assert port_report.needs_compaction == ref_report.needs_compaction


# -- registry, build ---------------------------------------------------------------------


def test_registry_and_capability_match_reference():
    assert tix.kinds() == rix.kinds() and tix.kinds()[-1] == "GAPPED"
    assert tix.updatable_kinds() == rix.updatable_kinds() == ("GAPPED",)
    for n in (10, 64, 100, 300, 5000):
        assert tix.GappedSpec.default_grid(n) == tuple(
            tix.GappedSpec(**dataclasses.asdict(s)) for s in rix.GappedSpec.default_grid(n))
    assert tix.spec_for("GAPPED", leaf_cap=64) == tix.GappedSpec(leaf_cap=64)
    table = np.arange(1, 65, dtype=np.uint64) * np.uint64(977)
    g = tix.build("GAPPED", table, device="cpu", leaf_cap=16)
    assert g.backends() == rix.build("GAPPED", table, leaf_cap=16).backends() == GAPPED_BACKENDS
    assert tix.build("RMI", table, device="cpu", b=8).backends() == tix.BACKENDS
    static = tix.build("RMI", table, device="cpu", b=8)
    with pytest.raises(TypeError, match="updatable"):
        static.insert_batch(np.asarray([5], dtype=np.uint64))
    with pytest.raises(TypeError, match="updatable"):
        static.compact()


@pytest.mark.parametrize("leaf_cap", (16, 64, 256))
@pytest.mark.parametrize("table_kind", TABLE_KINDS)
def test_build_matches_reference(table_kind, leaf_cap):
    rng = np.random.default_rng(leaf_cap)
    table = make_table(rng, table_kind, 5000)
    spec = {"leaf_cap": leaf_cap, "fill": 0.75, "delta_cap": 300}
    ref = rix.build("GAPPED", table, **spec)
    port = tix.build("GAPPED", table, device="cpu", **spec)
    assert_same_leaves(ref, port)
    for k in ("name", "n", "n_leaves", "leaf_cap", "delta_cap", "root_eps"):
        assert port.info[k] == ref.info[k], k
    assert port.space_bytes() == ref.space_bytes() and port.nbytes() == ref.nbytes()
    qs = make_queries(rng, table, 500)
    assert_same_ranks(ref, port, qs)
    want = true_ranks(table, qs)
    np.testing.assert_array_equal(port.lookup(table, qs, backend="xla").numpy(), want)
    lo, hi = port.intervals(table, qs)
    np.testing.assert_array_equal(lo.numpy(), want)
    assert torch.equal(lo, hi)


# -- mutation: the reference's cases, replayed on both packages ---------------------------


def _fences_of(table, spec):
    return np.asarray(rix.build("GAPPED", table, **spec).arrays["fences"])


def _keys(n, step):
    """The keys ``step, 2 step, ..., n step``."""
    return np.arange(1, n + 1, dtype=np.uint64) * np.uint64(step)


def _case_empty():
    return _keys(64, 13), dict(leaf_cap=16, fill=0.5, delta_cap=32), [np.asarray([], np.uint64)]


def _case_fence_keys():
    table, spec = _keys(128, 101), dict(leaf_cap=16, fill=0.5, delta_cap=64)
    return table, spec, [_fences_of(table, spec)]


def _case_below_fences():
    table, spec = _keys(128, 100), dict(leaf_cap=16, fill=0.5, delta_cap=64)
    return table, spec, [np.setdiff1d(_fences_of(table, spec)[1:] - np.uint64(1), table)]


def _case_duplicates():
    return _keys(64, 1000), dict(leaf_cap=8, fill=0.5, delta_cap=32), [
        np.asarray([1500, 2500], dtype=np.uint64),
        np.asarray([3500, 3500, 1000, 1500, 4500], dtype=np.uint64)]


def _case_below_min():
    table = (np.arange(1, 65, dtype=np.uint64) + np.uint64(100)) * np.uint64(50)
    return table, dict(leaf_cap=16, fill=0.5, delta_cap=32), [np.asarray([7, 23], dtype=np.uint64)]


def _crowded():
    return _keys(64, 1000), dict(leaf_cap=8, fill=0.5, delta_cap=16)


def _case_overfull_leaf():
    table, spec = _crowded()
    return table, spec, [np.uint64(1000) + np.arange(1, 9, dtype=np.uint64) * np.uint64(100)]


def _case_delta_exact():
    """b1, b2 fill the delta to exactly 16; b3 overflows it: refused
    without ``auto_compact``, folded first with it."""
    table, spec = _crowded()
    b = [np.uint64(base) + _keys(8, 100) for base in (1000, 2000)]
    b3 = np.uint64(3000) + np.arange(1, 6, dtype=np.uint64) * np.uint64(20)
    return table, spec, [b[0], b[1], (b3, False), b3, "compact"]


def _case_capacity():
    """Full leaves (fill 1.0), a delta of 4: random batches until the live
    set exceeds the leaves, the ``NeedsRebuild`` of compaction."""
    table = np.arange(1, 9, dtype=np.uint64) * np.uint64(1 << 32)
    rng = np.random.default_rng(5)
    return table, dict(leaf_cap=4, fill=1.0, delta_cap=4), [
        rng.integers(1, 1 << 35, size=4, dtype=np.uint64) for _ in range(12)]


def _case_random():
    rng = np.random.default_rng(77)
    table = np.unique(rng.integers(1, 2**62, size=2000, dtype=np.uint64))
    fresh = np.setdiff1d(np.unique(rng.integers(1, 2**62, size=300, dtype=np.uint64)), table)
    return table, dict(leaf_cap=64, fill=0.75, delta_cap=256), [fresh, "compact", fresh[::3]]


def _case_large_absorb():
    """A batch of 4,096 keys (a few thousand rows touched): the port merges
    each touched leaf in an ``(n_touched, cap)`` block, the reference in a
    ``(batch, batch)`` matrix; the rows must be equal."""
    rng = np.random.default_rng(78)
    table = make_table(rng, "lognormal", 16384)
    batch = np.concatenate([fresh_keys(rng, table, 3800), rng.choice(table, 296)])
    return table, dict(leaf_cap=32, fill=0.5, delta_cap=512), [batch, fresh_keys(rng, table, 900)]


def _case_top_of_key_space():
    """Live keys at 2^64 - 2 and 2^64 - 2 - cap and around 2^63: the pads
    saturate at the max key in the encoded space."""
    top = np.uint64(2**64 - 2)
    table = np.unique(np.concatenate([
        np.uint64(2**63 - 40) + np.arange(0, 80, 3, dtype=np.uint64),
        top - np.arange(0, 40, 5, dtype=np.uint64), np.array([top - np.uint64(16)], np.uint64)]))
    spec = dict(leaf_cap=16, fill=0.5, delta_cap=32)
    first = np.array([top - np.uint64(1), top - np.uint64(3), 2**63 - 1, 2**63], np.uint64)
    return table, spec, [first, "compact", np.array([top - np.uint64(17), top - np.uint64(2)],
                                                    np.uint64)]


def _case_max_key_in_batch():
    """The reference's pow2 batch padding with the max key: a batch that
    holds 2^64 - 1 itself and duplicates at its tail."""
    table = np.arange(1, 65, dtype=np.uint64) * np.uint64(1 << 40)
    return table, dict(leaf_cap=16, fill=0.5, delta_cap=32), [
        np.array([5, MAXKEY, 77, MAXKEY, 77], dtype=np.uint64),
        np.array([MAXKEY - np.uint64(1), 6, 6, 6, 6], dtype=np.uint64)]


def _case_f64_root():
    """Keys above 2^53 and 2^63, where the f64 root model rounds: compaction
    re-measures ``root_eps`` with the query path's arithmetic."""
    rng = np.random.default_rng(79)
    table = np.unique(np.concatenate([
        np.uint64(2**63) + rng.integers(0, 2**62, 1500, dtype=np.uint64),
        np.uint64(2**53) + rng.integers(0, 2**20, 500, dtype=np.uint64)]))
    fresh = fresh_keys(rng, table, 700)
    return table, dict(leaf_cap=16, fill=0.75, delta_cap=128), [fresh[::2], "compact", fresh[1::2],
                                                                "compact"]


MUTATION_CASES = {
    "empty": _case_empty,
    "fence_keys": _case_fence_keys,
    "below_fences": _case_below_fences,
    "duplicates": _case_duplicates,
    "below_min": _case_below_min,
    "overfull_leaf": _case_overfull_leaf,
    "delta_exact": _case_delta_exact,
    "capacity": _case_capacity,
    "random": _case_random,
    "large_absorb": _case_large_absorb,
    "top_of_key_space": _case_top_of_key_space,
    "max_key_in_batch": _case_max_key_in_batch,
    "f64_root": _case_f64_root,
}


@pytest.mark.parametrize("case", list(MUTATION_CASES))
def test_mutation_matches_reference(case):
    """Each step on both packages: the leaves, the report and the ranks of
    every backend equal the reference's after it (``kernel`` raises), the
    input index is left as it was, and a ``NeedsRebuild`` of the reference
    is the port's too, with the same message."""
    rng = np.random.default_rng(len(case))
    table, spec, steps = MUTATION_CASES[case]()
    ref = rix.build("GAPPED", table, **spec)
    port = tix.build("GAPPED", table, device="cpu", **spec)
    assert_same_leaves(ref, port, "build")
    raised = 0
    for i, step in enumerate(steps):
        before = leaves(port)
        if isinstance(step, str):
            try:
                new_ref = ref.compact()
            except rix.NeedsRebuild as e:
                with pytest.raises(tix.NeedsRebuild, match=re.escape(str(e))):
                    port.compact()
                raised += 1
                continue
            new_port = port.compact()
        else:
            batch, auto = step if isinstance(step, tuple) else (step, True)
            try:
                new_ref, ref_report = ref.insert_batch(batch, auto_compact=auto)
            except rix.NeedsRebuild as e:
                with pytest.raises(tix.NeedsRebuild, match=re.escape(str(e))):
                    port.insert_batch(batch, auto_compact=auto)
                assert_same_leaves(ref, port, f"step {i} refused")
                raised += 1
                continue
            new_port, port_report = port.insert_batch(batch, auto_compact=auto)
            assert_same_report(ref_report, port_report)
            if len(batch) == 0:
                assert new_port is port
        after = leaves(port)  # the input index is left as it was
        assert all(before[k].tobytes() == after[k].tobytes() for k in before), f"step {i}"
        ref, port = new_ref, new_port
        assert_same_leaves(ref, port, f"step {i}")
        live = rupd.live_keys(ref)
        np.testing.assert_array_equal(tupd.live_keys(port), live)
        qs = probe_queries(rng, live)
        assert_same_ranks(ref, port, qs, f"step {i}")
        np.testing.assert_array_equal(port.lookup(NO_TABLE, qs, backend="xla").numpy(),
                                      true_ranks(live, qs))
    if case in ("capacity", "delta_exact"):
        assert raised >= 1


def test_delta_exact_reports_and_needs_rebuild_message():
    """The reference's exact-capacity corner, on the port alone: a delta
    filled to exactly 16 does not raise, sets ``needs_compaction``; the
    next overflowing batch raises without ``auto_compact`` (index intact)
    and compacts with it."""
    table, spec = _crowded()
    g = tix.build("GAPPED", table, device="cpu", **spec)
    b1, b2 = (np.uint64(base) + np.arange(1, 9, dtype=np.uint64) * np.uint64(100)
              for base in (1000, 2000))
    g, r1 = g.insert_batch(b1)
    g, r2 = g.insert_batch(b2)
    assert r1.overflowed == r2.overflowed == 8 and r2.delta_count == r2.delta_cap == 16
    assert r2.delta_fill == 1.0 and r2.needs_compaction and not r2.compacted
    b3 = np.uint64(3000) + np.arange(1, 6, dtype=np.uint64) * np.uint64(20)
    before = g.to_numpy()
    with pytest.raises(tix.NeedsRebuild, match="compact"):
        g.insert_batch(b3, auto_compact=False)
    assert all(before[k].tobytes() == v.tobytes() for k, v in g.to_numpy().items())
    g2, r3 = g.insert_batch(b3)
    assert r3.compacted and r3.absorbed + r3.overflowed == 5
    merged = np.union1d(np.union1d(table, np.concatenate([b1, b2])), b3)
    np.testing.assert_array_equal(tupd.live_keys(g2), merged)


def test_encoded_key_tensors_insert_like_numpy():
    """``insert_batch`` takes an encoded tensor as well as uint64 numpy."""
    table, spec = _crowded()
    g = tix.build("GAPPED", table, device="cpu", **spec)
    batch = np.asarray([1500, 2500, 64000, 1000], dtype=np.uint64)
    a, ra = g.insert_batch(batch)
    b, rb = g.insert_batch(keys.encode(batch, "cpu"))
    assert ra == rb and all(x.tobytes() == y.tobytes() for x, y in
                            zip(a.to_numpy().values(), b.to_numpy().values()))


def test_npz_round_trips_after_inserts(tmp_path):
    rng = np.random.default_rng(80)
    table = make_table(rng, "uniform", 3000)
    spec = dict(leaf_cap=32, fill=0.5, delta_cap=128)
    ref = rix.build("GAPPED", table, **spec)
    port = tix.build("GAPPED", table, device="cpu", **spec)
    batch = np.concatenate([fresh_keys(rng, table, 500), packed_batch(port, table, 8)])
    ref, _ = ref.insert_batch(batch)
    port, _ = port.insert_batch(batch)
    assert int(port.arrays["delta_count"]) > 0
    ref.save(tmp_path / "ref.npz")
    port.save(tmp_path / "port.npz")
    loaded = tix.Index.load(tmp_path / "ref.npz", device="cpu")
    back = rix.Index.load(tmp_path / "port.npz")
    assert_same_leaves(ref, loaded)
    assert_same_leaves(back, port)
    qs = probe_queries(rng, rupd.live_keys(ref))
    assert_same_ranks(ref, loaded, qs)
    assert_same_ranks(back, port, qs)
    # and the loaded index keeps mutating like the reference's
    more = fresh_keys(rng, rupd.live_keys(ref), 300)
    r2, rr = back.insert_batch(more)
    p2, pr = loaded.insert_batch(more)
    assert_same_report(rr, pr)
    assert_same_leaves(r2, p2)


# -- the pieces the trouble spots name --------------------------------------------------------


def test_saturating_pad_in_the_encoded_space():
    """``_sat_add`` is the reference's uint64 ``x + min(over, MAX - x)``
    near the top of the key space, around 2^63 and at 0."""
    xs = np.array([0, 1, 2**63 - 2, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2 - 256, 2**64 - 2 - 16,
                   2**64 - 3, 2**64 - 2, 2**64 - 1], dtype=np.uint64)
    over = np.arange(0, 257, dtype=np.uint64)
    got = keys.decode(tupd._sat_add(keys.encode(xs, "cpu")[:, None],
                                    torch.from_numpy(over.astype(np.int64))[None, :]))
    want = xs[:, None] + np.minimum(over[None, :], (MAXKEY - xs)[:, None])
    np.testing.assert_array_equal(got, want)


def test_route_matches_reference_above_2_53_and_2_63():
    """The owner leaf of each query: the f64 root model (two rounded
    operations, the clip before the int64 cast) then the bounded search,
    equal to the reference's ``_route`` on keys past 2^53 and 2^63."""
    rng = np.random.default_rng(81)
    table = np.unique(np.concatenate([
        np.uint64(2**63) + rng.integers(0, 2**63 - 1, 3000, dtype=np.uint64),
        np.uint64(2**53) + rng.integers(0, 2**30, 1000, dtype=np.uint64)]))
    spec = dict(leaf_cap=16, fill=0.75, delta_cap=64)
    ref = rix.build("GAPPED", table, **spec)
    port = tix.build("GAPPED", table, device="cpu", **spec)
    qs = probe_queries(rng, table)
    want = np.asarray(rupd._route(ref, jnp.asarray(qs)))
    got = tupd._route(tupd._lifted(port), keys.encode(qs, "cpu")[None], port.s("ksteps"))[0]
    np.testing.assert_array_equal(got.numpy(), want)


# -- the batched path --------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", ("equal", "ragged"))
def test_build_many_matches_reference(lengths):
    """Equal tables fit raw (``unstack`` equals per-table builds); ragged
    ones fit on the padded tables, where the count clamp hides the live
    pad keys.  Stacked leaves and the ranks of every claimed backend equal
    the reference's; ``kernel`` raises."""
    rng = np.random.default_rng(82)
    sizes = (3000, 3000, 3000) if lengths == "equal" else (3000, 700, 1800)
    tables = [make_table(rng, k, n) for k, n in zip(("uniform", "lognormal", "bursty"), sizes)]
    tables = [t[:min(len(x) for x in tables)] for t in tables] if lengths == "equal" else tables
    spec = dict(leaf_cap=32, fill=0.75, delta_cap=64)
    ref = rtune.build_many("GAPPED", tables, **spec)
    port = ttune.build_many("GAPPED", tables, device="cpu", **spec)
    assert_same_leaves(ref.index, port.index)
    qs = make_queries(rng, np.concatenate(tables), 600)
    for b in GAPPED_BACKENDS:
        got = port.lookup(qs, backend=b).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.lookup(qs, backend=b)), err_msg=b)
        for i, t in enumerate(tables):
            np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=b)
    with pytest.raises(ValueError, match="supports backends"):
        port.lookup(qs)
    if lengths == "equal":
        for t, one in zip(tables, port.unstack()):
            assert_same_leaves(tix.build("GAPPED", t, device="cpu", **spec), one)


# -- the sharded tier -----------------------------------------------------------------------------


SPEC = rix.GappedSpec(leaf_cap=64, fill=0.75, delta_cap=128)
TSPEC = tix.GappedSpec(leaf_cap=64, fill=0.75, delta_cap=128)


def assert_same_tier(ref, port, live_lasts):
    assert_same_leaves(ref.index, port.index)
    np.testing.assert_array_equal(keys.decode(port.tables), np.asarray(ref.tables))
    np.testing.assert_array_equal(keys.decode(port.fences), np.asarray(ref.fences))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(port.offsets.numpy(), np.asarray(ref.offsets))
    np.testing.assert_array_equal(keys.decode(port.lasts), live_lasts)


def _ref_lasts(ref):
    return np.array([rupd.live_keys(ref.shard(s))[-1] for s in range(ref.n_shards)], np.uint64)


def _mutated_pair(seed, n=3000, n_shards=4, packed_shard=2):
    """A reference and a port GAPPED tier, fresh keys routed into every
    shard and a batch packed into one leaf of ``packed_shard`` (its delta
    populated), on both; returns them, the live keys and the reports."""
    rng = np.random.default_rng(seed)
    table = np.unique(rng.integers(1, 2**62, size=n, dtype=np.uint64))
    ref = rsi.ShardedIndex.build(SPEC, table, n_shards=n_shards)
    port = tsi.ShardedIndex.build(TSPEC, table, n_shards, device="cpu")
    assert_same_tier(ref, port, _ref_lasts(ref))
    fresh = fresh_keys(rng, table, n // 8)
    owners = np.asarray(rsi.route_owners(ref.fences, fresh))
    np.testing.assert_array_equal(tsi.route_owners(port.fences, keys.encode(fresh, "cpu")).numpy(),
                                  owners)
    reports = []
    for s in range(n_shards):
        ref, rr = rsi.insert_into_shard(ref, s, fresh[owners == s])
        back, pr = tsi.insert_into_shard(port, s, fresh[owners == s])
        assert back is port
        assert_same_report(rr, pr)
        reports.append(pr)
    live = np.union1d(table, fresh)
    packed = packed_batch(port.shard(packed_shard), live, 8)
    ref, rr = rsi.insert_into_shard(ref, packed_shard, packed)
    _, pr = tsi.insert_into_shard(port, packed_shard, packed)
    assert_same_report(rr, pr)
    assert pr.overflowed == len(packed) > 0
    return rng, table, ref, port, np.union1d(live, packed), reports


def test_sharded_insert_and_compact_match_reference():
    rng, table, ref, port, live, _ = _mutated_pair(83)
    assert_same_tier(ref, port, _ref_lasts(ref))
    qs = np.concatenate([probe_queries(rng, live), keys.decode(port.fences)])
    want = true_ranks(live, qs)
    for b in GAPPED_BACKENDS:
        got = rsi.sharded_lookup(ref, qs, mode="ref", backend=b)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=b)
        got = tsi.sharded_lookup(port, qs, backend=b)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=b)
    with pytest.raises(ValueError, match="supports backends"):
        tsi.sharded_lookup(port, qs)
    for s in range(port.n_shards):
        ref = rsi.compact_shard(ref, s)
        assert tsi.compact_shard(port, s) is port
    assert int(port.index.arrays["delta_count"].sum()) == 0
    assert_same_tier(ref, port, _ref_lasts(ref))
    for b in GAPPED_BACKENDS:
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=b).numpy(), want)
    # the vectors equal those of a tier built on the live keys
    counts = port.counts.numpy()
    rebuilt = tsi.ShardedIndex.build(TSPEC, live, port.n_shards, device="cpu",
                                     bounds=np.concatenate([[0], np.cumsum(counts)]))
    for k in ("counts", "offsets", "fences", "lasts"):
        assert torch.equal(getattr(port, k), getattr(rebuilt, k)), k


def test_sharded_refusals_leave_the_tier_intact():
    """The fence ``ValueError`` (the reference's message), ``NeedsRebuild``
    when a shard's capacity is exhausted, ``TypeError`` on a static tier
    and a shard out of range: each raises, and the tier is unchanged."""
    rng, table, ref, port, live, _ = _mutated_pair(84)
    snap = ([v.clone() for v in port.index.arrays.values()],
            [t.clone() for t in (port.tables, port.fences, port.counts, port.offsets, port.lasts)])

    def intact():
        for a, b in zip(snap[0], port.index.arrays.values()):
            assert torch.equal(a, b)
        for a, b in zip(snap[1], (port.tables, port.fences, port.counts, port.offsets, port.lasts)):
            assert torch.equal(a, b)

    stray = np.asarray([live[-1] - np.uint64(1)], dtype=np.uint64)
    with pytest.raises(ValueError, match="fence") as want:
        rsi.insert_into_shard(ref, 0, stray)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tsi.insert_into_shard(port, 0, stray)
    intact()
    with pytest.raises(ValueError, match="out of range"):
        tsi.insert_into_shard(port, 4, stray)
    with pytest.raises(ValueError, match="out of range"):
        tsi.compact_shard(port, -1)
    intact()
    # a small-capacity tier: shard 1 overflows its leaves and delta
    small = tix.GappedSpec(leaf_cap=4, fill=1.0, delta_cap=4)
    tier = tsi.ShardedIndex.build(small, table[:64], 2, device="cpu")
    rtier = rsi.ShardedIndex.build(rix.GappedSpec(leaf_cap=4, fill=1.0, delta_cap=4), table[:64], 2)
    burst = fresh_keys(rng, table[32:64], 40)
    with pytest.raises(rix.NeedsRebuild) as want:
        rsi.insert_into_shard(rtier, 1, burst)
    before = {k: v.clone() for k, v in tier.index.arrays.items()}
    vectors = [t.clone() for t in (tier.fences, tier.counts, tier.offsets, tier.lasts)]
    with pytest.raises(tix.NeedsRebuild, match=re.escape(str(want.value))):
        tsi.insert_into_shard(tier, 1, burst)
    assert all(torch.equal(before[k], v) for k, v in tier.index.arrays.items())
    assert all(torch.equal(a, b) for a, b in zip(vectors, (tier.fences, tier.counts, tier.offsets,
                                                            tier.lasts)))
    static = tsi.ShardedIndex.build("RMI", table, 2, device="cpu", b=16)
    with pytest.raises(TypeError, match="updatable"):
        tsi.insert_into_shard(static, 0, table[:1] + np.uint64(1))
    with pytest.raises(TypeError, match="updatable"):
        tsi.compact_shard(static, 0)


def test_shard_build_table_takes_the_raw_part():
    table = make_table(np.random.default_rng(85), "uniform", 3000)
    for kind in ("GAPPED", "RMI", "KO"):
        np.testing.assert_array_equal(tsi.shard_build_table(kind, table[:700], 1024),
                                      rsi.shard_build_table(kind, table[:700], 1024))
    np.testing.assert_array_equal(tsi.shard_build_table("GAPPED", table[:1500], 1024), table[:1500])


def test_refresh_and_rebalance_a_mutated_tier_match_reference():
    """A tier whose last shard took inserts and holds a populated delta:
    ``refresh_shard`` of that shard with a rebuild of its live keys less
    three, then ``rebalance_shards`` over the live keys (weighted bounds),
    give the reference's tiers (the GAPPED leaf padding of a shard built
    on fewer keys included), then exact ranks."""
    rng = np.random.default_rng(86)
    # 4 shards of ~600 keys: 16 leaves of 48 at fill 0.75, room to rebalance
    table = np.unique(rng.integers(1, 2**62, size=2400, dtype=np.uint64))
    ref = rsi.ShardedIndex.build(SPEC, table, n_shards=4)
    port = tsi.ShardedIndex.build(TSPEC, table, 4, device="cpu")
    last = table[int(np.asarray(ref.offsets)[3]):]
    fresh = fresh_keys(rng, last, 60)
    ref, _ = rsi.insert_into_shard(ref, 3, fresh)
    tsi.insert_into_shard(port, 3, fresh)
    live = np.union1d(table, fresh)
    packed = packed_batch(port.shard(3), live, 4)
    ref, _ = rsi.insert_into_shard(ref, 3, packed)
    tsi.insert_into_shard(port, 3, packed)
    live = np.union1d(live, packed)
    assert int(port.index.arrays["delta_count"][3]) > 0
    m = int(port.tables.shape[1])
    shard3 = rupd.live_keys(ref.shard(3))[:-3]
    live = live[:-3]  # shard 3's last three keys are the tier's
    new_ref = rix.build(SPEC, rsi.shard_build_table("GAPPED", shard3, m))
    new_port = tix.build(TSPEC, tsi.shard_build_table("GAPPED", shard3, m), device="cpu")
    assert_same_leaves(new_ref, new_port)
    ref = rsi.refresh_shard(ref, 3, new_ref, shard3)
    assert tsi.refresh_shard(port, 3, new_port, shard3) is port
    assert_same_tier(ref, port, _ref_lasts(ref))
    bounds = rsi.weighted_quantile_bounds(live, np.asarray(ref.fences), [1.5, 1.0, 1.0, 1.0])
    ref = rsi.rebalance_shards(ref, live, bounds, lambda part: rix.build(SPEC, part))
    tsi.rebalance_shards(port, live, bounds, lambda part: tix.build(TSPEC, part, device="cpu"))
    assert_same_tier(ref, port, _ref_lasts(ref))
    np.testing.assert_array_equal(port.counts.numpy(), np.diff(bounds))
    qs = probe_queries(rng, live)
    for b in GAPPED_BACKENDS:
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=b).numpy(),
                                      true_ranks(live, qs))


def test_mutated_tier_npz_across_packages(tmp_path):
    """``save`` -> ``load`` both ways after inserts (delta populated): the
    same leaves and answers; ``load(path, shard=s)`` of either package's
    file derives every shard's last live key from the leaves, as the
    tables are stale snapshots."""
    rng, table, ref, port, live, _ = _mutated_pair(87)
    port.save(tmp_path / "port.npz")
    ref.save(tmp_path / "ref.npz")
    back = rsi.ShardedIndex.load(tmp_path / "port.npz")
    loaded = tsi.ShardedIndex.load(tmp_path / "ref.npz", device="cpu")
    assert_same_tier(back, port, _ref_lasts(ref))
    assert_same_tier(ref, loaded, _ref_lasts(ref))
    qs = probe_queries(rng, live)
    want = true_ranks(live, qs)
    np.testing.assert_array_equal(np.asarray(rsi.sharded_lookup(back, qs, mode="ref")), want)
    np.testing.assert_array_equal(tsi.sharded_lookup(loaded, qs, backend="bbs").numpy(), want)
    for path in ("port.npz", "ref.npz"):
        for s in range(4):
            one = tsi.ShardedIndex.load(tmp_path / path, device="cpu", shard=s)
            assert torch.equal(one.lasts, port.lasts) and torch.equal(one.counts, port.counts)
            assert_same_leaves(ref.shard(s), one.shard(s))
            got = tsi._answer_shard(one, s, keys.encode(qs, "cpu"), "xla")
            np.testing.assert_array_equal(got.numpy(), tsi._answer_shard(port, s, keys.encode(
                qs, "cpu"), "xla").numpy())


# -- two possible faults of the reference (ROADMAP queue 3) ---------------------------------------


def test_refresh_after_insert_reads_live_last_keys():
    """After ``insert_into_shard`` grows shard 0, the reference's
    ``refresh_shard`` of shard 1 reads shard 0's last key from its stale
    padded table (``tables[0, counts[0] - 1]``, a pad key far above it)
    and refuses a valid install; the port checks the live last key and
    installs it, with exact ranks after."""
    rng = np.random.default_rng(88)
    table = np.unique(rng.integers(1, 2**62, size=3000, dtype=np.uint64))
    ref = rsi.ShardedIndex.build(SPEC, table, n_shards=4)
    port = tsi.ShardedIndex.build(TSPEC, table, 4, device="cpu")
    first = table[: int(np.asarray(ref.counts)[0])]
    fresh = fresh_keys(rng, first, 20)
    ref, _ = rsi.insert_into_shard(ref, 0, fresh)
    tsi.insert_into_shard(port, 0, fresh)
    live = np.union1d(table, fresh)
    stale = np.asarray(ref.tables)[0, int(np.asarray(ref.counts)[0]) - 1]
    assert stale > first[-1]  # a pad key of the build-time table
    m = int(port.tables.shape[1])
    shard1 = rupd.live_keys(ref.shard(1))[:-3]
    with pytest.raises(ValueError, match="previous"):
        rsi.refresh_shard(ref, 1, rix.build(SPEC, rsi.shard_build_table("GAPPED", shard1, m)),
                          shard1)
    tsi.refresh_shard(port, 1, tix.build(TSPEC, tsi.shard_build_table("GAPPED", shard1, m),
                                         device="cpu"), shard1)
    live = np.setdiff1d(live, rupd.live_keys(ref.shard(1))[-3:])
    assert keys.decode(port.lasts)[0] == np.union1d(first, fresh)[-1]
    qs = probe_queries(rng, live)
    for b in GAPPED_BACKENDS:
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=b).numpy(),
                                      true_ranks(live, qs))


def test_insert_below_previous_shard_is_accepted_like_reference():
    """``insert_into_shard`` checks only the next fence, as the reference
    does: a key below the previous shard's last key goes into shard 1,
    whose fence drops to it, so queries of shard 0's keys above it route
    to shard 1, which does not hold them.  Both packages give the same
    ranks, and those ranks are wrong for exactly those keys."""
    rng = np.random.default_rng(89)
    table = np.unique(rng.integers(1, 2**62, size=3000, dtype=np.uint64))
    ref = rsi.ShardedIndex.build(SPEC, table, n_shards=4)
    port = tsi.ShardedIndex.build(TSPEC, table, 4, device="cpu")
    first = table[: int(np.asarray(ref.counts)[0])]
    low = fresh_keys(rng, first[-40:], 1)[:1]
    ref, rr = rsi.insert_into_shard(ref, 1, low)
    _, pr = tsi.insert_into_shard(port, 1, low)
    assert_same_report(rr, pr)
    assert keys.decode(port.fences)[1] == low[0]
    live = np.union1d(table, low)
    qs = probe_queries(rng, live)
    want = np.asarray(rsi.sharded_lookup(ref, qs, mode="ref"))
    got = tsi.sharded_lookup(port, qs, backend="xla").numpy()
    np.testing.assert_array_equal(got, want)
    wrong = got != true_ranks(live, qs)
    misrouted = (qs >= low[0]) & (qs < table[int(np.asarray(ref.counts)[0])])
    assert wrong.any() and not (wrong & ~misrouted).any()


# -- the property of the reference: GAPPED after inserts == a fresh static build --------------


_gapped_keys = st.integers(min_value=0, max_value=2**64 - 2)


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_gapped_after_inserts_matches_fresh_static_build(data):
    """The port twin of ``tests/test_property.py``'s invariant: a GAPPED
    index after 1-3 insert batches answers like a static RMI built fresh
    on the merged keys, on every backend GAPPED claims; a batch that
    exhausts the capacity takes the retune arm (rebuild on the merged
    keys)."""
    table = np.unique(np.array(data.draw(st.lists(_gapped_keys, min_size=2, max_size=200,
                                                  unique=True)), dtype=np.uint64))
    spec = dict(leaf_cap=16, fill=0.5, delta_cap=32)
    g = tix.build("GAPPED", table, device="cpu", **spec)
    merged = table
    for _ in range(data.draw(st.integers(min_value=1, max_value=3), label="batches")):
        batch = data.draw(st.lists(_gapped_keys, min_size=1, max_size=40))
        batch = np.array(batch, dtype=np.uint64)
        target = np.union1d(merged, batch)
        try:
            g, report = g.insert_batch(batch)
        except tix.NeedsRebuild:
            g = tix.build("GAPPED", target, device="cpu", **spec)
        else:
            fresh = len(target) - len(merged)
            assert report.absorbed + report.overflowed == fresh
            assert report.duplicates == len(batch) - fresh
        merged = target
    static = tix.build("RMI", merged, device="cpu", b=16, root_type="linear")
    qs = np.array(data.draw(st.lists(_gapped_keys, min_size=1, max_size=64)), dtype=np.uint64)
    want = static.predecessor(merged, qs).numpy()
    np.testing.assert_array_equal(want, true_ranks(merged, qs))
    for b in g.backends():
        assert (g.lookup(table, qs, backend=b).numpy() == want).all(), b
