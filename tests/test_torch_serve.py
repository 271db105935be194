"""The port's serving layer held against the JAX reference on the CPU: the
hot-key cache (``KeySketch``, the probe model, ``HotKeyCache`` through the
reference's soak script), the paged KV pool, and ``DecodeEngine``'s
``tier=`` hook and ``serve_*`` publishing.

The same numpy keys go through both packages.  Ranks, sketch weights, the
probe model's f64 scalars and the ``hotcache_*`` counters must be equal,
with no tolerance: the port runs the reference's host arithmetic and its
device probe is integer search after one correctly rounded uint64 -> f64
conversion, then ``floor`` of a product and a sum (no fused multiply-add
on the CPU).  Tiers pass ``name=`` so their labels do not depend on test
order; the port's static tiers answer on ``kernel`` (the kernels' twins
on the CPU), GAPPED tiers on ``xla``, the reference's default.
"""

import dataclasses
import gc
import itertools
import sys
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serve_soak as soak
from repro import obs as robs
from repro.configs import get as rget
from repro.core import as_table, true_ranks
from repro.dist import reset_tier_metrics as r_reset_tier_metrics
from repro.dist.sharding import single_device_ctx
from repro.index import GappedSpec as RGapped
from repro.index import RMISpec as RRMI
from repro.models import transformer as rt
from repro.serve import engine as rengine
from repro.serve import hotcache as rhc
from repro.serve.kvcache import ContiguousCache as RContiguous
from repro.serve.kvcache import PagedPool as RPool
from repro.tune import RebuildPolicy as RPolicy
from repro.tune import TunedTier as RTier
from repro.tune import rebuild as rrebuild

import repro_torch
from repro_torch import obs as tobs
from repro_torch.configs import get as tget
from repro_torch.core import keys as tkeys
from repro_torch.dist import reset_tier_metrics as t_reset_tier_metrics
from repro_torch.index import GappedSpec as TGapped
from repro_torch.index import RMISpec as TRMI
from repro_torch.index.impls import _MAXKEY, _bucket_steps
from repro_torch.models import transformer as tt
from repro_torch.serve import (ContiguousCache, DecodeEngine, HotKeyCache, KeySketch, PagedPool,
                                Request)
from repro_torch.serve import hotcache as thc
from repro_torch.tune import RebuildPolicy as TPolicy
from repro_torch.tune import TunedTier as TTier
from repro_torch.tune import rebuild as trebuild

_NAMES = itertools.count()
#: the counters of a tier's metrics() that both packages keep alike
TIER_KEYS = ("n_shards", "n_keys", "lookups", "ingested", "absorbed", "overflowed", "duplicates",
             "shard_compactions", "shard_refreshes", "retunes", "forced_restacks", "pending",
             "rebalances", "rebalance_moved_keys")


def _name(what: str) -> str:
    return f"serve_{what}_{next(_NAMES)}"


def _hotcache(cache) -> dict:
    return cache.metrics()["hotcache"]


def _tier_counters(tier) -> dict:
    m = tier.metrics()
    return {k: m[k] for k in TIER_KEYS}


# ---------------------------------------------------------------------------
# KeySketch, the probe model and the probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_key_sketch_matches_reference(seed):
    """The same seeded ``update``/``age`` sequence: keys on both sides of
    2^63, batches past the capacity (eviction), weights 1 and 3.5."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([rng.integers(0, 2**63, 120, dtype=np.uint64),
                           rng.integers(2**63, 2**64 - 1, 120, dtype=np.uint64)])
    r, t = rhc.KeySketch(capacity=64), KeySketch(capacity=64)
    for step in range(14):
        q = rng.choice(pool, int(rng.integers(1, 120)))
        w = (1.0, 3.5)[step % 2]
        r.update(q, weight=w)
        t.update(q, weight=w)
        if step % 3 == 2:
            r.age(0.5)
            t.age()  # the port's decay is the constant DECAY = 0.5
        np.testing.assert_array_equal(t.keys, r.keys)
        np.testing.assert_array_equal(t.weights, r.weights)
        assert t.keys.dtype == np.uint64 and t.weights.dtype == np.float64
    assert len(t.keys) == 64  # the capacity evicted
    for k in (1, 8, 64, 1000):
        np.testing.assert_array_equal(t.top(k), r.top(k))
    assert t.space_bytes() == r.space_bytes()
    t.update(np.empty(0, np.uint64))
    np.testing.assert_array_equal(t.keys, r.keys)
    with pytest.raises(ValueError):
        KeySketch(capacity=0)


def _hot_set(case: str, rng) -> np.ndarray:
    if case == "one":
        return np.array([12345], np.uint64)
    if case == "two":
        return np.array([7, 2**40], np.uint64)
    if case == "uniform":
        return as_table(rng.integers(1, 2**61, 700, dtype=np.uint64))
    if case == "clustered":
        c = rng.integers(0, 2**60, 6, dtype=np.uint64)
        return as_table(c[rng.integers(0, 6, 900)] + rng.integers(0, 2**20, 900).astype(np.uint64))
    if case == "flip":  # both sides of 2^63, the encoding's sign flip
        return as_table(np.uint64(2**63) + rng.integers(-2**40, 2**40, 500).astype(np.int64)
                        .astype(np.uint64))
    assert case == "top"  # the top of the key range, below the pad sentinel
    return as_table(np.uint64(2**64 - 2) - rng.integers(0, 2**50, 300, dtype=np.uint64))


HOT_CASES = ("one", "two", "uniform", "clustered", "flip", "top")


@pytest.mark.parametrize("case", HOT_CASES)
def test_fit_matches_reference_bit_for_bit(case):
    hot = _hot_set(case, np.random.default_rng(3))
    cap = 1024
    want = rhc.HotKeyCache._fit(types.SimpleNamespace(capacity=cap), hot)
    got = thc._fit(hot, cap)
    assert set(got) == set(want)
    for k in ("kmin", "inv_span", "slope", "icept"):
        bits = np.float64(np.asarray(want[k])).view(np.int64)
        assert np.float64(got[k]).view(np.int64) == bits, k
    assert got["eps"] == int(want["eps"])


@pytest.mark.parametrize("case", HOT_CASES)
def test_probe_matches_reference(case):
    """``(hit, rank)`` on a padded residency: every hot key, ``key ± 1``
    near-misses, a below-minimum query, random keys, the pad sentinel
    itself and keys on both sides of 2^63."""
    rng = np.random.default_rng(4)
    hot = _hot_set(case, rng)
    cap = 1024
    padded = np.full(cap, _MAXKEY, np.uint64)
    padded[: len(hot)] = hot
    ranks = np.arange(cap, dtype=np.int64) * 3 - 1
    with np.errstate(over="ignore"):
        q = np.concatenate([hot, hot + np.uint64(1), hot - np.uint64(1),
                            np.array([0, 1, hot[0] - np.uint64(1), 2**63 - 1, 2**63, 2**64 - 2,
                                      2**64 - 1], np.uint64),
                            rng.integers(0, 2**64 - 1, 300, dtype=np.uint64)])
    steps = _bucket_steps(cap)
    model_r = rhc.HotKeyCache._fit(types.SimpleNamespace(capacity=cap), hot)
    hit_r, rank_r = rhc._probe(jnp.asarray(padded), jnp.asarray(ranks), model_r, len(hot),
                               jnp.asarray(q), steps=steps)
    dev = torch.device("cpu")
    hit_t, rank_t = thc._probe(tkeys.encode(padded, dev), torch.from_numpy(ranks),
                               thc._model_tensors(thc._fit(hot, cap), dev), len(hot),
                               tkeys.encode(q, dev), steps=steps)
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_r))
    np.testing.assert_array_equal(rank_t.numpy(), np.asarray(rank_r))
    # every resident key lies in its measured window: all hot keys hit
    assert hit_t[: len(hot)].all()
    live = np.isin(q, hot)
    np.testing.assert_array_equal(hit_t.numpy(), live)


# ---------------------------------------------------------------------------
# The reference's soak script, replayed op for op on both packages
# ---------------------------------------------------------------------------


def _refreshes_merged(counters: dict) -> dict:
    """A tier's counters with its refreshes and forced restacks summed, and
    without the keys a rebalance moved: after an insert into a GAPPED
    shard the reference's ``refresh_shard`` reads a stale table and
    refuses the refresh, which the tier turns into a forced restack (new
    fences), where the port installs the shard (ROADMAP queue 3, PR 19).
    The two tiers then hold the same keys behind other fences."""
    out = dict(counters)
    out["shard_refreshes"] += out.pop("forced_restacks")
    del out["rebalance_moved_keys"]
    return out


def _check_caches(r, t) -> None:
    assert _hotcache(t) == _hotcache(r)
    assert _refreshes_merged(_tier_counters(t.tier)) == _refreshes_merged(_tier_counters(r.tier))
    assert t.tier.epoch == r.tier.epoch


class _TwinSketch:
    def __init__(self, r, t):
        self.r, self.t = r, t

    def update(self, queries, weight: float = 1.0) -> None:
        self.r.update(queries, weight)
        self.t.update(queries, weight)
        np.testing.assert_array_equal(self.t.weights, self.r.weights)


class _TwinCache:
    """The reference's cache and the port's, driven by the same calls;
    every answer and every counter must be equal."""

    def __init__(self, r, t):
        self.r, self.t = r, t
        self.sketch = _TwinSketch(r.sketch, t.sketch)
        self.lookups = 0

    def lookup(self, queries, **kw):
        want = np.asarray(self.r.lookup(queries, **kw))
        got = self.t.lookup(queries, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        _check_caches(self.r, self.t)
        self.lookups += 1
        return want

    def insert_batch(self, new_keys) -> None:
        self.r.insert_batch(new_keys)
        self.t.insert_batch(new_keys)

    def maybe_compact(self):
        did = self.r.maybe_compact()
        assert self.t.maybe_compact() == did
        return did

    def rebuild(self) -> int:
        n = self.r.rebuild()
        assert self.t.rebuild() == n
        np.testing.assert_array_equal(tkeys.decode(self.t._keys), np.asarray(self.r._keys))
        np.testing.assert_array_equal(self.t._ranks.numpy(), np.asarray(self.r._ranks))
        _check_caches(self.r, self.t)
        return n

    def metrics(self) -> dict:
        _check_caches(self.r, self.t)
        return self.r.metrics()

    @property
    def built_epoch(self) -> int:
        assert self.t.built_epoch == self.r.built_epoch
        return self.r.built_epoch


class _TwinTier:
    def __init__(self, r, t):
        self.r, self.t = r, t

    @property
    def sidx(self):
        return self.r.sidx

    @property
    def epoch(self) -> int:
        assert self.t.epoch == self.r.epoch
        return self.r.epoch

    def refresh(self, s: int) -> None:
        self.r.refresh(s)
        self.t.refresh(s)

    def rebalance(self, weights=None) -> None:
        self.r.rebalance(weights=weights)
        self.t.rebalance(weights=weights)

    def _merged_table(self) -> np.ndarray:
        want = self.r._merged_table()
        np.testing.assert_array_equal(self.t._merged_table(), want)
        return want

    def lookup(self, queries, **kw):
        want = np.asarray(self.r.lookup(queries, **kw))
        np.testing.assert_array_equal(self.t.lookup(queries, **kw).numpy(), want)
        return want

    def metrics(self) -> dict:
        assert _refreshes_merged(_tier_counters(self.t)) == _refreshes_merged(
            _tier_counters(self.r))
        return self.r.metrics()


class _TwinHarness(soak.SoakHarness):
    """The reference's soak harness with its tier and cache doubled by the
    port's, built on the same oracle table."""

    def __init__(self, seed: int, n0: int = 1200, n_shards: int = 4):
        super().__init__(seed, n0, n_shards)
        port_tier = TTier(self.oracle, n_shards=n_shards,
                          policy=TPolicy(retune_frac=10.0, shard_refresh_frac=0.25, backend="xla"),
                          spec=TGapped(leaf_cap=64, fill=0.5, delta_cap=256), name=_name("soak"),
                          device="cpu")
        self.tier = _TwinTier(self.tier, port_tier)
        self.cache = _TwinCache(self.cache, HotKeyCache(port_tier, capacity=256))


def test_scripted_soak_replayed_on_both(monkeypatch):
    """``_scripted_soak(seed=11, rounds=4)`` (the reference's tier-1 soak):
    every lookup's ranks, the resident keys and ranks of every rebuild,
    every tier step and every round's ``hotcache_*`` counters equal."""
    monkeypatch.setattr(soak, "SoakHarness", _TwinHarness)
    h = soak._scripted_soak(seed=11, rounds=4)
    assert isinstance(h, _TwinHarness) and h.cache.lookups == 4
    m = h.tier.metrics()
    assert m["ingested"] > 0 and m["rebalances"] >= 1
    assert h.cache.metrics()["hotcache"]["rebuilds"] >= 5


def test_soak_catches_skipped_invalidation_on_both(monkeypatch):
    """The reference's seeded-bug regression on both packages: with the
    epoch bump a no-op in each ``TunedTier``, both caches serve the same
    stale ranks and the oracle catches them."""
    h = _TwinHarness(seed=7)
    hot = h.oracle[-64:].copy()
    h.cache.sketch.update(hot)
    h.cache.rebuild()
    below = np.unique(h.rng.integers(1, int(h.oracle[0]), size=32, dtype=np.uint64))
    below = np.setdiff1d(below, h.oracle)
    assert len(below) > 0
    # positive control: the epoch path detects the mutation
    h.do_insert(len(below) // 2 or 1)
    np.testing.assert_array_equal(h.cache.lookup(hot), true_ranks(h.oracle, hot))
    stale_ranks = h.cache.lookup(hot).copy()
    monkeypatch.setattr(rrebuild.TunedTier, "_bump_epoch", lambda self: None)
    monkeypatch.setattr(trebuild.TunedTier, "_bump_epoch", lambda self: None)
    h.cache.insert_batch(below)
    h.oracle = np.union1d(h.oracle, below)
    got = h.cache.lookup(hot)  # equal on both packages (the twin asserts it)
    assert not (got == true_ranks(h.oracle, hot)).all(), "the oracle missed the seeded bug"
    np.testing.assert_array_equal(got, stale_ranks)
    assert h.cache.t.metrics()["hotcache"]["stale"] is False


# ---------------------------------------------------------------------------
# Twins of tests/test_data_serve.py
# ---------------------------------------------------------------------------


def test_hotcache_coherent_through_mutation_lifecycle_twin():
    """Insert (host-buffered on a static kind), shard refreshes and a fence
    rebalance: cache-on == cache-off on the port, == the reference's, with
    equal counters after every step."""
    rng = np.random.default_rng(61)
    table = as_table(rng.integers(1, 2**61, size=3000, dtype=np.uint64))
    rtier = RTier(table, n_shards=4, policy=RPolicy(shard_refresh_frac=10.0, retune_frac=10.0),
                  spec=RRMI(b=64))
    ttier = TTier(table, n_shards=4, policy=TPolicy(shard_refresh_frac=10.0, retune_frac=10.0),
                  spec=TRMI(b=64), name=_name("coherent"), device="cpu")
    rc, tc = rhc.HotKeyCache(rtier, capacity=256), HotKeyCache(ttier, capacity=256)
    hot = rng.choice(table, size=200).astype(np.uint64)
    for c in (rc, tc):
        c.sketch.update(hot)
        c.rebuild()

    def assert_coherent():
        mix = np.concatenate([rng.choice(table, size=64), rng.choice(hot, size=32),
                              rng.integers(0, 2**61, size=32, dtype=np.uint64)])
        mix[0] = np.uint64(0)  # below-min: NO_PRED must round-trip too
        want = np.asarray(rc.lookup(mix, mode="ref"))
        np.testing.assert_array_equal(np.asarray(rtier.lookup(mix, mode="ref")), want)
        np.testing.assert_array_equal(tc.lookup(mix, mode="ref").numpy(), want)
        np.testing.assert_array_equal(ttier.lookup(mix, mode="ref").numpy(), want)
        _check_caches(rc, tc)

    assert_coherent()
    new = np.unique(rng.integers(1, 2**61, size=200, dtype=np.uint64))
    rc.insert_batch(new)
    tc.insert_batch(new)
    assert ttier.counters.pending == rtier.counters.pending > 0
    assert_coherent()
    for s in range(4):
        rtier.refresh(s)
        ttier.refresh(s)
    assert tc.stale() and rc.stale()
    assert_coherent()
    assert not tc.stale()  # the coherence lookup itself rebuilt
    for tier in (rtier, ttier):
        tier.rebalance(weights=np.array([8.0, 1.0, 1.0, 1.0]))
    assert tc.stale()
    assert_coherent()
    assert _hotcache(tc)["stale_detected"] == 3  # after the insert, the refreshes, the rebalance


def test_hotcache_stale_epoch_is_load_bearing_twin():
    """``rebuild_on_stale=False`` bypasses a stale cache: both packages serve
    the tier's fresh answers, count the staleness alike, and keep the same
    (now stale) resident ranks."""
    rng = np.random.default_rng(62)
    table = as_table(rng.integers(1, 2**61, size=2000, dtype=np.uint64))
    rtier = RTier(table, n_shards=2, policy=RPolicy(retune_frac=10.0),
                  spec=RGapped(leaf_cap=64, fill=0.5, delta_cap=256))
    ttier = TTier(table, n_shards=2, policy=TPolicy(retune_frac=10.0, backend="xla"),
                  spec=TGapped(leaf_cap=64, fill=0.5, delta_cap=256), name=_name("stale"),
                  device="cpu")
    rc = rhc.HotKeyCache(rtier, capacity=128, rebuild_on_stale=False)
    tc = HotKeyCache(ttier, capacity=128, rebuild_on_stale=False)
    hot = table[-64:].copy()
    for c in (rc, tc):
        c.sketch.update(hot)
        c.rebuild()
    assert not tc.stale()
    below = np.setdiff1d(np.unique(rng.integers(1, int(table[0]), size=40, dtype=np.uint64)), table)
    rc.insert_batch(below)
    tc.insert_batch(below)
    merged = np.union1d(table, below)
    assert tc.stale()
    got = tc.lookup(hot, mode="ref").numpy()
    np.testing.assert_array_equal(got, np.asarray(rc.lookup(hot, mode="ref")))
    np.testing.assert_array_equal(got, true_ranks(merged, hot))
    _check_caches(rc, tc)
    assert _hotcache(tc)["stale_detected"] >= 1
    resident = tc._ranks.numpy()[: tc.n_hot]
    np.testing.assert_array_equal(resident, np.asarray(rc._ranks)[: rc.n_hot])
    assert not (resident == true_ranks(merged, hot)).all()


def test_paged_pool_lookup_twin():
    """The reference test's case, then three sequences whose pages
    interleave, a release and a re-allocation, every position of each:
    page ids and offsets equal the reference's and ``pos // 16``."""
    pools = (RPool(n_pages=16, n_layers=2, page_size=8, n_kv=1, head_dim=4),
             PagedPool(n_pages=16, n_layers=2, page_size=8, n_kv=1, head_dim=4, device="cpu"))
    for p in pools:
        p.add_sequence(7)
        p.ensure_capacity(7, 50)
    assert pools[1].seq_pages[7] == pools[0].seq_pages[7] and len(pools[1].seq_pages[7]) == 7
    q = np.array([0, 7, 8, 49])
    (rp, ro), (tp, to) = (p.position_lookup(7, q) for p in pools)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(to.numpy(), [0, 7, 0, 1])
    assert tp.dtype == torch.int64 and pools[1].k.shape == (16, 2, 8, 1, 4)
    for p in pools:
        p.release(7)
        assert p.utilization() == 0.0

    pools = (RPool(n_pages=40, n_layers=1, page_size=16, n_kv=1, head_dim=4),
             PagedPool(n_pages=40, n_layers=1, page_size=16, n_kv=1, head_dim=4, device="cpu"))
    lens = {1: 100, 2: 257, 3: 64}
    for p in pools:
        for s in lens:
            p.add_sequence(s)
        for grow in (1, 2, 3):  # interleaved growth: page ids are not contiguous
            for s, n in lens.items():
                p.ensure_capacity(s, n * grow // 3)
        p.release(3)
        p.add_sequence(4)
        p.ensure_capacity(4, 200)  # takes the released pages back
    assert pools[1].seq_pages == pools[0].seq_pages and pools[1].free == pools[0].free
    for s, n in ((1, 100), (2, 257), (4, 200)):
        pos = np.arange(n)
        (rp, ro), (tp, to) = (p.position_lookup(s, pos) for p in pools)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(pools[1].seq_pages[s])[pos // 16])
        np.testing.assert_array_equal(to.numpy(), pos % 16)
    assert pools[1].utilization() == pools[0].utilization()
    for p in pools:
        with pytest.raises(MemoryError, match="exhausted"):
            p.ensure_capacity(1, 16 * 41)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_contiguous_cache_init_twin(dtype):
    """``ContiguousCache.init``: the reference's (L, B, S, Hkv, D) K and V
    buffers, zero, in the given dtype, at length 0; the port's on the
    device it is given."""
    r = RContiguous.init(3, 2, 24, 2, 8, dtype=getattr(jnp, dtype))
    t = ContiguousCache.init(3, 2, 24, 2, 8, dtype=getattr(torch, dtype), device="cpu")
    assert t.length == r.length == 0
    for got, want in ((t.k, r.k), (t.v, r.v)):
        assert tuple(got.shape) == want.shape == (3, 2, 24, 2, 8)
        assert str(got.dtype) == f"torch.{want.dtype}" and got.device.type == "cpu"
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert t.k.data_ptr() != t.v.data_ptr()


def _qwen_cfgs():
    """Reduced qwen2-0.5b in f32, so greedy tokens can be compared."""
    return (dataclasses.replace(rget("qwen2-0.5b", reduced=True).config, dtype="float32"),
            dataclasses.replace(tget("qwen2-0.5b", reduced=True).config, dtype="float32"))


def _engines(seed=0, *, slots=2, r_tier=None, t_tier=None):
    cfg_r, cfg_t = _qwen_cfgs()
    rp = rt.init(jax.random.key(seed), cfg_r)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, rp), cfg_t, device="cpu")
    return (rengine.DecodeEngine(rp, cfg_r, single_device_ctx(), batch_slots=slots, max_seq=64,
                                 tier=r_tier),
            DecodeEngine(tp, cfg_t, batch_slots=slots, max_seq=64, tier=t_tier))


def _serve_samples(eng, snap, pkg) -> dict:
    return {m: pkg.sample_value(snap, m, engine=eng.name)
            for m in ("serve_ticks", "serve_tokens_decoded", "serve_requests_finished",
                      "serve_queued", "serve_live_slots")}


def test_decode_engine_continuous_batching_twin():
    """5 requests through 2 slots: greedy tokens, the counters, the
    ``serve_*`` samples and the metric keys equal the reference's."""
    r_eng, t_eng = _engines()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 5).astype(np.int32) for _ in range(5)]
    rr = [rengine.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for a, b in zip(rr, tr):
        r_eng.submit(a)
        t_eng.submit(b)
    assert t_eng.run_until_drained(max_ticks=200) == r_eng.run_until_drained(max_ticks=200)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]
    mr, mt = r_eng.metrics(), t_eng.metrics()
    assert set(mt) == set(mr) and "tier" not in mt
    for k in ("ticks", "tokens_decoded", "requests_finished", "queued", "live_slots"):
        assert mt[k] == mr[k] and type(mt[k]) is int, k
    assert mt["requests_finished"] == 5 and mt["queued"] == 0 and mt["live_slots"] == 0
    assert mt["index_traces"] == 0 and mt["index_trace_counts"] == {}
    assert set(mt["tier_routing"]) == set(mr["tier_routing"])
    assert _serve_samples(t_eng, tobs.snapshot(prefix="serve_"), tobs) == _serve_samples(
        r_eng, robs.snapshot(prefix="serve_"), robs)
    assert t_eng.name.startswith("engine") and _engines()[1].name != t_eng.name


def test_decode_engine_drives_tuned_tier_twin():
    """Keys buffered in shard 0 of a static tier; the engines' ticks run
    the policy: the same refresh, the same counters and ranks on both."""
    rng = np.random.default_rng(5)
    table = as_table(rng.integers(0, 2**61, size=2048, dtype=np.uint64))
    r_reset_tier_metrics()
    t_reset_tier_metrics()
    rtier = RTier(table, n_shards=2, spec=RRMI(b=32),
                  policy=RPolicy(shard_refresh_frac=0.01, retune_frac=10.0, n_queries=128))
    ttier = TTier(table, n_shards=2, spec=TRMI(b=32), name=_name("engine"), device="cpu",
                  policy=TPolicy(shard_refresh_frac=0.01, retune_frac=10.0, n_queries=128))
    r_eng, t_eng = _engines(r_tier=rtier, t_tier=ttier)
    qs = rng.choice(table, size=256).astype(np.uint64)
    for tier in (rtier, ttier):
        np.testing.assert_array_equal(np.asarray(tier.lookup(qs, mode="ref")),
                                      true_ranks(table, qs))
    new_keys = np.setdiff1d(np.unique(rng.integers(0, 2**61, size=64, dtype=np.uint64)), table)
    for tier in (rtier, ttier):
        tier._pending[0].append(new_keys)  # buffer only: the engine's tick applies the policy
        tier.counters.pending += len(new_keys)
    for eng, mod in ((r_eng, rengine), (t_eng, sys.modules[DecodeEngine.__module__])):
        eng.submit(mod.Request(rid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=2))
        eng.run_until_drained(max_ticks=50)
    mr, mt = r_eng.metrics(), t_eng.metrics()
    assert {k: mt["tier"][k] for k in TIER_KEYS} == {k: mr["tier"][k] for k in TIER_KEYS}
    assert mt["tier"]["shard_refreshes"] + mt["tier"]["forced_restacks"] >= 1
    assert mt["tier"]["routing"]["lookups"] == mr["tier"]["routing"]["lookups"] >= 1
    assert mt["tier_routing"]["lookups"] == mr["tier_routing"]["lookups"]
    merged = np.union1d(table, new_keys)
    q2 = rng.choice(merged, size=256).astype(np.uint64)
    np.testing.assert_array_equal(ttier.lookup(q2, mode="ref").numpy(), true_ranks(merged, q2))


def test_engine_tick_without_tier_never_imports_obs():
    """With ``repro_torch.obs`` evicted, ticks of an engine with no tier
    complete without importing it again; ``metrics()`` then does."""
    _, t_eng = _engines(seed=2)
    t_eng.submit(Request(rid=0, prompt=np.array([3, 4], np.int32), max_new_tokens=3))
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.startswith("repro_torch.obs")}
    saved_attr = repro_torch.__dict__.pop("obs", None)
    try:
        t_eng.run_until_drained()
        leaked = [k for k in sys.modules if k.startswith("repro_torch.obs")]
        assert not leaked, f"a tick imported {leaked}"
    finally:
        sys.modules.update(saved)
        if saved_attr is not None:
            repro_torch.obs = saved_attr
    assert t_eng.metrics()["requests_finished"] == 1


def test_engine_publishes_serve_metrics_into_the_registry():
    """``metrics()`` renders from the registry: its ints are the registry's
    samples under the engine's label, and two engines keep two labelsets."""
    _, a = _engines(seed=3)
    _, b = _engines(seed=3)
    a.submit(Request(rid=0, prompt=np.array([1, 2, 3], np.int32), max_new_tokens=3))
    a.run_until_drained()
    ma, mb = a.metrics(), b.metrics()
    snap = tobs.snapshot(prefix="serve_")
    assert tobs.sample_value(snap, "serve_requests_finished", engine=a.name) == 1.0
    assert tobs.sample_value(snap, "serve_tokens_decoded", engine=a.name) == ma["tokens_decoded"]
    assert tobs.sample_value(snap, "serve_requests_finished", engine=b.name) == 0.0
    assert mb["ticks"] == 0 and ma["ticks"] == a.ticks > 0
    cat = {row[0]: row[1:3] for row in tobs.CATALOGUE}
    assert cat["serve_ticks"] == ("counter", ("engine",)) and cat["serve_queued"][0] == "gauge"


def test_dropped_engine_is_freed_at_once():
    """An engine holds no reference cycle (its step functions are methods,
    not bound methods kept on the instance), so dropping the last
    reference frees its weights and cache without the cycle collector."""
    _, eng = _engines(seed=4)
    eng.submit(Request(rid=0, prompt=np.array([5], np.int32), max_new_tokens=2))
    eng.run_until_drained()
    cache = weakref.ref(eng.cache["k"])
    gc.disable()
    try:
        del eng
        assert cache() is None
    finally:
        gc.enable()
