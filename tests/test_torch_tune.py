"""The port's tuner held against the JAX reference (``repro.tune``): the
candidate and CDFShop grids, model space and the mined UB, the Pareto
frontier, the budget picks and their report, the sweep, SY-RMI mining,
and ``TunedTier``'s lifecycle (refresh on the host and through the
device arm, GAPPED absorb/overflow/compact, forced restack, retune,
rebalance).

Grids, spaces, UB, frontiers of hand-made candidates, lifecycle counters
and ranks are equal to the reference's, no tolerance.  What the tuner
picks by timing cannot equal another machine's pick, so the sweep, the
budget picks and the mined winner are held to their contracts: every
candidate exact, the frontier strictly monotone, every pick within its
budget, the winner one of ``ROOT_TYPES``.  Reference calls run once a
module through ``scope="module"`` fixtures; tiers take ``name=`` so their
registry labels do not depend on test order.
"""

import json

import numpy as np
import pytest

from repro import index as rix
from repro import obs as robs
from repro import tune as rtune
from repro.core import sy_rmi as rsy
from repro.data import tables as rtables
from repro_torch import index as tix
from repro_torch import obs as tobs
from repro_torch import tune as ttune
from repro_torch.core import sy_rmi as tsy
from repro_torch.core.rmi import ROOT_TYPES
from repro_torch.data import tables as ttables

from conftest import make_table


def _truth(table, qs):
    return np.searchsorted(table, qs, side="right") - 1


# ---------------------------------------------------------------------------
# Grids, space, UB
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", (1 << 11, 1 << 16, 1 << 20, 1 << 24))
def test_candidate_grid_equals_reference(n):
    got = [s.display_name() for s in ttune.candidate_grid(n)]
    assert got == [s.display_name() for s in rtune.candidate_grid(n)]
    assert {s.kind for s in ttune.candidate_grid(n)} == set(tix.kinds())
    restricted = ttune.candidate_grid(n, kinds=("RMI", "PGM", "GAPPED"))
    assert [s.display_name() for s in restricted] == [
        s.display_name() for s in rtune.candidate_grid(n, kinds=("RMI", "PGM", "GAPPED"))]


@pytest.mark.parametrize("n", (16, 1 << 11, 1 << 16, 1 << 24))
@pytest.mark.parametrize("max_models", (4, 10))
def test_cdfshop_grid_equals_reference(n, max_models):
    got = ttune.cdfshop_grid(n, max_models=max_models)
    want = rtune.cdfshop_grid(n, max_models=max_models)
    assert [s.display_name() for s in got] == [s.display_name() for s in want]


@pytest.fixture(scope="module")
def grid_builds():
    table = make_table(np.random.default_rng(31), "lognormal", 8192)
    specs = ttune.cdfshop_grid(len(table))
    rspecs = rtune.cdfshop_grid(len(table))
    return (table, ttune.build_grid(specs, table, fit="auto", device="cpu"),
            rtune.build_grid(rspecs, table, fit="auto"))


def test_grid_space_bytes_and_ub_equal_reference(grid_builds):
    table, got, want = grid_builds
    assert [c.space_bytes() for c in got] == [c.space_bytes() for c in want]
    assert [(c.root_type, c.b) for c in got] == [(c.root_type, c.b) for c in want]
    assert ttune.mining.mine_ub(got) == rtune.mining.mine_ub(want)


def test_core_cdfshop_sweep_and_ub_equal_reference():
    table = make_table(np.random.default_rng(32), "bursty", 4096)
    got, want = tsy.cdfshop_sweep(table), rsy.cdfshop_sweep(table)
    assert [(m.root_type, m.b, m.space_bytes()) for m in got] == [
        (m.root_type, m.b, m.space_bytes()) for m in want]
    assert tsy.mine_ub(got) == rsy.mine_ub(want)


def test_core_pick_winner_times_every_model():
    table = make_table(np.random.default_rng(33), "uniform", 4096)
    models = tsy.cdfshop_sweep(table, max_models=4)
    qs = np.random.default_rng(0).choice(table, 256)
    root, times = tsy.pick_winner(models, table, qs, device="cpu")
    assert root in ROOT_TYPES and len(times) == len(models)
    assert all(t > 0 for t in times)
    assert models[int(np.argmin(times))].root_type == root


# ---------------------------------------------------------------------------
# Frontier, budget picks and reports on hand-made candidates
# ---------------------------------------------------------------------------


def _hand_made(pkg):
    """The same candidates in both packages: the 2^16 grid with seeded
    spaces and times, ties of space (and of space and time) included."""
    tune = rtune if pkg == "ref" else ttune
    rng = np.random.default_rng(41)
    specs = tune.candidate_grid(1 << 16)
    spaces = rng.choice([56, 56, 120, 4096, 9000, 20000, 65536], size=len(specs))
    times = rng.choice([5.0, 7.5, 7.5, 12.0, 30.0, 31.0, 90.0], size=len(specs))
    return [tune.Candidate(spec=s, space_bytes=int(b), ns_per_query=float(t), build_s=0.25 * i,
                           exact=bool(i % 5)) for i, (s, b, t) in enumerate(zip(specs, spaces,
                                                                                   times))]


def _dicts(cands):
    return [c.to_dict() for c in cands]


def test_pareto_frontier_equals_reference():
    got = ttune.pareto_frontier(_hand_made("port"))
    assert _dicts(got) == _dicts(rtune.pareto_frontier(_hand_made("ref")))
    spaces = [c.space_bytes for c in got]
    times = [c.ns_per_query for c in got]
    assert spaces == sorted(set(spaces))
    assert all(a > b for a, b in zip(times, times[1:]))


@pytest.mark.parametrize("pct", (0.001, 0.05, 0.7, 2.0, 10.0, 100.0))
def test_best_candidate_for_budget_equals_reference(pct):
    got = ttune.best_candidate_for_budget(_hand_made("port"), 1 << 16, pct)
    want = rtune.best_candidate_for_budget(_hand_made("ref"), 1 << 16, pct)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()
        assert got.space_bytes <= pct / 100.0 * (1 << 16) * 8


def test_frontier_report_equals_reference_and_round_trips():
    table = np.arange(1 << 16, dtype=np.uint64)
    got = ttune.frontier_report(table, _hand_made("port"), extra={"tag": "x"})
    assert got == rtune.frontier_report(table, _hand_made("ref"), extra={"tag": "x"})
    decoded = json.loads(json.dumps(got))
    for section in ("frontier", "candidates"):
        specs = ttune.report_specs(decoded, section)
        assert [s.display_name() for s in specs] == [
            s.display_name() for s in rtune.report_specs(decoded, section)]
        assert [ttune.Candidate.from_dict(d).to_dict() for d in decoded[section]] == \
            decoded[section]
    assert ttune.report_specs(decoded) == [c.spec for c in ttune.pareto_frontier(
        _hand_made("port"))]


# ---------------------------------------------------------------------------
# The sweep and the budget picks, by contract
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def swept():
    table = make_table(np.random.default_rng(51), "uniform", 4096)
    return table, {be: ttune.sweep(table, n_queries=256, reps=1, check_exact=True, backend=be,
                                   device="cpu") for be in ("kernel", "xla")}


@pytest.mark.parametrize("timed", ("kernel", "xla"))
def test_sweep_is_exact_and_its_frontier_monotone(swept, timed):
    table, runs = swept
    cands = runs[timed]
    want = [s for s in rtune.candidate_grid(len(table))
            if timed == "xla" or s.kind != "GAPPED"]
    assert [c.spec.display_name() for c in cands] == [s.display_name() for s in want]
    assert all(c.exact for c in cands)
    assert all(c.ns_per_query > 0 and c.build_s >= 0 for c in cands)
    front = ttune.pareto_frontier(cands)
    assert front
    spaces = [c.space_bytes for c in front]
    times = [c.ns_per_query for c in front]
    assert spaces == sorted(set(spaces))
    assert all(a > b for a, b in zip(times, times[1:]))


def test_sweep_space_equals_reference_builds(swept):
    table, runs = swept
    by_name = {c.spec.display_name(): c.space_bytes for c in runs["xla"]}
    ref = rtune.build_grid(rtune.candidate_grid(len(table), kinds=("KO", "SY-RMI", "PGM", "RS",
                                                                   "GAPPED")), table)
    for idx in ref:
        spec = idx.info.get("spec")
        name = spec.display_name() if spec is not None else None
        if name in by_name:
            assert by_name[name] == idx.space_bytes()
    got = [by_name[s.display_name()] for s in rtune.candidate_grid(len(table))]
    assert got == [idx.space_bytes() for idx in rtune.build_grid(rtune.candidate_grid(len(table)),
                                                                 table)]


@pytest.fixture(scope="module")
def bench_tiers():
    tiers = {"L1": 2048, "L2": 8192, "L3": 16384}
    got = ttables.make_bench_tables(datasets=("osm",), tiers=tiers, seed=3)
    want = rtables.make_bench_tables(datasets=("osm",), tiers=tiers, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.table, b.table)
    return {bt.tier: bt.table for bt in got}


@pytest.mark.parametrize("tier", ("L1", "L2", "L3"))
@pytest.mark.parametrize("pct", (0.7, 2.0, 10.0))
def test_best_spec_for_budget_respects_budget_on_all_tiers(bench_tiers, tier, pct):
    table = bench_tiers[tier]
    spec = ttune.best_spec_for_budget(table, pct, n_queries=128, reps=1, fit="host",
                                      device="cpu")
    built = tix.build(spec, table, device="cpu")
    assert built.space_bytes() <= pct / 100.0 * len(table) * 8, (tier, pct, spec)
    assert "kernel" in built.backends()


def test_best_spec_for_budget_impossible_budget_message_equals_reference():
    table = make_table(np.random.default_rng(52), "uniform", 1024)
    with pytest.raises(ValueError) as got:
        ttune.best_spec_for_budget(table, 0.01, n_queries=64, reps=1, backend="xla",
                                   device="cpu")
    with pytest.raises(ValueError) as want:
        rtune.best_spec_for_budget(table, 0.01, n_queries=64, reps=1)
    assert str(got.value) == str(want.value)


def test_mine_sy_rmi_contract_and_ub_equal_reference():
    rng = np.random.default_rng(53)
    tables = [make_table(rng, "lognormal", 4096), make_table(rng, "uniform", 4096)]
    got = ttune.mine_sy_rmi(tables, n_queries=20000, device="cpu")
    want = rtune.mine_sy_rmi(tables, n_queries=20000)
    assert got.ub == want.ub
    assert got.sweep_sizes == want.sweep_sizes
    assert got.winner_root in ROOT_TYPES
    assert [len(t) for t in got.sweep_times] == [len(t) for t in want.sweep_times]
    assert got.mining_time > 0
    core = tsy.mine_sy_rmi(tables[:1], n_queries=20000, device="cpu")
    assert core.ub == rsy.mine_sy_rmi(tables[:1], n_queries=20000).ub
    # the mined UB instantiates the winner at the budget
    spec = tix.SYRMISpec(space_pct=2.0, ub=got.ub, winner_root=got.winner_root)
    idx = tix.build(spec, tables[0], device="cpu")
    qs = rng.choice(tables[0], 512)
    np.testing.assert_array_equal(idx.lookup(tables[0], qs, backend="xla").numpy(),
                                  _truth(tables[0], qs))


# ---------------------------------------------------------------------------
# TunedTier against the reference, step by step
# ---------------------------------------------------------------------------


def _inside(rng, table, lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` or fewer fresh keys strictly inside ``(table[lo], table[hi])``."""
    keys = np.unique(rng.integers(int(table[lo]) + 1, int(table[hi]), n, dtype=np.uint64))
    return np.setdiff1d(keys, table)


def _scenario(name: str):
    """(table, spec kind + params, policy kwargs, steps): one lifecycle,
    the same in both packages.  A step is ``("insert", keys)``,
    ``("lookup", queries)``, ``("refresh", shard)`` or ``("rebalance",
    weights)``."""
    rng = np.random.default_rng(61)
    if name == "host_refresh":
        table = make_table(rng, "uniform", 4000)  # 1,000 keys a shard, capacity 1,024
        steps = [("insert", _inside(rng, table, 1000, 1999, 20)),
                 ("insert", _inside(rng, table, 3000, 3999, 5)),
                 ("refresh", 3)]
        return table, ("RMI", {"b": 64}), dict(shard_refresh_frac=0.015, retune_frac=10.0), steps
    if name in ("device_scan", "device_fast"):
        table = make_table(rng, "lognormal", 8000)
        steps = [("insert", _inside(rng, table, 2000, 3999, 35))]
        fit = name.split("_")[1]
        kind = ("PGM", {"eps": 32}) if fit == "scan" else ("RS", {"eps": 16, "r_bits": 8})
        return table, kind, dict(shard_refresh_frac=0.015, retune_frac=10.0,
                                 device_refresh=True, device_fit=fit), steps
    if name == "gapped":
        table = np.unique(rng.integers(1, 2**61, 3000, dtype=np.uint64))
        # two clusters inside one leaf's range each overflow into the delta;
        # the second takes shard 0's delta past COMPACT_FILL (a compaction)
        steps = [("insert", _inside(rng, table, 40, 41, 120)),
                 ("insert", _inside(rng, table, 0, 2999, 200)),
                 ("insert", _inside(rng, table, 100, 101, 160)),
                 ("insert", _inside(rng, table, 900, 901, 300)),
                 ("rebalance", np.array([6.0, 1.0, 1.0, 1.0]))]
        return table, ("GAPPED", {"leaf_cap": 64, "fill": 0.5, "delta_cap": 512}), \
            dict(retune_frac=10.0, backend="xla"), steps
    if name == "forced_restack":
        table = make_table(rng, "uniform", 4096)  # full power-of-two shards
        steps = [("insert", _inside(rng, table, 0, 1023, 40))]
        return table, ("PGM", {"eps": 16}), dict(shard_refresh_frac=0.02, retune_frac=10.0), steps
    if name == "rebalance":
        table = make_table(rng, "uniform", 8704)
        hot = table[: len(table) // 4]
        steps = [("lookup", rng.choice(hot, 256).astype(np.uint64)) for _ in range(8)]
        return table, ("RMI", {"b": 64}), dict(retune_frac=10.0, rebalance_imbalance=1.5,
                                              rebalance_min_lookups=3), steps
    raise ValueError(name)


SCENARIOS = ("host_refresh", "device_scan", "device_fast", "gapped", "forced_restack",
             "rebalance")


def _replay(pkg: str, name: str) -> dict:
    table, (kind, params), policy_kw, steps = _scenario(name)
    ix, tune, obs = (rix, rtune, robs) if pkg == "ref" else (tix, ttune, tobs)
    if pkg == "ref" and policy_kw.get("backend") is None:
        policy_kw = dict(policy_kw, backend="xla")  # the reference's default path
    kw = {} if pkg == "ref" else {"device": "cpu"}
    before = obs.snapshot(prefix="device_refreshes")
    tier = tune.TunedTier(table, n_shards=4, policy=tune.RebuildPolicy(**policy_kw),
                          spec=ix.spec_for(kind, **params), name=f"tt_{name}", **kw)
    live = np.asarray(table, dtype=np.uint64)
    probe = np.random.default_rng(7)
    trace = []
    for op, arg in steps:
        if op == "insert":
            tier.insert_batch(arg)
            live = np.union1d(live, arg)
        elif op == "refresh":
            tier.refresh(arg)
        elif op == "rebalance":
            tier.rebalance(weights=arg)
        qs = arg if op == "lookup" else np.concatenate(
            [probe.choice(live, 300), arg if op == "insert" else live[:4]]).astype(np.uint64)
        ranks = np.asarray(tier.lookup(qs, mode="ref"))
        sidx = tier.sidx
        # what the tier serves: its shards' keys (a static kind's pending
        # keys land at the next refresh)
        served = np.concatenate([tier._shard_keys(s) for s in range(sidx.n_shards)])
        trace.append({"ranks": ranks, "truth": _truth(served, qs), "metrics": tier.metrics(),
                      "counts": np.asarray(sidx.counts).tolist(), "epoch": tier.epoch,
                      "pending": [len(p) for p in tier._pending]})
    after = obs.snapshot(prefix="device_refreshes")
    return {"trace": trace, "device_refreshes": obs.diff(before, after),
            "merged": tier._merged_table(), "live": live}


@pytest.fixture(scope="module")
def tier_replays():
    return {name: {pkg: _replay(pkg, name) for pkg in ("ref", "port")} for name in SCENARIOS}


@pytest.mark.parametrize("name", SCENARIOS)
def test_tuned_tier_ranks_equal_reference_after_every_step(tier_replays, name):
    got, want = tier_replays[name]["port"], tier_replays[name]["ref"]
    assert len(got["trace"]) == len(want["trace"])
    for step, (g, w) in enumerate(zip(got["trace"], want["trace"])):
        np.testing.assert_array_equal(g["ranks"], g["truth"], err_msg=f"step {step}")
        np.testing.assert_array_equal(g["ranks"], w["ranks"], err_msg=f"step {step}")
    np.testing.assert_array_equal(got["merged"], want["merged"])
    np.testing.assert_array_equal(got["merged"], got["live"])


@pytest.mark.parametrize("name", SCENARIOS)
def test_tuned_tier_metrics_equal_reference_after_every_step(tier_replays, name):
    got, want = tier_replays[name]["port"], tier_replays[name]["ref"]
    for step, (g, w) in enumerate(zip(got["trace"], want["trace"])):
        assert g["metrics"] == w["metrics"], f"step {step}"
        assert (g["counts"], g["epoch"], g["pending"]) == (w["counts"], w["epoch"],
                                                           w["pending"]), f"step {step}"
    assert got["device_refreshes"] == want["device_refreshes"]


def test_tuned_tier_lifecycle_arms_fired(tier_replays):
    """Each scenario reached the arm it is meant to cover (in both
    packages, by the equality tests above)."""
    last = {name: tier_replays[name]["port"]["trace"][-1]["metrics"] for name in SCENARIOS}
    assert last["host_refresh"]["shard_refreshes"] == 2
    assert last["host_refresh"]["forced_restacks"] == 0
    assert last["forced_restack"]["forced_restacks"] == 1
    g = last["gapped"]
    assert g["absorbed"] > 0 and g["overflowed"] > 0 and g["shard_compactions"] == 2
    # the compactions fitted the leaves; the rebalance that follows
    # outgrows a shard's leaf rows and restacks at its bounds, in both packages
    assert tier_replays["gapped"]["port"]["trace"][-2]["metrics"]["forced_restacks"] == 0
    assert g["rebalances"] == 1 and g["rebalance_moved_keys"] > 0
    assert last["rebalance"]["rebalances"] >= 1 and last["rebalance"]["retunes"] == 0
    snap = tier_replays["device_scan"]["port"]["device_refreshes"]
    assert tobs.sample_value(snap, "device_refreshes", kind="PGM", outcome="ok") == 1
    assert last["device_scan"]["shard_refreshes"] == 1 and last["device_scan"]["pending"] == 0
    fast = tier_replays["device_fast"]["port"]["device_refreshes"]
    assert sum(s["value"] for s in fast["device_refreshes"]["samples"]) == 1


def test_tuned_tier_rebalance_bounds_equal_reference(tier_replays):
    got = tier_replays["rebalance"]["port"]["trace"]
    want = tier_replays["rebalance"]["ref"]["trace"]
    assert got[-1]["counts"] == want[-1]["counts"]
    assert got[-1]["counts"][0] < 8704 // 4
    assert got[-1]["metrics"]["rebalance_moved_keys"] == want[-1]["metrics"][
        "rebalance_moved_keys"] > 0


def test_tuned_tier_retune_stays_within_budget():
    rng = np.random.default_rng(71)
    table = make_table(rng, "uniform", 4096)
    policy = ttune.RebuildPolicy(space_budget_pct=2.0, retune_frac=0.02, n_queries=128,
                                 kinds=("RMI", "PGM", "BTREE"))
    tier = ttune.TunedTier(table, 4, policy, spec=tix.RMISpec(b=64), name="tt_retune",
                           device="cpu")
    new = _inside(rng, table, 0, 4095, 120)
    tier.insert_batch(new)
    merged = np.union1d(table, new)
    m = tier.metrics()
    assert m["retunes"] == 1 and m["pending"] == 0 and m["n_keys"] == len(merged)
    assert tier.spec.kind in ("RMI", "PGM", "BTREE")
    assert tix.build(tier.spec, merged, device="cpu").space_bytes() <= 0.02 * 8 * len(merged)
    qs = rng.choice(merged, 512)
    np.testing.assert_array_equal(tier.lookup(qs).numpy(), _truth(merged, qs))
    assert tier.metrics()["routing"]["lookups"] == 1


def test_tuned_tier_refuses_kernel_for_gapped_at_construction():
    table = make_table(np.random.default_rng(72), "uniform", 2048)
    with pytest.raises(ValueError, match="supports backends"):
        ttune.TunedTier(table, 2, spec=tix.GappedSpec(leaf_cap=64), name="tt_refuse",
                        device="cpu")
    tier = ttune.TunedTier(table, 2, ttune.RebuildPolicy(backend="bbs"),
                           spec=tix.GappedSpec(leaf_cap=64), name="tt_bbs", device="cpu")
    qs = table[::7]
    np.testing.assert_array_equal(tier.lookup(qs).numpy(), _truth(table, qs))


def test_tuned_tier_counters_proxy_and_deprecated_aliases():
    table = make_table(np.random.default_rng(73), "uniform", 2048)
    tier = ttune.TunedTier(table, 2, spec=tix.RMISpec(b=64), name="tt_proxy", device="cpu")
    tier.counters.pending += 7
    assert tier.counters.pending == 7
    assert tobs.metric("tier_pending").value(tier="tt_proxy") == 7.0
    assert tier.metrics()["pending"] == 7
    tier.counters.pending = 0
    with pytest.raises(AttributeError):
        tier.counters.nonsense = 1
    with pytest.warns(DeprecationWarning):
        tier.ingest(np.array([], dtype=np.uint64))
    with pytest.warns(DeprecationWarning):
        assert tier.maybe_rebuild() is None
