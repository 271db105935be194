"""The port's observability core held against the JAX reference
(``repro.obs``): the metric catalogue, the registry's snapshots, JSONL,
diffs, quantiles and resets on the same updates (float32 bucket edges
included), spans and stopwatches, the ``dump``/``diff`` CLI, the sharded
tier's telemetry, and the ``mutation_*`` and ``fit_fast_fallbacks``
counters.

The same seeded numpy inputs go through both packages, each on a private
registry or on its own default registry.  Counts, labels and JSONL text
are equal, no tolerance: the histogram sums too, as both packages sum the
grouped values in float32 in input order.  Reference calls run once a
module through ``scope="module"`` fixtures.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import index as rix
from repro import obs as robs
from repro import tune as rtune
from repro.data import distributions
from repro.dist import sharded_index as rsi
from repro.index import mutation as rmut
from repro.obs import __main__ as rcli
from repro_torch import index as tix
from repro_torch import obs as tobs
from repro_torch import tune as ttune
from repro_torch.dist import sharded_index as tsi
from repro_torch.index import mutation as tmut
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import registry as treg

from conftest import make_queries, make_table

ROOT = Path(__file__).resolve().parents[1]
N = 2048
LABEL = "obs_parity"

# ---------------------------------------------------------------------------
# Catalogue and registry on the same updates
# ---------------------------------------------------------------------------


def test_metric_catalogue_equals_reference():
    assert tobs.metric_catalogue() == robs.metric_catalogue()
    assert tobs.CATALOGUE == robs.CATALOGUE


def test_default_edges_and_exp_edges_equal_reference():
    assert treg.DEFAULT_LATENCY_EDGES == robs.registry.DEFAULT_LATENCY_EDGES
    assert tobs.exp_edges(2.0, 5e5, 31) == robs.exp_edges(2.0, 5e5, 31)
    for bad in ((0.0, 1.0, 4), (2.0, 1.0, 4), (1.0, 2.0, 1)):
        with pytest.raises(ValueError):
            tobs.exp_edges(*bad)


def _edge_values(edges) -> list:
    """Values on and beside every edge: the f64 edge, its f64 neighbours,
    the f32-rounded edge and the f32 neighbours of that."""
    out = []
    for e in edges:
        e32 = np.float32(e)
        out += [e, np.nextafter(e, -np.inf), np.nextafter(e, np.inf), float(e32),
                float(np.nextafter(e32, np.float32(-np.inf))),
                float(np.nextafter(e32, np.float32(np.inf)))]
    return [float(v) for v in out]


CUSTOM_EDGES = (1.5, 3.0, 7.25, 100.0 / 3.0, 1e3 + 1e-9, 4096.0)


def _ops(case: str) -> list:
    """A seeded sequence of registry updates: ``(method, metric, args,
    labels)`` tuples applied alike to both packages' registries."""
    rng = np.random.default_rng({"edges": 0, "custom": 1, "random": 2, "mixed": 3}[case])
    ops = [
        ("inc", "route_queries", (4,), {"tier": "a"}),
        ("inc", "route_queries", (2.5,), {"tier": "b"}),
        ("inc", "tier_lookups", (), {"tier": "a"}),
        ("set", "route_imbalance_last", (1.25,), {"tier": "a"}),
        ("max", "route_imbalance_peak", (3.0,), {"tier": "a"}),
        ("max", "route_imbalance_peak", (2.0,), {"tier": "a"}),
        ("inc", "device_refreshes", (), {"kind": "PGM", "outcome": "ok"}),
        ("set", "hotcache_entries", (17,), {"tier": "z"}),
    ]
    if case == "edges":
        vals = _edge_values(treg.DEFAULT_LATENCY_EDGES)
    elif case == "custom":
        vals = _edge_values(CUSTOM_EDGES)
    elif case == "random":
        vals = list(10 ** rng.uniform(-1, 7.5, 400))
    else:
        vals = _edge_values(treg.DEFAULT_LATENCY_EDGES[::7]) + list(10 ** rng.uniform(0, 6, 97))
    vals = [float(v) for v in vals]
    hist = "custom_us" if case == "custom" else "lookup_latency_us"
    lab = {"kind": "RMI", "backend": "kernel", "tier": "t"}
    glabs = lab if hist == "lookup_latency_us" else {"x": "0"}
    for i in range(0, len(vals), 37):
        chunk = vals[i:i + 37]
        ops.append(("observe_groups", hist, ([({**glabs, **({"phase": "host"} if "phase" in
                                                            _labels(hist) else {})}, chunk[::2]),
                                              ({**glabs, **({"phase": "device"} if "phase" in
                                                            _labels(hist) else {})}, chunk[1::2])],),
                    {}))
        for v in chunk[:5]:
            ops.append(("observe", "span_us", (v,), {"name": f"s{i % 3}"}))
        ops.append(("inc", "route_queries", (len(chunk),), {"tier": "a"}))
    return ops


def _labels(name: str) -> tuple:
    if name == "custom_us":
        return ("x",)
    return next(row[2] for row in treg.CATALOGUE if row[0] == name)


def _apply(reg, ops, stop=None):
    if "custom_us" not in reg._metrics:
        reg.histogram("custom_us", labels=("x",), help="parity", edges=CUSTOM_EDGES)
    for method, name, args, labels in ops[:stop]:
        m = reg._metrics[name] if name == "custom_us" else reg.metric(name)
        getattr(m, method)(*args, **labels)
    return reg


CASES = ("edges", "custom", "random", "mixed")


@pytest.fixture(scope="module")
def registries():
    out = {}
    for case in CASES:
        ops = _ops(case)
        half = len(ops) // 2
        out[case] = {
            pkg: (_apply(mod.Registry(), ops, half).snapshot(),
                  _apply(mod.Registry(), ops).snapshot())
            for pkg, mod in (("ref", robs), ("port", tobs))
        }
    return out


@pytest.mark.parametrize("case", CASES)
def test_snapshot_equals_reference(registries, case):
    assert registries[case]["port"] == registries[case]["ref"]


@pytest.mark.parametrize("case", CASES)
def test_to_jsonl_text_equals_reference(registries, case):
    for i in range(2):
        text = tobs.to_jsonl(registries[case]["port"][i])
        assert text == robs.to_jsonl(registries[case]["ref"][i])
        assert tobs.from_jsonl(text) == robs.from_jsonl(text)
        assert tobs.to_jsonl(tobs.from_jsonl(text)) == text


@pytest.mark.parametrize("case", CASES)
def test_diff_equals_reference(registries, case):
    a, b = registries[case]["port"]
    ra, rb = registries[case]["ref"]
    assert tobs.diff(a, b) == robs.diff(ra, rb)
    assert tobs.diff(b, a) == robs.diff(rb, ra)


@pytest.mark.parametrize("case", CASES)
def test_quantiles_and_find_sample_equal_reference(registries, case):
    snap, rsnap = registries[case]["port"][1], registries[case]["ref"][1]
    n_hist = 0
    for name, entry in snap.items():
        for s in entry["samples"]:
            got = tobs.find_sample(snap, name, **s["labels"])
            assert got == robs.find_sample(rsnap, name, **s["labels"])
            if entry["type"] == "histogram":
                n_hist += 1
                for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
                    assert tobs.hist_quantile(got, q) == robs.hist_quantile(got, q)
            else:
                assert tobs.sample_value(snap, name, **s["labels"]) == s["value"]
    assert n_hist >= 2
    assert tobs.find_sample(snap, "span_us", name="absent") is None
    assert tobs.sample_value(snap, "route_queries", default=-1.0, tier="absent") == -1.0


@pytest.mark.parametrize("prefix", ("route_", "span_", "lookup_", "custom", None))
def test_reset_prefix_equals_reference(prefix):
    ops = _ops("mixed")
    regs = [_apply(mod.Registry(), ops) for mod in (robs, tobs)]
    for reg in regs:
        reg.reset(prefix=prefix)
    assert regs[1].snapshot() == regs[0].snapshot()
    # declarations survive a reset
    assert sorted(regs[1]._metrics) == sorted(regs[0]._metrics)


def test_observe_and_observe_groups_split_at_f32_edges_like_reference():
    """``observe`` buckets in f64 and ``observe_groups`` in f32, on
    purpose: a value just below an edge in f64 rounds onto it in f32."""
    edges = treg.DEFAULT_LATENCY_EDGES
    e = edges[20]
    below = float(np.nextafter(e, -np.inf))
    assert float(np.float32(below)) >= float(np.float32(e))
    snaps = []
    for mod in (robs, tobs):
        reg = mod.Registry()
        reg.metric("span_us").observe(below, name="f64")
        reg.metric("span_us").observe_groups([({"name": "f32"}, [below])])
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    f64 = tobs.find_sample(snaps[1], "span_us", name="f64")["counts"]
    f32 = tobs.find_sample(snaps[1], "span_us", name="f32")["counts"]
    assert f64.index(1) == 20 and f32.index(1) == 21


def test_registry_declaration_rules_match_reference():
    for mod in (robs, tobs):
        reg = mod.Registry()
        with pytest.raises(KeyError):
            reg.metric("not_a_metric")
        reg.counter("c", labels=("a",))
        with pytest.raises(ValueError):
            reg.gauge("c", labels=("a",))
        with pytest.raises(ValueError):
            reg.metric("route_queries").inc(1, shard=0)
        with pytest.raises(ValueError):
            reg.histogram("h", edges=(1.0, 1.0, 2.0))
    calls = []
    reg = tobs.Registry()
    reg.register_collector(lambda r: calls.append(r))
    reg.snapshot()
    assert calls == [reg]


def test_span_and_stopwatch_record():
    reg = tobs.Registry()
    sw = tobs.stopwatch()
    with tobs.span("obs_test.outer", registry=reg) as inner_sw:
        with tobs.span("obs_test.inner", registry=reg):
            pass
        assert inner_sw.elapsed >= 0.0
    assert sw.elapsed >= 0.0
    snap = reg.snapshot()
    for name in ("obs_test.outer", "obs_test.inner"):
        assert tobs.find_sample(snap, "span_us", name=name)["count"] == 1
    with tobs.Stopwatch() as sw2:
        pass
    assert sw2.elapsed >= 0.0


def test_span_under_repro_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE", str(tmp_path))
    reg = tobs.Registry()
    with tobs.span("obs_test.prof", registry=reg):
        with tobs.span("obs_test.nested", registry=reg):
            torch.arange(8).sum()
    traces = list(tmp_path.glob("*.trace.json"))
    assert len(traces) == 1 and traces[0].name.startswith("obs_test.prof.")
    assert tobs.find_sample(reg.snapshot(), "span_us", name="obs_test.nested")["count"] == 1


def test_timed_lookup_records_both_phases():
    rng = np.random.default_rng(3)
    table = make_table(rng, "uniform", N)
    qs = make_queries(rng, table, 256)
    idx = tix.build(tix.RMISpec(b=64), table, device="cpu")
    reg = tobs.Registry()
    out = tobs.timed_lookup(idx, table, qs, tier="obs_test", registry=reg)
    np.testing.assert_array_equal(out.numpy(), idx.lookup(table, qs).numpy())
    snap = reg.snapshot()
    lab = dict(kind="RMI", backend="kernel", tier="obs_test")
    host = tobs.find_sample(snap, "lookup_latency_us", **lab, phase="host")
    dev = tobs.find_sample(snap, "lookup_latency_us", **lab, phase="device")
    assert host["count"] == dev["count"] == 1
    assert dev["sum"] >= host["sum"] > 0.0
    tobs.timed_lookup(idx, table, qs, tier="obs_test", registry=reg, backend="xla")
    assert tobs.find_sample(reg.snapshot(), "lookup_latency_us", kind="RMI", backend="xla",
                            tier="obs_test", phase="host")["count"] == 1


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_cli")
    ops = _ops("mixed")
    half = len(ops) // 2
    before, after = d / "before.jsonl", d / "after.jsonl"
    before.write_text(tobs.to_jsonl(_apply(tobs.Registry(), ops, half).snapshot()))
    after.write_text(tobs.to_jsonl(_apply(tobs.Registry(), ops).snapshot()))
    return before, after


@pytest.mark.parametrize("argv", (("dump", "after"), ("dump", "before"), ("diff", "before", "after"),
                                  ("diff", "after", "before")))
def test_cli_output_equals_reference(cli_files, argv):
    files = dict(zip(("before", "after"), cli_files))
    args = [argv[0]] + [str(files[a]) for a in argv[1:]]
    got = _run_cli(tcli.main, args)
    assert got == _run_cli(rcli.main, args)
    assert "route_queries" in got


def test_cli_runs_as_a_module(cli_files):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "dump", str(cli_files[1])],
                         capture_output=True, text=True, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _run_cli(rcli.main, ["dump", str(cli_files[1])])


# ---------------------------------------------------------------------------
# Tier telemetry against the reference
# ---------------------------------------------------------------------------

#: (port kind, port backend, reference backend): the port's kernel path
#: (its twin on the CPU) against the reference's default path
TIER_CASES = (("RMI", "kernel", "xla"), ("PGM", "kernel", "xla"), ("KO", "xla", "xla"),
              ("RS", "ref", "ref"))
TIER_PARAMS = {"RMI": {"b": 64}, "PGM": {"eps": 16}, "KO": {"k": 7}, "RS": {"eps": 16, "r_bits": 8}}


def _tier_run(pkg: str, kind: str, backend: str) -> dict:
    rng = np.random.default_rng(11)
    table = make_table(rng, "uniform", N)
    batches = [make_queries(rng, table, 512), make_queries(rng, table, 256),
               np.full(256, table[-1], dtype=np.uint64),  # every query owned by the last shard
               rng.choice(table[: N // 4], 300).astype(np.uint64)]
    si, obs = (rsi, robs) if pkg == "ref" else (tsi, tobs)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    sidx = si.ShardedIndex.build(kind, table, n_shards=4, **kw, **TIER_PARAMS[kind])
    si.reset_tier_metrics()
    sink = si._fresh_tier_metrics()
    outs = [np.asarray(si.sharded_lookup(sidx, batches[0], backend=backend))]  # telemetry off
    assert si.tier_metrics()["lookups"] == 0
    for i, qs in enumerate(batches):
        label = LABEL if i % 2 == 0 else None
        outs.append(np.asarray(si.sharded_lookup(sidx, qs, backend=backend, telemetry=True,
                                                 telemetry_sink=sink, telemetry_label=label)))
    return {
        "outs": outs,
        "tier_metrics": si.tier_metrics(),
        "labelled": si._tier_counters_from_obs(LABEL),
        "derived": si.derived_tier_metrics(si._tier_counters_from_obs(LABEL)),
        "weights": si.shard_query_weights(LABEL, 4),
        "sink": dict(sink),
        "snapshot": obs.snapshot(prefix="route_"),
    }


@pytest.fixture(scope="module")
def tier_runs():
    return {case: {"ref": _tier_run("ref", case[0], case[2]),
                   "port": _tier_run("port", case[0], case[1])} for case in TIER_CASES}


@pytest.mark.parametrize("case", TIER_CASES, ids=lambda c: c[0])
def test_tier_metrics_equal_reference(tier_runs, case):
    got, want = tier_runs[case]["port"], tier_runs[case]["ref"]
    for a, b in zip(got["outs"], want["outs"]):
        np.testing.assert_array_equal(a, b)
    assert got["tier_metrics"] == want["tier_metrics"]
    assert got["tier_metrics"]["lookups"] == 4
    assert got["tier_metrics"]["imbalance_peak"] == pytest.approx(4.0)


@pytest.mark.parametrize("case", TIER_CASES, ids=lambda c: c[0])
def test_labelled_tier_counters_equal_reference(tier_runs, case):
    got, want = tier_runs[case]["port"], tier_runs[case]["ref"]
    assert got["labelled"] == want["labelled"]
    assert got["derived"] == want["derived"]
    assert got["labelled"]["lookups"] == 2
    np.testing.assert_array_equal(got["weights"], want["weights"])
    assert got["weights"].dtype == np.float64


@pytest.mark.parametrize("case", TIER_CASES, ids=lambda c: c[0])
def test_telemetry_sink_and_snapshot_equal_reference(tier_runs, case):
    got, want = tier_runs[case]["port"], tier_runs[case]["ref"]
    assert got["sink"] == want["sink"]
    assert got["snapshot"] == want["snapshot"]


def test_derived_tier_metrics_tolerates_empty_and_zero():
    m = tsi.derived_tier_metrics({})
    assert m == rsi.derived_tier_metrics({})
    assert m["queries"] == 0 and m["drop_rate"] == 0.0 and m["imbalance_mean"] == 0.0
    m = tsi.derived_tier_metrics({"queries": 100, "dropped": 1, "routed_max": 50,
                                  "routed_even": 25.0})
    assert m["drop_rate"] == pytest.approx(0.01)
    assert m["imbalance_mean"] == pytest.approx(2.0)


def test_reset_tier_metrics_leaves_caller_sink_alone():
    rng = np.random.default_rng(4)
    table = make_table(rng, "uniform", N)
    qs = make_queries(rng, table, 256)
    sidx = tsi.ShardedIndex.build("RMI", table, n_shards=4, b=64, device="cpu")
    sink = tsi._fresh_tier_metrics()
    tsi.sharded_lookup(sidx, qs, telemetry=True, telemetry_sink=sink)
    assert sink["queries"] == len(qs)
    tsi.reset_tier_metrics()
    assert tsi.tier_metrics()["queries"] == 0
    assert sink["queries"] == len(qs)


def test_telemetry_off_paths_never_import_obs():
    """With ``repro_torch.obs`` evicted, telemetry-off ``Index.lookup`` and
    ``sharded_lookup`` complete without importing it again."""
    import repro_torch

    rng = np.random.default_rng(5)
    table = make_table(rng, "uniform", N)
    qs = make_queries(rng, table, 256)
    idx = tix.build(tix.RMISpec(b=64), table, device="cpu")
    sidx = tsi.ShardedIndex.build("RMI", table, n_shards=4, b=64, device="cpu")
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.startswith("repro_torch.obs")}
    saved_attr = repro_torch.__dict__.pop("obs", None)
    try:
        for backend in ("kernel", "xla", "ref"):
            idx.lookup(table, qs, backend=backend)
            tsi.sharded_lookup(sidx, qs, backend=backend, telemetry=False)
        leaked = [k for k in sys.modules if k.startswith("repro_torch.obs")]
        assert not leaked, f"telemetry-off lookup imported {leaked}"
    finally:
        sys.modules.update(saved)
        if saved_attr is not None:
            repro_torch.obs = saved_attr


# ---------------------------------------------------------------------------
# mutation_* and fit_fast_fallbacks
# ---------------------------------------------------------------------------


def _mutation_run(pkg: str) -> dict:
    rng = np.random.default_rng(21)
    table = make_table(rng, "uniform", N)
    ix, mut, obs = (rix, rmut, robs) if pkg == "ref" else (tix, tmut, tobs)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    idx = ix.build("GAPPED", table, leaf_cap=16, fill=0.5, delta_cap=64, **kw)
    before = obs.snapshot(prefix="mutation_")
    reports = []
    batches = [np.unique(make_queries(rng, table, 32)),
               np.unique(rng.integers(int(table[10]), int(table[11]), 40, dtype=np.uint64)),
               np.unique(make_queries(rng, table, 64))]
    for keys in batches:
        idx, report = mut.insert_batch(idx, keys)
        reports.append(report)
    idx = mut.compact(idx)
    idx, report = mut.insert_batch(idx, batches[0])  # all duplicates now
    reports.append(report)
    return {"diff": obs.diff(before, obs.snapshot(prefix="mutation_")),
            "reports": [tuple(r.__dict__.values()) for r in reports]}


@pytest.fixture(scope="module")
def mutation_runs():
    return {pkg: _mutation_run(pkg) for pkg in ("ref", "port")}


def test_mutation_reports_equal_reference(mutation_runs):
    assert mutation_runs["port"]["reports"] == mutation_runs["ref"]["reports"]


def test_mutation_counters_equal_reference(mutation_runs):
    got = mutation_runs["port"]["diff"]
    assert got == mutation_runs["ref"]["diff"]
    assert tobs.sample_value(got, "mutation_compactions", kind="GAPPED") >= 1
    assert tobs.sample_value(got, "mutation_requested", kind="GAPPED") > 0


#: adjacent keys at 2^60 collide in f64: the fast fits fall back for them
_COLLIDING = (np.uint64(1) << np.uint64(60)) + np.arange(1024, dtype=np.uint64)


@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_fit_fast_fallbacks_equal_reference(kind):
    tables = [_COLLIDING, distributions.generate("osm", 1024, seed=3), _COLLIDING + np.uint64(7)]
    params = {"eps": 16} if kind == "PGM" else {"eps": 16, "r_bits": 8}
    diffs = []
    for ix, tune, obs, kw in ((rix, rtune, robs, {}), (tix, ttune, tobs, {"device": "cpu"})):
        before = obs.snapshot(prefix="fit_")
        tune.build_many(ix.spec_for(kind, **params), tables, fit="fast", **kw)
        diffs.append(obs.diff(before, obs.snapshot(prefix="fit_")))
    assert diffs[1] == diffs[0]
    assert tobs.sample_value(diffs[1], "fit_fast_fallbacks", kind=kind) == 2
