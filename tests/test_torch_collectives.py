"""The port's collective layer held against the JAX reference on the CPU.

``dist.collectives`` (``exchange_capacity``, ``bucket_by_owner``,
``unbucket_inverse``) against the reference's functions called directly;
``sharded_lookup(mode="a2a"/"allgather")`` over spawned gloo ranks (one
shard a rank) against the reference's own collective modes, run once in a
subprocess on 4 forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
``refresh_shard``, ``weighted_quantile_bounds`` and ``rebalance_shards``
against the reference's, in one process and one shard a rank; and
``ShardingCtx`` against the reference's rules.  Ranks are integers:
equal, ``DROPPED`` positions included, no tolerance.

The reference subprocess and the port's 4 ranks run once for the module,
side by side (fixture ``runs``), on the tiers and inputs the port saved
(either package reads the other's npz).  The reference runs its default ``xla`` backend; every
port backend must give the same ranks, and the drop set must not depend
on the backend.  The reference's ``a2a`` cannot slice a ragged batch on
this JAX (``out[:b]`` of the sharded result raises ``ShardingTypeError``),
so its ragged cases run on the batch it pads itself (uint64 ``0`` up to a
multiple of the shard count) and are cut on the host.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import index as rix
from repro.core.cdf import true_ranks
from repro.dist import collectives as rcol
from repro.dist import sharded_index as rsi
from repro.index import registry as rreg
from repro_torch import index as tix
from repro_torch.core import keys
from repro_torch.dist import collectives as tcol
from repro_torch.dist import sharded_index as tsi
from repro_torch.dist import sharding as tsh

from conftest import make_queries, make_table
from test_torch_gpu import fresh_keys, packed_batch, replay_cases, run_ranks

SRC = Path(__file__).resolve().parents[1] / "src"
PARAMS = {"RMI": {"b": 64}, "PGM": {"eps": 32}, "BTREE": {"fanout": 8}, "SY-RMI": {},
          "PGM_M": {}, "RS": {}, "KO": {}, "GAPPED": {"leaf_cap": 64, "delta_cap": 128}}
#: (n_shards, mesh shape, tp rule, kinds): 2-way on a (2, 2) mesh's model
#: dim, 4-way over the flattened (data, model) dims of a (1, 4) mesh
LAYOUTS = ((2, [2, 2], ["model"], ("RMI", "PGM", "BTREE")),
           (4, [1, 4], ["data", "model"], tuple(PARAMS)))
LOGICAL = ("dp", "fsdp", "tp", "ep", "edge", "row", "nonexistent")
PROBE_MESHES = (([1, 4], ["data", "model"]), ([2, 2], ["data", "model"]),
                ([4, 1], ["data", "model"]), ([1, 2, 2], ["pod", "data", "model"]),
                ([2, 1, 2], ["pod", "data", "model"]))
#: port backends besides the reference's default ``xla``: same ranks
PORT_BACKENDS = ("kernel", "bbs", "ref")


def port_backends(kind: str) -> tuple:
    """``xla`` and the port backends the kind claims (GAPPED: no kernel)."""
    claimed = tix.impls.query_impl(kind).backends
    return tuple(b for b in ("xla",) + PORT_BACKENDS if b in claimed)

# The reference side: runs every case's collective mode on 4 forced host
# devices on the tiers and inputs the port saved (either package reads the
# other's npz), and saves each answer and each refreshed or rebalanced tier.
REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import repro
from repro import index as ix
from repro.dist import sharded_index as si
from repro.dist.sharding import ShardingCtx
from repro.index import registry

work = sys.argv[1]
path = lambda name: os.path.join(work, name)
spec = json.load(open(path("ref_cases.json")))
assert len(jax.devices()) == 4
probes, ctxs = {}, {}

def ctx_for(case):
    key = json.dumps([case["mesh"], case.get("names"), case.get("rules"), case.get("profile")])
    if key not in ctxs:
        mesh = jax.make_mesh(tuple(case["mesh"]), tuple(case.get("names", ("data", "model"))))
        ctxs[key] = ShardingCtx(mesh=mesh, profile=case.get("profile", "tp_fsdp"),
                                rules=case.get("rules") or {})
    return ctxs[key]

for case in spec["cases"]:
    name, ctx = case["name"], ctx_for(case)
    if "probe" in case:
        probes[name] = {l: [list(ctx.mesh_axes(l)), ctx.n(l)] for l in case["probe"]}
        continue
    sidx = si.ShardedIndex.load(path(case["tier"]))
    if "refresh" in case:
        r = case["refresh"]
        sidx = si.refresh_shard(sidx, r["shard"], ix.Index.load(path(r["index"])),
                                np.load(path(r["table"])))
        sidx.save(path(r["after"]))
    if "insert" in case:
        r = case["insert"]
        with np.load(path(r["batches"])) as z:
            batches = [z["shard%d" % s] for s in range(case["n_shards"])]
        reports = []
        for s, b in enumerate(batches):
            sidx, rep = si.insert_into_shard(sidx, s, b)
            reports.append([int(x) for x in dataclasses.astuple(rep)])
        for s in r["compact"]:
            sidx = si.compact_shard(sidx, s)
        sidx.save(path(r["after"]))
        json.dump(reports, open(path(r["reports"]), "w"))
    if "rebalance" in case:
        r = case["rebalance"]
        spec_r = registry.spec_for(r["kind"], **r["params"])
        build = registry.entry(spec_r.kind).build
        sidx = si.rebalance_shards(sidx, np.load(path(r["merged"])), np.load(path(r["bounds"])),
                                   lambda part: build(spec_r, part))
        sidx.save(path(r["after"]))
    qs = np.load(path(case["queries"]))
    n = case["n_shards"]
    # the reference's own padding of a ragged a2a batch, cut on the host
    q = np.concatenate([qs, np.zeros((-len(qs)) % n, np.uint64)]) if case["mode"] == "a2a" else qs
    got = np.asarray(si.sharded_lookup(sidx, q, ctx, mode=case["mode"],
                                       cap_factor=case["cap_factor"]))[: len(qs)]
    np.save(path("ref_" + name.replace("/", "_") + ".npy"), got)
json.dump(probes, open(path("ref_probes.json"), "w"))
print("REF OK")
"""


def _queries(rng, table, n_table=200, n_random=100):
    """Table keys, random keys and the extremes (0, min, max, 2^64 - 1)."""
    return np.concatenate([
        rng.choice(table, n_table), rng.integers(0, 2**63, n_random, dtype=np.uint64),
        np.array([0, table.min(), table.max(), 2**64 - 1], dtype=np.uint64),
    ]).astype(np.uint64)


def _cases(work: Path) -> list:
    """The cases both sides run; writes their tables, query batches, tiers
    (built by the port), the rebuilt shard of the refresh case and the
    bounds of the rebalance case."""
    rng = np.random.default_rng(5)
    table = make_table(rng, "uniform", 2500)
    wide = make_table(rng, "uniform", 8704)  # 4 x 2,176 keys in m = 4,096: slack to rebalance
    np.save(work / "table.npy", table)
    np.save(work / "wide.npy", wide)
    qs = _queries(rng, table)  # 304 queries
    batches = {
        "even": qs,
        "ragged": qs[:303],  # B % 4 = 3: one pad key routes to shard 0
        "skew": np.full(64, table[-1], dtype=np.uint64),  # every query on the last shard
        "skew_ragged": np.full(63, table[-1], dtype=np.uint64),
        "wide": _queries(rng, wide, 400, 111),
    }
    for k, v in batches.items():
        np.save(work / f"q_{k}.npy", v)
    tiers = {}

    def tier(kind, n, source="table"):
        name = f"tier_{n}_{kind}_{source}.npz"
        if name not in tiers:
            tiers[name] = tsi.ShardedIndex.build(kind, np.load(work / f"{source}.npy"), n,
                                                  device="cpu", **PARAMS[kind])
            tiers[name].save(work / name)
        return name

    # GAPPED: the tier saved as built, and mutated (routed inserts in every
    # shard, a batch packed into one leaf of shard 2 that populates its
    # delta, shard 1 compacted), whose answers hold against its live keys
    gapped = tsi.ShardedIndex.load(work / tier("GAPPED", 4), device="cpu")
    fresh = fresh_keys(rng, table, 300)
    owners = tsi.route_owners(gapped.fences, keys.encode(fresh, "cpu")).numpy()
    batches = {f"shard{s}": fresh[owners == s] for s in range(4)}
    packed = packed_batch(gapped.shard(2), np.union1d(table, fresh), 8)
    batches["shard2"] = np.union1d(batches["shard2"], packed)
    np.savez(work / "gapped_batches.npz", **batches)
    for s in range(4):
        tsi.insert_into_shard(gapped, s, batches[f"shard{s}"])
    tsi.compact_shard(gapped, 1)
    assert int(gapped.index.arrays["delta_count"][2]) >= len(packed) > 0
    gapped.save(work / "tier_4_GAPPED_mutated.npz")
    np.save(work / "gapped_live.npy", np.union1d(table, np.concatenate(list(batches.values()))))

    cases = []
    for n, mesh, tp, kinds in LAYOUTS:
        layout = {"n_shards": n, "mesh": mesh, "rules": {"tp": tp}}
        for kind in kinds:
            mutated = {"tier": "tier_4_GAPPED_mutated.npz", "live": "gapped_live.npy"}
            where = mutated if kind == "GAPPED" else {"tier": tier(kind, n)}
            for mode, batch in (("a2a", "even"), ("a2a", "ragged"), ("allgather", "ragged")):
                cases.append({**layout, **where, "name": f"{mode}/{n}/{kind}/{batch}",
                              "kind": kind, "mode": mode, "queries": f"q_{batch}.npy",
                              "cap_factor": float(n)})
        cases.append({**layout, "name": f"a2a/{n}/RMI/ragged@1.0", "tier": tier("RMI", n),
                      "mode": "a2a", "queries": "q_ragged.npy", "cap_factor": 1.0})
        if n == 4:  # the reference's skewed overflow case, and a ragged one
            for batch in ("skew", "skew_ragged"):
                cases.append({**layout, "name": f"a2a/4/RMI/{batch}@0.26", "tier": tier("RMI", 4),
                              "mode": "a2a", "queries": f"q_{batch}.npy", "cap_factor": 0.26})
    four = {"n_shards": 4, "mesh": [1, 4], "rules": {"tp": ["data", "model"]}, "mode": "a2a",
            "cap_factor": 4.0}
    # shard 1 rebuilt with its last 5 keys retired (the reference's subprocess case)
    sidx = tiers[tier("RMI", 4)]
    new_keys = keys.decode(sidx.tables[1])[:int(sidx.counts[1]) - 5]
    m = int(sidx.tables.shape[1])
    tix.build("RMI", tsi._pad_sorted_table(new_keys, m), device="cpu",
              **PARAMS["RMI"]).save(work / "refresh_idx.npz")
    np.save(work / "refresh_keys.npy", new_keys)
    cases.append({**four, "name": "refresh/4/RMI", "tier": tier("RMI", 4), "queries": "q_even.npy",
                  "refresh": {"shard": 1, "index": "refresh_idx.npz", "table": "refresh_keys.npy",
                              "after": "refresh_after.npz"}})
    # the same inserts and compaction, made by the ranks under the context
    cases.append({**four, "name": "insert/4/GAPPED", "kind": "GAPPED", "tier": tier("GAPPED", 4),
                  "queries": "q_even.npy", "live": "gapped_live.npy",
                  "insert": {"batches": "gapped_batches.npz", "compact": [1],
                             "after": "insert_after.npz", "reports": "insert_reports.json"}})
    wide_tier = tiers[tier("RMI", 4, "wide")]
    np.save(work / "rebalance_bounds.npy", tsi.weighted_quantile_bounds(
        wide, keys.decode(wide_tier.fences), [2.0, 1.0, 1.0, 1.0]))
    cases.append({**four, "name": "rebalance/4/RMI", "tier": tier("RMI", 4, "wide"),
                  "queries": "q_wide.npy",
                  "rebalance": {"kind": "RMI", "params": PARAMS["RMI"], "merged": "wide.npy",
                                "bounds": "rebalance_bounds.npy", "after": "rebalance_after.npz"}})
    for i, (shape, names) in enumerate(PROBE_MESHES):
        for profile in tsh.PROFILES:
            cases.append({"name": f"probe/{i}/{profile}", "probe": LOGICAL, "mesh": shape,
                          "names": names, "profile": profile})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, once: the reference in a subprocess on 4 forced host
    devices and, at the same time, the port on 4 spawned gloo ranks (one
    shard a rank) on every backend.  Returns the work directory, the
    cases, and each rank's answers and notes."""
    work = tmp_path_factory.mktemp("collectives")
    cases = _cases(work)
    port = []
    for case in cases:
        if "probe" in case:
            port.append(case)
            continue
        port += [{**case, "name": f"{case['name']}:{backend}", "backend": backend}
                 for backend in port_backends(case.get("kind", "RMI"))]
    (work / "cases.json").write_text(json.dumps({"cases": port}))
    (work / "ref_cases.json").write_text(json.dumps({"cases": cases}))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(replay_cases, 4, work, str(work), "cpu")
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF OK" in out, err[-4000:]
    outs, notes = [], []
    for rank in range(4):
        with np.load(work / f"out{rank}.npz") as z:
            outs.append({k: z[k] for k in z.files})
        notes.append(json.loads((work / f"out{rank}.json").read_text()))
    return work, cases, outs, notes


def _ref_answer(work: Path, name: str) -> np.ndarray:
    return np.load(work / ("ref_" + name.replace("/", "_") + ".npy"))


def test_inserts_under_ranks_match_reference(runs):
    """``insert_into_shard`` on every shard and ``compact_shard`` of shard
    1, called alike on the 4 ranks under the context (each holding one
    shard): every rank's reports equal the reference's, its shard's leaves
    equal the reference's mutated tier, every rank's fences, counts,
    offsets and last live keys equal it, and the a2a lookup after equals
    the reference's and numpy over the live keys, on every backend GAPPED
    claims."""
    work, cases, outs, notes = runs
    name = "insert/4/GAPPED"
    after = rsi.ShardedIndex.load(work / "insert_after.npz")
    reports = json.loads((work / "insert_reports.json").read_text())
    live = np.load(work / "gapped_live.npy")
    want = _ref_answer(work, name)
    qs = np.load(work / "q_even.npy")
    np.testing.assert_array_equal(want, true_ranks(live, qs))
    lasts = np.array([live[live < f].max() for f in np.asarray(after.fences)[1:]] + [live.max()],
                     dtype=np.uint64)
    for rank in range(4):
        for backend in port_backends("GAPPED"):
            key = f"{name}:{backend}"
            assert notes[rank][f"{key}/reports"] == reports, (rank, backend)
            assert notes[rank][key] == {"launches": 0, "others": 0}
            np.testing.assert_array_equal(outs[rank][key], want, err_msg=f"rank {rank} {backend}")
            for k, v in after.index.arrays.items():
                np.testing.assert_array_equal(outs[rank][f"{key}/idx_{k}"], np.asarray(v[rank]),
                                              err_msg=f"{key} {k}")
            for k in ("fences", "counts", "offsets"):
                np.testing.assert_array_equal(outs[rank][f"{key}/{k}"],
                                              np.asarray(getattr(after, k)))
            np.testing.assert_array_equal(outs[rank][f"{key}/lasts"], lasts)
    # the tier the port mutated in one process, which the lookup cases load,
    # equals the reference's mutated tier
    mutated = tsi.ShardedIndex.load(work / "tier_4_GAPPED_mutated.npz", device="cpu")
    for k, v in after.index.arrays.items():
        assert mutated.index.to_numpy()[k].tobytes() == np.asarray(v).tobytes(), k
    np.testing.assert_array_equal(keys.decode(mutated.lasts), lasts)


def _lookup_names():
    names = []
    for n, _, _, kinds in LAYOUTS:
        for kind in kinds:
            names += [f"a2a/{n}/{kind}/even", f"a2a/{n}/{kind}/ragged",
                      f"allgather/{n}/{kind}/ragged"]
        names.append(f"a2a/{n}/RMI/ragged@1.0")
    return names + ["a2a/4/RMI/skew@0.26", "a2a/4/RMI/skew_ragged@0.26"]


# -- collectives, called directly --------------------------------------------------------


def test_exchange_capacity_matches_reference():
    for n_local in (0, 1, 2, 3, 7, 16, 63, 64, 76, 1000, 4097, 1 << 20):
        for shards in (1, 2, 3, 4, 7, 160):
            for cap_factor in (0.0, 0.26, 0.5, 1.0, 1.25, 2.0, 3.999, 4.0, 160.0):
                assert tcol.exchange_capacity(n_local, shards, cap_factor) == \
                    rcol.exchange_capacity(n_local, shards, cap_factor), (n_local, shards, cap_factor)


@pytest.mark.parametrize("n,n_shards,cap", ((64, 4, 2), (64, 4, 64), (303, 2, 10), (1, 4, 1),
                                            (500, 7, 30)))
@pytest.mark.parametrize("owners", ("random", "ties", "one_owner"))
def test_bucket_and_unbucket_match_reference(n, n_shards, cap, owners):
    """The request matrix, slots, mask and sort order equal the
    reference's (stable: equal owners keep input order), and the replies
    scattered back equal its, with over-capacity entries at ``DROPPED``."""
    rng = np.random.default_rng(n * 31 + cap)
    if owners == "random":
        owner = rng.integers(0, n_shards, n).astype(np.int32)
    elif owners == "ties":  # long runs of equal owners, out of order
        owner = np.repeat(rng.permutation(n_shards), -(-n // n_shards))[:n].astype(np.int32)
    else:
        owner = np.full(n, n_shards - 1, dtype=np.int32)
    values = rng.integers(-2**62, 2**62, n).astype(np.int64)
    want = jax.jit(rcol.bucket_by_owner, static_argnums=(2, 3))(
        jnp.asarray(owner), jnp.asarray(values), n_shards, cap, jnp.zeros((), jnp.int64))
    got = tcol.bucket_by_owner(torch.from_numpy(owner), torch.from_numpy(values), n_shards, cap, 0)
    for name, w, g in zip(("req", "slots", "valid", "order"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    replies = rng.integers(0, 10**9, (n_shards, cap)).astype(np.int64)
    back_ref = jax.jit(rcol.unbucket_inverse, static_argnums=(4, 5))(
        jnp.asarray(replies), *want[1:], n, rsi.DROPPED)
    back = tcol.unbucket_inverse(torch.from_numpy(replies), *got[1:], n, tsi.DROPPED)
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_ref))
    assert (back.numpy() == tsi.DROPPED).sum() == n - int(got[2].sum())
    # an empty batch: every slot a fill slot, nothing scattered back
    req, slots, valid, order = tcol.bucket_by_owner(torch.zeros(0, dtype=torch.int32),
                                                    torch.zeros(0, dtype=torch.int64), n_shards,
                                                    cap, tsi.PAD_KEY)
    assert (req == tsi.PAD_KEY).all() and not valid.any() and req.shape == (n_shards, cap)
    assert tcol.unbucket_inverse(torch.from_numpy(replies), slots, valid, order, 0,
                                 tsi.DROPPED).shape == (0,)


# -- the collective modes over spawned gloo ranks ----------------------------------------


@pytest.mark.parametrize("name", _lookup_names())
def test_collective_modes_match_reference(runs, name):
    """Every rank's answer equals the reference's on every port backend,
    ``DROPPED`` positions included; without drops it is numpy's too."""
    work, cases, outs, _ = runs
    want = _ref_answer(work, name)
    case = next(c for c in cases if c["name"] == name)
    qs = np.load(work / case["queries"])
    exact = true_ranks(np.load(work / case.get("live", "table.npy")), qs)
    dropped = want == rsi.DROPPED
    if case["cap_factor"] >= case["n_shards"]:
        assert not dropped.any()
    if name.endswith("@0.26"):
        assert dropped.any()
    np.testing.assert_array_equal(want[~dropped], exact[~dropped])
    for rank in range(4):
        for backend in port_backends(case.get("kind", "RMI")):
            got = outs[rank][f"{name}:{backend}"]
            assert got.dtype == np.int64 and got.shape == qs.shape
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank} {backend}")


@pytest.mark.parametrize("op", ("refresh", "rebalance"))
def test_refresh_and_rebalance_under_ranks_match_reference(runs, op):
    """After ``refresh_shard``/``rebalance_shards`` called alike on every
    rank, each rank's shard leaves and table and the tier's fences, counts
    and offsets equal the reference's refreshed tier, and the following
    a2a lookup equals the reference's on every backend."""
    work, cases, outs, _ = runs
    name = f"{op}/4/RMI"
    after = rsi.ShardedIndex.load(work / f"{op}_after.npz")
    want = _ref_answer(work, name)
    table = np.load(work / ("table.npy" if op == "refresh" else "wide.npy"))
    if op == "refresh":
        counts = np.asarray(after.counts)
        table = np.concatenate([np.asarray(after.tables[s])[:counts[s]] for s in range(4)])
    qs = np.load(work / next(c for c in cases if c["name"] == name)["queries"])
    np.testing.assert_array_equal(want, true_ranks(table, qs))
    for rank in range(4):
        for backend in ("xla",) + PORT_BACKENDS:
            key = f"{name}:{backend}"
            np.testing.assert_array_equal(outs[rank][key], want, err_msg=f"rank {rank} {backend}")
            got = outs[rank]
            for k, v in after.index.arrays.items():
                np.testing.assert_array_equal(got[f"{key}/idx_{k}"], np.asarray(v[rank]),
                                              err_msg=f"{key} {k}")
            np.testing.assert_array_equal(got[f"{key}/table"], np.asarray(after.tables[rank]))
            for k in ("fences", "counts", "offsets"):
                np.testing.assert_array_equal(got[f"{key}/{k}"], np.asarray(getattr(after, k)))
            np.testing.assert_array_equal(
                got[f"{key}/lasts"], np.asarray(after.tables)[np.arange(4), np.asarray(after.counts) - 1])


@pytest.mark.parametrize("mesh", range(len(PROBE_MESHES)))
def test_sharding_ctx_resolves_like_reference(runs, mesh):
    """``mesh_axes`` and ``n`` of every logical axis equal the reference's
    rules on the same mesh shapes, both profiles; ``index`` is the rank's
    row-major position over the axis's dims."""
    work, _, _, notes = runs
    probes = json.loads((work / "ref_probes.json").read_text())
    shape, names = PROBE_MESHES[mesh]
    grid = np.arange(4).reshape(shape)
    for profile in tsh.PROFILES:
        key = f"probe/{mesh}/{profile}"
        for rank in range(4):
            coord = np.argwhere(grid == rank)[0]
            for logical, (axes, n) in probes[key].items():
                got_axes, got_n, got_index = notes[rank][key][logical]
                assert (got_axes, got_n) == (axes, n), (key, logical)
                dims = [names.index(a) for a in axes]
                want_index = 0
                for d in dims:
                    want_index = want_index * shape[d] + int(coord[d])
                assert got_index == want_index, (key, logical, rank)


# -- maintenance in one process ------------------------------------------------------------


def _tier_pair(kind, table, n_shards, **params):
    return (rsi.ShardedIndex.build(kind, table, n_shards=n_shards, **params),
            tsi.ShardedIndex.build(kind, table, n_shards, device="cpu", **params))


def _assert_tier_equal(ref, port):
    want = {k: np.asarray(v) for k, v in ref.index.arrays.items()}
    got = port.index.to_numpy()
    assert set(got) == set(want) and port.index.static == ref.index.static
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    np.testing.assert_array_equal(keys.decode(port.tables), np.asarray(ref.tables))
    np.testing.assert_array_equal(keys.decode(port.fences), np.asarray(ref.fences))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(port.offsets.numpy(), np.asarray(ref.offsets))
    counts = np.asarray(ref.counts)
    np.testing.assert_array_equal(keys.decode(port.lasts),
                                  np.asarray(ref.tables)[np.arange(len(counts)), counts - 1])


def _port_index(ref_index):
    return tix.Index.from_numpy(ref_index.kind, ref_index.static,
                                {k: np.asarray(v) for k, v in ref_index.arrays.items()},
                                device="cpu")


@pytest.mark.parametrize("kind,params", (("BTREE", {"fanout": 8}), ("PGM", {"eps": 32}),
                                         ("RS", {"eps": 16, "r_bits": 8}), ("SY-RMI", {})))
def test_refresh_shard_swaps_rebuilt_shard(kind, params):
    """The reference's ``test_refresh_shard_swaps_rebuilt_shard``: shard 2
    rebuilt with its last 3 keys retired; leaves, counts, offsets and
    ranks equal the reference's refreshed tier (in place here).  Where the
    reference refuses the rebuilt shard (PGM here: the rebuilt shard needs
    2 levels, the tier has 1), the port refuses it with the same message
    and leaves the tier as it was."""
    rng = np.random.default_rng(42)
    table = make_table(rng, "uniform", 2048)
    qs = make_queries(rng, table, 256)
    ref, port = _tier_pair(kind, table, 4, **params)
    m = int(ref.tables.shape[1])
    counts = np.asarray(ref.counts)
    new_keys = np.asarray(ref.tables[2])[:counts[2]][:-3]
    spec = rreg.spec_for(kind, **params)
    new_idx = rreg.entry(kind).build(spec, rsi._pad_sorted_table(new_keys, m))
    port_idx = tix.build(kind, rsi._pad_sorted_table(new_keys, m), device="cpu", **params)
    try:
        ref2 = rsi.refresh_shard(ref, 2, new_idx, new_keys)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tsi.refresh_shard(port, 2, port_idx, new_keys)
        _assert_tier_equal(ref, port)
        return
    assert tsi.refresh_shard(port, 2, port_idx, new_keys) is port
    _assert_tier_equal(ref2, port)
    want = np.asarray(rsi.sharded_lookup(ref2, qs))
    for backend in tsi.TIER_BACKENDS:
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=backend).numpy(), want)


def test_refresh_shard_refusals_leave_the_tier_intact():
    """The reference's three refusals (kind, previous shard's range, next
    fence) and its capacity and empty-shard checks raise the same errors
    here, and a refused install changes nothing."""
    rng = np.random.default_rng(43)
    table = make_table(rng, "uniform", 2048)
    ref, port = _tier_pair("BTREE", table, 4, fanout=8)
    before = {k: v.clone() for k, v in port.index.arrays.items()}
    vectors = [t.clone() for t in (port.tables, port.fences, port.counts, port.offsets, port.lasts)]
    m = int(ref.tables.shape[1])
    spec = rreg.spec_for("BTREE", fanout=8)
    other = rix.build("PGM", table, eps=32)
    bad_low = table[:int(ref.counts[0]) + 4]
    hi_start = int(ref.offsets[1]) + 4
    bad_hi = table[hi_start:hi_start + int(ref.counts[1])]
    cases = (("kind mismatch", other, table[:10]),
             ("previous", rreg.entry("BTREE").build(spec, rsi._pad_sorted_table(bad_low[:m], m)),
              bad_low[:m]),
             ("next", rreg.entry("BTREE").build(spec, rsi._pad_sorted_table(bad_hi, m)), bad_hi),
             ("capacity", rreg.entry("BTREE").build(spec, rsi._pad_sorted_table(bad_hi, m)),
              table[:m + 1]),
             ("empty", rreg.entry("BTREE").build(spec, rsi._pad_sorted_table(bad_hi, m)),
              table[:0]))
    for match, idx, new_table in cases:
        with pytest.raises(ValueError, match=match):
            rsi.refresh_shard(ref, 1, idx, new_table)
        with pytest.raises(ValueError, match=match):
            tsi.refresh_shard(port, 1, _port_index(idx), new_table)
        for k, v in port.index.arrays.items():
            assert torch.equal(v, before[k]), (match, k)
        for a, b in zip(vectors, (port.tables, port.fences, port.counts, port.offsets, port.lasts)):
            assert torch.equal(a, b), match


def test_weighted_quantile_bounds_matches_reference():
    """The reference's degenerate-skew cases and a spread of weights,
    zeros and keys outside the fences: equal bounds."""
    rng = np.random.default_rng(51)
    table = make_table(rng, "uniform", 4096)
    fences = np.asarray(rsi.ShardedIndex.build("RMI", table, 4, b=64).fences)
    below = np.sort(np.concatenate([table, np.array([0, 1], np.uint64)]))
    for merged, fen, w in ((table, fences, [1.0, 0.0, 0.0, 0.0]), (table, fences, [0.0] * 4),
                           (table[:4], table[:4], [9.0, 0.0, 0.0, 0.0]),
                           (table, fences, [2.0, 1.0, 1.0, 1.0]), (table, fences, [3, 1, 2, 1]),
                           (below, fences, [0.0, 0.0, 5.0, 1.0]),
                           (table, table[::512], rng.random(8))):
        np.testing.assert_array_equal(tsi.weighted_quantile_bounds(merged, fen, w),
                                      rsi.weighted_quantile_bounds(merged, fen, w))
    for bad in (([1.0] * 3, table), ([1.0] * 4, table[:3])):
        with pytest.raises(ValueError):
            rsi.weighted_quantile_bounds(bad[1], fences, bad[0])
        with pytest.raises(ValueError):
            tsi.weighted_quantile_bounds(bad[1], fences, bad[0])


@pytest.mark.parametrize("weights", ([2.0, 1.0, 1.0, 1.0], [3.0, 1.0, 2.0, 1.0]))
def test_rebalance_shards_matches_reference(weights):
    """The reference's donated re-shard cases (8,704 keys in m = 4,096):
    the rebalanced tier's leaves, fences, counts and offsets equal the
    reference's, and the ranks, fence keys +- 1 included, equal it and
    numpy with no drop."""
    rng = np.random.default_rng(57)
    table = make_table(rng, "uniform", 8704)
    ref, port = _tier_pair("RMI", table, 4, b=64)
    bounds = rsi.weighted_quantile_bounds(table, np.asarray(ref.fences), weights)
    assert not np.array_equal(np.diff(bounds), np.asarray(ref.counts))
    spec = rreg.spec_for("RMI", b=64)
    ref2 = rsi.rebalance_shards(ref, table, bounds, lambda part: rreg.entry("RMI").build(spec, part))
    tspec = tix.registry.spec_for("RMI", b=64)
    port2 = tsi.rebalance_shards(port, table, bounds,
                                 lambda part: tix.build(tspec, part, device="cpu"))
    assert port2 is port
    _assert_tier_equal(ref2, port)
    np.testing.assert_array_equal(port.counts.numpy(), np.diff(bounds))
    fence_keys = table[bounds[1:-1]]
    qs = np.concatenate([make_queries(rng, table, 300), fence_keys, fence_keys - np.uint64(1),
                         fence_keys + np.uint64(1), table[:1]])
    want = np.asarray(rsi.sharded_lookup(ref2, qs, mode="ref"))
    np.testing.assert_array_equal(want, true_ranks(table, qs))
    for backend in tsi.TIER_BACKENDS:
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=backend).numpy(), want)
    with pytest.raises(ValueError, match="bounds must"):
        tsi.rebalance_shards(port, table, bounds[:-1], None)
    with pytest.raises(ValueError, match="restack|capacity|padded capacity"):
        tsi.rebalance_shards(port, table, [0, 1, 2, 3, len(table)],
                             lambda part: tix.build(tspec, part, device="cpu"))
    _assert_tier_equal(ref2, port)  # a partition that cannot be installed changes nothing


def test_shard_build_table_pads_like_the_tier():
    table = make_table(np.random.default_rng(58), "uniform", 3000)
    for kind in ("RMI", "PGM", "KO"):
        np.testing.assert_array_equal(tsi.shard_build_table(kind, table[:700], 1024),
                                      rsi.shard_build_table(kind, table[:700], 1024))
    with pytest.raises(ValueError, match="padded capacity"):
        tsi.shard_build_table("RMI", table[:1025], 1024)


def test_one_rank_context_and_local_tier_errors(tmp_path):
    """In a one-rank gloo group: ``single_device_ctx`` resolves every axis
    to one shard, a rule naming a missing mesh dim raises, ``auto`` stays
    the one-process sweep, and a tier that holds one shard refuses the
    sweep and ``save``; ``psum_if_mapped`` is the identity without dims."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        ctx = tsh.single_device_ctx(device="cpu")
        assert ctx.mesh_axes("tp") == ("model",) and ctx.mesh_axes("dp") == ("data",)
        assert all(ctx.n(lg) == 1 for lg in LOGICAL) and ctx.index("tp") == 0
        flat = tsh.ShardingCtx(mesh=ctx.mesh, profile="flat_dp")
        assert flat.mesh_axes("dp") == ("data", "model") and flat.mesh_axes("tp") == ()
        assert flat.group("tp") is None and flat.index("tp") == 0
        s = tsh.ShardingCtx(mesh=ctx.mesh, rules={"tp": "model"})
        assert s.mesh_axes("tp") == ("model",)
        with pytest.raises(ValueError, match="ghost"):
            tsh.ShardingCtx(mesh=ctx.mesh, rules={"tp": ("ghost",)}).n("tp")
        with pytest.raises(ValueError, match="unknown sharding profile"):
            tsh.ShardingCtx(mesh=ctx.mesh, profile="bogus")
        x = torch.arange(5.0)
        tree = {"a": x, "b": [x]}
        assert tcol.psum_if_mapped(x, (), ctx) is x and tcol.psum_tree(tree, None) is tree
        summed = tcol.psum_tree(tree, ("model",), ctx)
        np.testing.assert_array_equal(summed["b"][0].numpy(), x.numpy())
        np.testing.assert_array_equal(tcol.psum_if_mapped(x, ("data",), ctx).numpy(), x.numpy())
        np.testing.assert_array_equal(tcol.pmean_if_mapped(x, ("model",), ctx).numpy(), x.numpy())
        table = make_table(np.random.default_rng(59), "uniform", 2000)
        sidx = tsi.ShardedIndex.build("PGM", table, 2, device="cpu")
        sidx.save(tmp_path / "t.npz")
        qs = make_queries(np.random.default_rng(59), table, 100)
        np.testing.assert_array_equal(tsi.sharded_lookup(sidx, qs, ctx).numpy(), true_ranks(table, qs))
        one = tsi.ShardedIndex.load(tmp_path / "t.npz", device="cpu", shard=1)
        assert one.held == range(1, 2) and one.n_shards == 2 and one.tables.shape[0] == 1
        with pytest.raises(ValueError, match="needs every shard held"):
            tsi.sharded_lookup(one, qs, mode="ref")
        with pytest.raises(ValueError, match="needs every shard held"):
            one.save(tmp_path / "u.npz")
        with pytest.raises(ValueError, match="not held"):
            one.shard(0)
    finally:
        dist.destroy_process_group()
