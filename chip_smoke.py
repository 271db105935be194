#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two query paths — one index over one table
(``Index.lookup(table, queries, backend="kernel")``) and one spec over a
tier of tables (``tune.build_many(...)`` then
``BatchedIndexes.lookup(queries, backend="kernel")``, one batched launch
for every table) — and holds every CUDA kernel on them against its plain
PyTorch twin and against ``torch.searchsorted``, bit for bit (predecessor
ranks are integers: the tolerance is zero).

Phases (any failure ends the run with a non-zero exit):

1. device    — name, count, ``nvidia-smi`` name and power limit;
2. build     — ``nvcc`` builds ``libkernels.so`` from ``src/repro_torch/csrc``
               (one process per source, in parallel) and prints each
               kernel's ``-Xptxas -v`` registers, shared memory and spills;
3. parity    — the five test table shapes and the pinned clustered table
               at n = 65,536 with the edge query mix, all 10 kinds:
               kernel == twin on the card == ``"ref"``; then the batched
               path for every kind on two same-length batches of 3 of
               those tables and on a ragged batch (65,536 / 30,000 /
               50,000 keys): batched kernel == batched twin == ``"ref"``
               == per-row numpy ``searchsorted``;
4. full size — ``amzn64`` and ``osm`` at the L4 tier (2^24 keys, larger
               than the 50 MB L2) with 2^22 queries sampled from the table;
               all 10 kinds built with the registry defaults; launch counts
               of the single-table path, bit-exactness, kernel / twin /
               ``torch.searchsorted`` times (CUDA events) and the bound;
5. tier      — the same two tables, each split into 4 contiguous shards of
               2^22 keys (the tier layout), 2^20 queries sampled from each
               shard: all 10 kinds through ``build_many`` and one batched
               lookup each; launch counts of the batched path (one per
               tier and kind), bit-exactness against the batched twin and
               batched ``torch.searchsorted``, ``unstack()`` against
               per-shard builds, times and bounds; and a locality probe:
               the single-table model-free kernel over the whole table
               with the tier's queries in shard order and shuffled.

The last two stdout lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.  Run with no arguments on a machine
with one CUDA card.  ``--cpu-rehearsal`` runs phases 3 to 5 on the CPU
twins at a tiny size (no device result is printed).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the non-tensor
#: f32 rate, used as the rate of the kernels' scalar integer/float work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SECTOR_BYTES = 32

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE")
KERNELS = {
    "kary_search": {
        "source": "src/repro_torch/csrc/kary_search.cu",
        "replaces": "src/repro/kernels/kary_search.py:105",
        "kinds": ("L", "Q", "C", "KO", "BTREE"),
        "headline": "KO",
    },
    "rmi_search": {
        "source": "src/repro_torch/csrc/rmi_search.cu",
        "replaces": "src/repro/kernels/rmi_search.py:130",
        "kinds": ("RMI", "SY-RMI"),
        "headline": "SY-RMI",
    },
    "pgm_search": {
        "source": "src/repro_torch/csrc/pgm_search.cu",
        "replaces": "src/repro/kernels/pgm_search.py:175",
        "kinds": ("PGM", "PGM_M"),
        "headline": "PGM_M",
    },
    "rs_search": {
        "source": "src/repro_torch/csrc/rs_search.cu",
        "replaces": "src/repro/kernels/rs_search.py:135",
        "kinds": ("RS",),
        "headline": "RS",
    },
    "batched_kary_search": {
        "source": "src/repro_torch/csrc/kary_search.cu",
        "replaces": "src/repro/kernels/kary_search.py:140",
        "kinds": ("L", "Q", "C", "KO", "BTREE"),
        "headline": "KO",
    },
    "batched_rmi_search": {
        "source": "src/repro_torch/csrc/rmi_search.cu",
        "replaces": "src/repro/kernels/rmi_search.py:233",
        "kinds": ("RMI", "SY-RMI"),
        "headline": "SY-RMI",
    },
    "batched_pgm_search": {
        "source": "src/repro_torch/csrc/pgm_search.cu",
        "replaces": "src/repro/kernels/pgm_search.py:303",
        "kinds": ("PGM", "PGM_M"),
        "headline": "PGM_M",
    },
    "batched_rs_search": {
        "source": "src/repro_torch/csrc/rs_search.cu",
        "replaces": "src/repro/kernels/rs_search.py:263",
        "kinds": ("RS",),
        "headline": "RS",
    },
}
SINGLE = tuple(k for k in KERNELS if not k.startswith("batched_"))
BATCHED = tuple(k for k in KERNELS if k.startswith("batched_"))
KERNEL_OF = {k: name for name in SINGLE for k in KERNELS[name]["kinds"]}
BATCHED_KERNEL_OF = {k: name for name in BATCHED for k in KERNELS[name]["kinds"]}


def fail(msg: str):
    raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs ------------------------------------------------------------------


def as_table(keys) -> np.ndarray:
    return np.unique(np.asarray(keys, dtype=np.uint64))


def make_table(rng, kind: str, n: int) -> np.ndarray:
    """The table shapes of ``tests/conftest.py:make_table``."""
    if kind == "uniform":
        return as_table(rng.integers(0, 2**63, size=n, dtype=np.uint64))
    if kind == "lognormal":
        return as_table(np.exp(rng.normal(20, 2, size=n)).astype(np.uint64))
    if kind == "clustered":
        c = rng.integers(0, 2**60, size=max(4, n // 500), dtype=np.uint64)
        return as_table(c[rng.integers(0, len(c), n)] + rng.integers(0, 2**30, n).astype(np.uint64))
    if kind == "bursty":
        g = rng.exponential(100, size=n) * (1 + 50 * (rng.random(n) < 0.01))
        return as_table(np.cumsum(g).astype(np.uint64) + 10**15)
    if kind == "sequential":
        return as_table(np.arange(n, dtype=np.uint64) * 7 + 3)
    raise ValueError(kind)


def clamp_table():
    """The pinned clustered table of ``test_pallas_window_center_clamp_regression``."""
    rng = np.random.default_rng(42)
    centers = rng.integers(0, 2**63, size=8, dtype=np.uint64)
    parts = [c + rng.integers(0, 2**20, size=256, dtype=np.uint64) for c in centers]
    return np.unique(np.concatenate(parts))


def edge_queries(rng, table, n_keys=4096, n_random=4096):
    """Keys, keys ± 1, random u64, 0, min − 1, max + 1, 2^64 − 1."""
    keys = rng.choice(table, n_keys).astype(np.uint64)
    with np.errstate(over="ignore"):
        extremes = np.array(
            [0, table.min() - np.uint64(1), table.min(), table.max(),
             table.max() + np.uint64(1), 2**64 - 1],
            dtype=np.uint64,
        )
    return np.concatenate([
        keys, keys - np.uint64(1), keys + np.uint64(1),
        rng.integers(0, 2**64 - 1, n_random, dtype=np.uint64), extremes,
    ])


# -- measurement -------------------------------------------------------------


def device_ms(fn, dev, reps: int = 20, warmup: int = 3):
    """Mean ms per call over ``reps`` calls, timed with CUDA events after
    ``warmup`` calls; None off the card (a CPU time is no device metric)."""
    if dev.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(args, table, probes, nq: int) -> dict:
    """Least time the card could take for one kernel call: the larger of
    (bytes it must move) / HBM rate and (scalar operations) / f32 rate.
    Bytes: every non-table operand read once (queries, ``u``, leaves),
    ranks written once (int32), and each distinct 32-byte table sector
    that this run's searches touch (from the twin's probe indices)."""
    operand_bytes = sum(int(a.nbytes) for a in args
                        if torch.is_tensor(a) and a.data_ptr() != table.data_ptr())
    keys_per_sector = SECTOR_BYTES // table.element_size()
    touched = torch.zeros((table.numel() + keys_per_sector - 1) // keys_per_sector, dtype=torch.bool,
                          device=table.device)
    for p in probes:
        touched[(p // keys_per_sector).long()] = True
    sectors = int(touched.sum())
    total_bytes = operand_bytes + nq * 4 + sectors * SECTOR_BYTES
    # per probe: gather, compare, two selects, shift, subtract (~6 ops)
    n_probes = sum(int(p.numel()) for p in probes)
    ops = 6 * n_probes
    t_bytes, t_ops = total_bytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": total_bytes,
        "table_sectors": sectors,
        "probes_per_query": n_probes / max(nq, 1),
    }


# -- phases --------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py needs one GPU")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"[device] {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    return {"name": name, "count": count, "nvidia_smi": smi.stdout.strip()}


def phase_build() -> None:
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    log(f"[build] libkernels.so from {len(cuda_lib.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s ({' '.join(cuda_lib.NVCC_FLAGS)})")
    for src, lines in cuda_lib.ptxas_report().items():
        for ln in lines:
            log(f"[build] {src}: {ln}")


def check_equal(what: str, got: np.ndarray, others) -> None:
    """Fail unless ``got`` equals every ``(name, ranks)`` of ``others``."""
    for other, ranks in others:
        if not np.array_equal(got, ranks):
            bad = np.argwhere(got != ranks)[0]
            fail(f"parity: {what} kernel != {other} at {tuple(bad)}: "
                 f"{got[tuple(bad)]} vs {ranks[tuple(bad)]}")


def batched_answer(bm, queries):
    """Batched twin ranks, the operands and the queries of one batched
    lookup, clamped to the counts as ``BatchedIndexes.lookup`` clamps."""
    from repro_torch import index as tix

    impl = tix.impls.query_impl(bm.kind)
    q = bm.queries_for(queries)
    args, kwargs = impl.batched_operands(bm.index, bm.tables, q)
    return impl, q, args, kwargs


def phase_parity(dev, n: int) -> None:
    from repro_torch import index as tix
    from repro_torch import tune
    from repro_torch.core import keys

    rng = np.random.default_rng(2024)
    cases = [(k, make_table(rng, k, n)) for k in
             ("uniform", "lognormal", "clustered", "bursty", "sequential")]
    cases.append(("pinned-clamp", clamp_table()))
    for name, table in cases:
        qs_np = edge_queries(rng, table, n_keys=min(4096, len(table)))
        want = np.searchsorted(table, qs_np, side="right").astype(np.int64) - 1
        t, q = keys.encode(table, dev), keys.encode(qs_np, dev)
        for kind in KINDS:
            idx = tix.build(kind, table, device=dev)
            got = idx.lookup(t, q, backend="kernel")
            ref = idx.lookup(t, q, backend="ref")
            impl = tix.impls.query_impl(kind)
            args, kwargs = impl.operands(idx, t, q)
            twin = impl.plain(*args, **kwargs).long()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            check_equal(f"{name}/{kind}", got.cpu().numpy(),
                        (("twin", twin.cpu().numpy()), ("ref", ref.cpu().numpy()),
                         ("numpy", want)))
        log(f"[parity] {name} n={len(table)} nq={len(qs_np)}: all {len(KINDS)} kinds "
            f"kernel == twin == ref")

    # -- the batched path: two same-length batches of the six tables, one ragged --
    tables = [t for _, t in cases]
    same = [min(len(t) for t in tables[:3]), min(len(t) for t in tables[3:])]
    batches = [
        ("same-length " + "/".join(nm for nm, _ in cases[:3]), [t[: same[0]] for t in tables[:3]]),
        ("same-length " + "/".join(nm for nm, _ in cases[3:]), [t[: same[1]] for t in tables[3:]]),
        ("ragged", [make_table(rng, k, m) for k, m in
                    (("uniform", n), ("clustered", n * 30000 // 65536),
                     ("bursty", n * 50000 // 65536))]),
    ]
    for label, batch in batches:
        qs_np = edge_queries(rng, np.concatenate(batch), n_keys=4096)
        want = np.stack([np.searchsorted(t, qs_np, side="right").astype(np.int64) - 1
                         for t in batch])
        for kind in KINDS:
            bm = tune.build_many(kind, batch, device=dev)
            got = bm.lookup(qs_np, backend="kernel")
            ref = bm.lookup(qs_np, backend="ref")
            impl, _, args, kwargs = batched_answer(bm, qs_np)
            twin = torch.minimum(impl.batched_plain(*args, **kwargs).long(), bm.counts[:, None] - 1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            check_equal(f"batched {label}/{kind}", got.cpu().numpy(),
                        (("batched twin", twin.cpu().numpy()), ("ref", ref.cpu().numpy()),
                         ("numpy", want)))
        log(f"[parity] batched {label} ({'/'.join(str(len(t)) for t in batch)} keys, "
            f"nq={len(qs_np)}): all {len(KINDS)} kinds batched kernel == batched twin == ref")


def measure(dev, impl_search, impl_plain, args, kwargs, table, nq, lookup, library) -> dict:
    """Kernel / lookup / twin / library times (CUDA events) and the bound
    of one kernel call on ``args``."""
    probes = []
    impl_plain(*args, **kwargs, probes=probes)
    row = {
        "ms": device_ms(lambda: impl_search(*args, **kwargs), dev),
        "lookup_ms": device_ms(lookup, dev),
        "plain_ms": device_ms(lambda: impl_plain(*args, **kwargs), dev, reps=5, warmup=1),
        "library_ms": device_ms(library, dev),
    }
    row.update(bound(args, table, probes, nq))
    if row["ms"] is not None:
        row["mlookups_per_s"] = nq / (row["ms"] * 1e-3) / 1e6
    return row


def log_row(prefix: str, row: dict) -> None:
    ms = ("not measured" if row["ms"] is None
          else f"{row['ms']:.4f} ms ({row['mlookups_per_s']:.1f} Mlookups/s)")
    log(f"{prefix}: build {row['build_s']:.1f} s, space {row['space_bytes']} B "
        f"({row['space_pct_of_table']:.4f}% of table), exact vs searchsorted, twin equal, "
        f"kernel {ms}, lookup {row['lookup_ms']}, plain {row['plain_ms']}, "
        f"searchsorted {row['library_ms']}, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {row['table_sectors']} table sectors, "
        f"{row['probes_per_query']:g} probes/query)")


def check_launches(launches: dict, kernels_of: dict, n_tables: int, path: str) -> None:
    """Each kind of the path launched its kernel once a table, and no
    other kernel launched."""
    for name in KERNELS:
        want = n_tables * sum(1 for k in KINDS if kernels_of.get(k) == name)
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times on the {path} path, expected {want}")


def phase_full(dev, n: int, nq: int, datasets) -> tuple:
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch.core import keys
    from repro_torch.data import generate, make_queries

    tables = {}
    for ds in datasets:
        t0 = time.perf_counter()
        table = generate(ds, n)
        qs = make_queries(table, nq, seed=1)
        tables[ds] = (table, qs)
        log(f"[full] {ds}: {len(table)} keys ({table.nbytes / 2**20:.0f} MiB), {nq} queries, "
            f"generated in {time.perf_counter() - t0:.1f} s")

    # -- the single-table path: build every kind, answer the queries (counted) --
    kernels.reset_launches()
    built, answers = {}, {}
    for ds, (table, qs) in tables.items():
        t_dev, q_dev = keys.encode(table, dev), keys.encode(qs, dev)
        # RS first: its greedy spline restarts a chunk at every knot, so its
        # host build time is the one to watch
        for kind in ("RS",) + tuple(k for k in KINDS if k != "RS"):
            t0 = time.perf_counter()
            idx = tix.build(kind, table, device=dev)
            build_s = time.perf_counter() - t0
            if kind == "RS":
                log(f"[full] {ds}/RS host build {build_s:.1f} s ({idx.info['m']} knots)")
            built[(ds, kind)] = (idx, t_dev, q_dev, build_s)
            answers[(ds, kind)] = idx.lookup(t_dev, q_dev, backend="kernel")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[full] single-table path launches: {json.dumps(launches)}")
    if dev.type == "cuda":
        check_launches(launches, KERNEL_OF, len(tables), "single-table")

    # -- check and measure each (table, kind) --
    rows = []
    for (ds, kind), (idx, t_dev, q_dev, build_s) in built.items():
        impl = tix.impls.query_impl(kind)
        got = answers[(ds, kind)]
        args, kwargs = impl.operands(idx, t_dev, q_dev)
        twin = impl.plain(*args, **kwargs).long()
        ref = torch.searchsorted(t_dev, q_dev, right=True) - 1
        err = int((got - twin).abs().max())
        exact = bool(torch.equal(got, ref))
        if err != 0 or not exact:
            fail(f"full: {ds}/{kind} kernel vs twin max |err| {err}, equal to ref: {exact}")
        row = {
            "table": ds, "kind": kind, "kernel": KERNEL_OF[kind], "n": len(tables[ds][0]), "nq": nq,
            "build_s": build_s, "space_bytes": idx.space_bytes(),
            "space_pct_of_table": 100.0 * idx.space_bytes() / (8 * len(tables[ds][0])),
            "nbytes": idx.nbytes(), "statics": dict(idx.static),
            "bit_exact_vs_ref": exact, "twin_equal": err == 0, "max_abs_err": err,
        }
        row.update(measure(
            dev, impl.search, impl.plain, args, kwargs, t_dev, nq,
            lambda: idx.lookup(t_dev, q_dev, backend="kernel"),
            lambda: torch.searchsorted(t_dev, q_dev, right=True),
        ))
        rows.append(row)
        log_row(f"[full] {ds}/{kind}", row)
    return rows, launches, tables


def phase_tier(dev, tables: dict, n_shards: int, nq_shard: int) -> tuple:
    """The batched path on a tier: each table split into ``n_shards``
    contiguous shards, ``nq_shard`` queries sampled from each shard."""
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch import tune
    from repro_torch.core import keys
    from repro_torch.data import make_queries

    tiers = {}
    for ds, (table, _) in tables.items():
        shards = np.split(table, n_shards)
        qs = np.stack([make_queries(s, nq_shard, seed=1) for s in shards])
        tiers[ds] = (shards, keys.encode(qs, dev))
        log(f"[tier] {ds}: {n_shards} shards of {len(shards[0])} keys, {nq_shard} queries a shard")

    # -- the batched path: build every kind over the tier, one lookup each (counted) --
    kernels.reset_launches()
    built, answers = {}, {}
    for ds, (shards, q_dev) in tiers.items():
        for kind in KINDS:
            t0 = time.perf_counter()
            bm = tune.build_many(kind, shards, device=dev)
            built[(ds, kind)] = (bm, time.perf_counter() - t0)
            answers[(ds, kind)] = bm.lookup(q_dev, backend="kernel")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[tier] batched path launches: {json.dumps(launches)}")
    if dev.type == "cuda":
        check_launches(launches, BATCHED_KERNEL_OF, len(tiers), "batched")

    rows = []
    for (ds, kind), (bm, build_s) in built.items():
        shards, q_dev = tiers[ds]
        got = answers[(ds, kind)]
        impl, q, args, kwargs = batched_answer(bm, q_dev)
        twin = torch.minimum(impl.batched_plain(*args, **kwargs).long(), bm.counts[:, None] - 1)
        ref = torch.searchsorted(bm.tables, q, right=True) - 1
        err = int((got - twin).abs().max())
        exact = bool(torch.equal(got, ref))
        if err != 0 or not exact:
            fail(f"tier: {ds}/{kind} batched kernel vs twin max |err| {err}, equal to ref: {exact}")
        t0 = time.perf_counter()
        for i, part in enumerate(bm.unstack()):
            fresh = tix.build(kind, shards[i], device=dev)
            want, have = fresh.to_numpy(), part.to_numpy()
            same = part.static == fresh.static and set(want) == set(have) and all(
                want[k].dtype == have[k].dtype and want[k].tobytes() == have[k].tobytes()
                for k in want)
            if not same:
                fail(f"tier: {ds}/{kind} unstack()[{i}] differs from the per-shard build")
        unstack_s = time.perf_counter() - t0
        n_keys = sum(len(s) for s in shards)
        row = {
            "table": ds, "kind": kind, "kernel": BATCHED_KERNEL_OF[kind], "n_shards": len(shards),
            "n": n_keys, "nq": int(q.numel()), "build_s": build_s,
            "space_bytes": bm.space_bytes(), "space_pct_of_table": 100.0 * bm.space_bytes() / (8 * n_keys),
            "nbytes": bm.index.nbytes(), "statics": dict(bm.index.static),
            "bit_exact_vs_ref": exact, "twin_equal": err == 0, "max_abs_err": err,
            "unstack_equal": True, "unstack_check_s": unstack_s,
        }
        row.update(measure(
            dev, impl.batched_search, impl.batched_plain, args, kwargs, bm.tables, int(q.numel()),
            lambda: bm.lookup(q_dev, backend="kernel"),
            lambda: torch.searchsorted(bm.tables, q, right=True),
        ))
        rows.append(row)
        log_row(f"[tier] {ds}/{kind}", row)
        log(f"[tier] {ds}/{kind}: unstack() == per-shard build for all {len(shards)} shards "
            f"(checked in {unstack_s:.1f} s)")
    return rows, launches, locality_probe(dev, tables, tiers)


def locality_probe(dev, tables: dict, tiers: dict) -> dict:
    """Whether the tier's speed comes from query order: the single-table
    model-free kernel over the whole table, with the tier's queries in
    shard order (each block's queries in one shard) and shuffled."""
    from repro_torch.core import keys
    from repro_torch.kernels.kary_search import kary_search

    out = {}
    for ds, (table, _) in tables.items():
        t_dev = keys.encode(table, dev)
        ordered = tiers[ds][1].reshape(-1)
        gen = torch.Generator(device=dev).manual_seed(0)
        shuffled = ordered[torch.randperm(ordered.numel(), device=dev, generator=gen)]
        want = torch.searchsorted(t_dev, ordered, right=True) - 1
        if not torch.equal(kary_search(t_dev, ordered).long(), want):
            fail(f"locality probe: {ds} kary_search != searchsorted")
        out[ds] = {
            "shard_ordered_ms": device_ms(lambda: kary_search(t_dev, ordered), dev),
            "shuffled_ms": device_ms(lambda: kary_search(t_dev, shuffled), dev),
            "searchsorted_shard_ordered_ms": device_ms(
                lambda: torch.searchsorted(t_dev, ordered, right=True), dev),
            "searchsorted_shuffled_ms": device_ms(
                lambda: torch.searchsorted(t_dev, shuffled, right=True), dev),
        }
        log(f"[tier] {ds} locality probe, kary_search over all {len(table)} keys: "
            f"{json.dumps(out[ds])}")
    return out


def kernels_line(rows, launches, headline_table: str) -> dict:
    out = []
    for name, spec in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["table"] == headline_table and r["kind"] == spec["headline"])
        out.append({
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "twin_equal": all(r["twin_equal"] for r in mine),
            "headline_case": f"{headline_table}/{spec['headline']}",
            "cases": [{k: r[k] for k in ("table", "kind", "ms", "plain_ms", "bound_ms",
                                         "library_ms", "lookup_ms", "max_abs_err")} for r in mine],
        })
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 3-5 on the CPU twins at a tiny size (no device result)")
    ap.add_argument("--out", type=Path, default=None, help="also write every row as JSON here")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    if args.cpu_rehearsal:
        dev, info = torch.device("cpu"), None
        sys.path.insert(0, str(ROOT / "src"))
        parity_n, full_n, full_nq, shard_nq = 4096, 1 << 14, 1 << 12, 1 << 10
    else:
        info = phase_device()
        dev = torch.device("cuda")
        sys.path.insert(0, str(ROOT / "src"))
        phase_build()
        from repro_torch.data import TIERS

        parity_n, full_n, full_nq, shard_nq = 65536, TIERS["L4"], 1 << 22, 1 << 20

    t0 = time.perf_counter()
    phase_parity(dev, parity_n)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows, launches, tables = phase_full(dev, full_n, full_nq, ("amzn64", "osm"))
    log(f"[full] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tier_rows, tier_launches, locality = phase_tier(dev, tables, 4, shard_nq)
    log(f"[tier] done in {time.perf_counter() - t0:.1f} s")
    launches = {**{k: launches[k] for k in SINGLE}, **{k: tier_launches[k] for k in BATCHED}}
    line = kernels_line(rows + tier_rows, launches, "amzn64")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": info, "rows": rows, "tier_rows": tier_rows,
                                        "locality": locality, **line}, indent=1))
    if dev.type != "cuda":
        log("[rehearsal] CPU rehearsal passed; no device result")
        return 0
    if any(launches[name] == 0 for name in KERNELS):
        fail(f"a kernel of a path never launched: {launches}")
    log(f"[device] nvidia-smi: {info['nvidia_smi']}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
