#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — build a learned index over a sorted uint64
table, answer a batch of predecessor queries with
``Index.lookup(table, queries, backend="kernel")`` — and holds every CUDA
kernel on that path against its plain PyTorch twin and against
``torch.searchsorted``, bit for bit (predecessor ranks are integers: the
tolerance is zero).

Phases (any failure ends the run with a non-zero exit):

1. device    — name, count, ``nvidia-smi`` name and power limit;
2. build     — ``nvcc`` builds ``libkernels.so`` from ``src/repro_torch/csrc``
               (one process per source, in parallel) and prints each
               kernel's ``-Xptxas -v`` registers, shared memory and spills;
3. parity    — the five test table shapes and the pinned clustered table
               at n = 65,536 with the edge query mix, all 8 kinds:
               kernel == twin on the card == ``"ref"``;
4. full size — ``amzn64`` and ``osm`` at the L4 tier (2^24 keys, larger
               than the 50 MB L2) with 2^22 queries sampled from the table;
               all 8 kinds built with the registry defaults; launch counts
               of the main path, bit-exactness, kernel / twin /
               ``torch.searchsorted`` times (CUDA events) and the bound.

The last two stdout lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.  Run with no arguments on a machine
with one CUDA card.  ``--cpu-rehearsal`` runs phases 3 and 4 on the CPU
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

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M")
KERNELS = {
    "kary_search": {
        "source": "src/repro_torch/csrc/kary_search.cu",
        "replaces": "src/repro/kernels/kary_search.py:105",
        "kinds": ("L", "Q", "C", "KO"),
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
}
KERNEL_OF = {k: name for name, spec in KERNELS.items() for k in spec["kinds"]}


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
    operand_bytes = sum(int(a.nbytes) for a in args if torch.is_tensor(a) and a is not table)
    keys_per_sector = SECTOR_BYTES // table.element_size()
    touched = torch.zeros((table.numel() + keys_per_sector - 1) // keys_per_sector, dtype=torch.bool,
                          device=table.device)
    for p in probes:
        touched[(p // keys_per_sector).long()] = True
    sectors = int(touched.sum())
    total_bytes = operand_bytes + nq * 4 + sectors * SECTOR_BYTES
    # per probe: gather, compare, two selects, shift, subtract (~6 ops)
    ops = 6 * len(probes) * nq
    t_bytes, t_ops = total_bytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": total_bytes,
        "table_sectors": sectors,
        "probes_per_query": len(probes),
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


def phase_parity(dev, n: int) -> None:
    from repro_torch import index as tix
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
            got_np = got.cpu().numpy()
            for other, ranks in (("twin", twin.cpu().numpy()), ("ref", ref.cpu().numpy()),
                                 ("numpy", want)):
                if not np.array_equal(got_np, ranks):
                    bad = int(np.flatnonzero(got_np != ranks)[0])
                    fail(f"parity: {name}/{kind} kernel != {other} at query {bad}: "
                         f"{got_np[bad]} vs {ranks[bad]}")
        log(f"[parity] {name} n={len(table)} nq={len(qs_np)}: all {len(KINDS)} kinds "
            f"kernel == twin == ref")


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

    # -- the main path: build every kind, answer the queries (counted) --
    kernels.reset_launches()
    built, answers = {}, {}
    for ds, (table, qs) in tables.items():
        t_dev, q_dev = keys.encode(table, dev), keys.encode(qs, dev)
        for kind in KINDS:
            t0 = time.perf_counter()
            idx = tix.build(kind, table, device=dev)
            build_s = time.perf_counter() - t0
            built[(ds, kind)] = (idx, t_dev, q_dev, build_s)
            answers[(ds, kind)] = idx.lookup(t_dev, q_dev, backend="kernel")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[full] main-path launches: {json.dumps(launches)}")
    if dev.type == "cuda":
        for name, spec in KERNELS.items():
            want = len(spec["kinds"]) * len(tables)
            if launches[name] != want:
                fail(f"{name} launched {launches[name]} times on the main path, expected {want}")

    # -- check and measure each (table, kind) --
    rows = []
    for (ds, kind), (idx, t_dev, q_dev, build_s) in built.items():
        impl = tix.impls.query_impl(kind)
        got = answers[(ds, kind)]
        args, kwargs = impl.operands(idx, t_dev, q_dev)
        probes = []
        twin = impl.plain(*args, **kwargs, probes=probes).long()
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
            "ms": device_ms(lambda: impl.search(*args, **kwargs), dev),
            "lookup_ms": device_ms(lambda: idx.lookup(t_dev, q_dev, backend="kernel"), dev),
            "plain_ms": device_ms(lambda: impl.plain(*args, **kwargs), dev, reps=5, warmup=1),
            "library_ms": device_ms(lambda: torch.searchsorted(t_dev, q_dev, right=True), dev),
        }
        row.update(bound(args, t_dev, probes, nq))
        if row["ms"] is not None:
            row["mlookups_per_s"] = nq / (row["ms"] * 1e-3) / 1e6
        rows.append(row)
        ms = ("not measured" if row["ms"] is None
              else f"{row['ms']:.4f} ms ({row['mlookups_per_s']:.1f} Mlookups/s)")
        log(f"[full] {ds}/{kind}: build {build_s:.1f} s, space {row['space_bytes']} B "
            f"({row['space_pct_of_table']:.4f}% of table), exact vs ref, twin equal, "
            f"kernel {ms}, lookup {row['lookup_ms']}, plain {row['plain_ms']}, "
            f"searchsorted {row['library_ms']}, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {row['table_sectors']} table sectors, "
            f"{row['probes_per_query']} probes/query)")
    return rows, launches


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
                    help="run phases 3-4 on the CPU twins at a tiny size (no device result)")
    ap.add_argument("--out", type=Path, default=None, help="also write every row as JSON here")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        dev, info = torch.device("cpu"), None
        sys.path.insert(0, str(ROOT / "src"))
        parity_n, full_n, full_nq = 4096, 1 << 14, 1 << 12
    else:
        info = phase_device()
        dev = torch.device("cuda")
        sys.path.insert(0, str(ROOT / "src"))
        phase_build()
        from repro_torch.data import TIERS

        parity_n, full_n, full_nq = 65536, TIERS["L4"], 1 << 22

    t0 = time.perf_counter()
    phase_parity(dev, parity_n)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows, launches = phase_full(dev, full_n, full_nq, ("amzn64", "osm"))
    log(f"[full] done in {time.perf_counter() - t0:.1f} s")
    line = kernels_line(rows, launches, "amzn64")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": info, "rows": rows, **line}, indent=1))
    if dev.type != "cuda":
        log("[rehearsal] CPU rehearsal passed; no device result")
        return 0
    if any(launches[name] == 0 for name in KERNELS):
        fail(f"a kernel of the main path never launched: {launches}")
    log(f"[device] nvidia-smi: {info['nvidia_smi']}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
