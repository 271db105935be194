#!/usr/bin/env python3
"""Time the model-free search kernel (``kary_search`` and its batched
form) of one or more checkouts on one CUDA card, one process each.

Shapes: one 2^24-key table with 2^22 queries (phase 4 of
``chip_smoke.py``); a tier of 4 shards of 2^22 keys with 2^20 queries a
shard (phase 5); and small batches, 1 to 4,096 queries a shard over 4 to
64 shards of 2^22 keys, where the batched kernel's grid, not the table,
sets the time.  Every rank is held against ``torch.searchsorted``.

A checkout (``--root``) is any directory holding ``src/repro_torch``, for
instance a parent commit unpacked with ``git archive``; the same one may
be given twice to see the spread.  ``--variant T,W`` adds a copy of this
checkout whose kernel stages T tree levels and sweeps W keys (T <= 12,
1 <= W <= 32).  A search's probe positions depend only on each query's
rank, not on the key values, so the tables are sorted random int64 keys
made on the card (seed 0) and the queries are keys of the table.

    python3 kary_bench.py --root _archive/parent --root . --variant 12,16 \\
        --out chiprun_out/kary_bench.json

Times are means of CUDA-event-timed calls (``ms``, the host's enqueue
included) and, for the small batches, of calls replayed from a CUDA graph
(``graph_ms``, the device alone).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import device_ms, fail, graph_ms, log, phase_device

ROOT = Path(__file__).resolve().parent
SINGLE = (1 << 24, 1 << 22)  # keys, queries
TIER = (4, 1 << 22, 1 << 20)  # shards, keys a shard, queries a shard
SMALL_TABLES = (4, 16, 64)
SMALL_QUERIES = (1, 64, 512, 4096)


def variant_root(tree_levels: int, sweep: int) -> Path:
    """A copy of this checkout's port whose kernel and twin take other
    T and W constants; it builds its own library beside it."""
    if not (0 <= tree_levels <= 12 and 1 <= sweep <= 32):
        fail(f"variant ({tree_levels}, {sweep}): T must be 0..12, W 1..32")
    root = ROOT / "build" / "kary_variants" / f"T{tree_levels}_W{sweep}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pats in (("csrc/kary_search.cu", (r"(constexpr int kTreeLevels = )\d+",
                                               r"(constexpr int kSweep = )\d+")),
                      ("kernels/kary_search.py", (r"(\nTREE_LEVELS = )\d+", r"(\nSWEEP = )\d+"))):
        path = root / "src" / "repro_torch" / rel
        text = path.read_text()
        for pat, value in zip(pats, (tree_levels, sweep)):
            text, count = re.subn(pat, rf"\g<1>{value}", text)
            if count != 1:
                fail(f"{rel}: {pat} matched {count} times")
        path.write_text(text)
    return root


def sorted_rows(gen, dev, rows: int, n: int) -> torch.Tensor:
    t = torch.empty((rows, n), dtype=torch.int64, device=dev).random_(generator=gen)
    t = t.sort(dim=1).values
    if not bool((t[:, 1:] > t[:, :-1]).all()):
        fail("a random table drew one key twice")
    return t


def check(got, table, queries, what: str) -> None:
    want = torch.searchsorted(table, queries, right=True) - 1
    if not torch.equal(got.long(), want):
        fail(f"{what}: kernel != torch.searchsorted")


def worker(root: Path, label: str) -> None:
    """Measure the checkout at ``root``; one ``[row]`` JSON line a shape."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.kary_search import batched_kary_search, kary_search

    if not Path(cuda_lib.__file__).resolve().is_relative_to(root.resolve()):
        fail(f"imported {cuda_lib.__file__}, not the checkout at {root}")
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def row(**kw):
        print("[row] " + json.dumps({"root": label, **kw}), flush=True)

    n, nq = SINGLE
    table = sorted_rows(gen, dev, 1, n)[0]
    q = table[torch.randint(0, n, (nq,), generator=gen, device=dev)]
    check(kary_search(table, q), table, q, f"{label} single")
    row(shape="single", n=n, nq=nq, ms=device_ms(lambda: kary_search(table, q), dev),
        searchsorted_ms=device_ms(lambda: torch.searchsorted(table, q, right=True), dev))
    del table, q

    shards, n, nq = TIER
    tables = sorted_rows(gen, dev, shards, n)
    q = torch.gather(tables, 1, torch.randint(0, n, (shards, nq), generator=gen, device=dev))
    check(batched_kary_search(tables, q), tables, q, f"{label} tier")
    row(shape="tier", n_tables=shards, n=n, nq=nq,
        ms=device_ms(lambda: batched_kary_search(tables, q), dev),
        searchsorted_ms=device_ms(lambda: torch.searchsorted(tables, q, right=True), dev))
    del tables, q

    every = sorted_rows(gen, dev, max(SMALL_TABLES), n)
    for nt in SMALL_TABLES:
        tables = every[:nt]
        for nq in SMALL_QUERIES:
            q = torch.gather(tables, 1, torch.randint(0, n, (nt, nq), generator=gen, device=dev))
            check(batched_kary_search(tables, q), tables, q, f"{label} {nt} x {nq}")
            row(shape="small", n_tables=nt, n=n, nq=nq,
                ms=device_ms(lambda: batched_kary_search(tables, q), dev, reps=50),
                graph_ms=graph_ms(lambda: batched_kary_search(tables, q), dev, reps=50))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, action="append", default=[],
                    help="a checkout holding src/repro_torch (repeatable; default: this one)")
    ap.add_argument("--variant", action="append", default=[],
                    help="T,W: this checkout with T staged tree levels and a W-key sweep")
    ap.add_argument("--out", type=Path, default=None, help="write every row as JSON here")
    ap.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.label)
        return 0

    info = phase_device()
    runs = [(str(r), r.resolve()) for r in args.root or [ROOT]]
    for v in args.variant:
        t, w = (int(x) for x in v.split(","))
        runs.append((f"this checkout, T={t} W={w}", variant_root(t, w)))
    rows = []
    for label, root in runs:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(root),
                              "--label", label], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            fail(f"{label}: exit {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        for ln in res.stdout.splitlines():
            if ln.startswith("[row] "):
                rows.append(json.loads(ln[6:]))
                log(ln)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": info, "rows": rows}, indent=1))
    log(f"[device] nvidia-smi: {info['nvidia_smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
