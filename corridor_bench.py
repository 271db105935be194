#!/usr/bin/env python3
"""Time the corridor-scan kernels (``csrc/corridor_scan.cu``) of one or
more checkouts on one CUDA card, one process each.

Shapes: phase 5e of ``chip_smoke.py``: tables of 2^24 keys
(``data.generate``, seed 0; amzn64 and osm unless ``--table`` names
others; made once, by this checkout, and saved under
``build/corridor_bench/``) as 4 shards of 2^22 f64 keys, at ε 64 unless
``--eps`` names others.  Forms:

- ``blocked``: the fast fit's blocks (``corridor_scan``, 256 keys a row,
  65,536 rows);
- ``exact``: the exact fit, ``corridor_scan_exact`` at its default chunk
  and at each ``--chunk`` (a checkout without it, such as a parent from
  before the parallel form, runs ``corridor_scan`` with ``chunk =
  length``, its exact form then);
- ``oracle`` (with ``--oracle``): the one-thread walk of each whole row,
  ``corridor_scan`` with ``chunk = length``, timed once.

Every case's flags are hashed; the exact form's must equal the oracle's
and every checkout's the first checkout's.  ``--fits`` also times
``tune.build_many(kind, shards, fit="vmap")`` of PGM, PGM_M and RS on the
first table's shards (host seconds around a synchronise: the corridor
launches, the host assembly and the masks' copies to the host).

``--study`` runs on the CPU instead, on shard 0 of each table at each ε
(``--chunk`` sizes, default 256 and 4,096): the true segmentation (the
port's host ``pla_segments``/``spline_knots``), its mean segment length,
and for every chunk start the distance to the first element where a walk
started fresh there flags the same element as the true walk (the exact
form's sync test): the share of chunks that do not sync within the chunk,
and the mean distance (the row's length where they never meet).

A checkout (``--root``) is any directory holding ``src/repro_torch``, for
instance a parent commit unpacked with ``git archive``; give one twice to
see the spread:

    python3 corridor_bench.py --root _archive/parent --root . --root . \\
        --root _archive/parent --oracle --fits --out build/corridor_bench.json

Times are means of CUDA-event-timed calls (``ms``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import device_ms, fail, log, phase_device

ROOT = Path(__file__).resolve().parent
TABLES = ("amzn64", "osm")
SHARDS, SHARD_KEYS = 4, 1 << 22
EPS = 64.0
BLOCK = 256  # the fast fit's FAST_CHUNK
DATA = ROOT / "build" / "corridor_bench"
FIT_KINDS = ("PGM", "PGM_M", "RS")


def _digest(flags) -> str:
    return hashlib.sha256(flags.cpu().numpy().tobytes()).hexdigest()[:16]


def worker(root: Path, label: str, cfg: dict) -> None:
    """Measure the checkout at ``root``; one ``[row]`` JSON line a case."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import keys
    from repro_torch.kernels import corridor_scan as cs
    from repro_torch.kernels import cuda_lib

    if not Path(cuda_lib.__file__).resolve().is_relative_to(root.resolve()):
        fail(f"imported {cuda_lib.__file__}, not the checkout at {root}")
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    exact_fn = getattr(cs, "corridor_scan_exact", None)
    chunks = [None] + (cfg["chunks"] if exact_fn is not None else [])
    n = SHARD_KEYS

    def row(**kw):
        print("[row] " + json.dumps({"root": label, **kw}), flush=True)

    for ds in cfg["tables"]:
        k = keys.to_f64(keys.encode(np.load(DATA / f"{ds}.npy").reshape(SHARDS, n), dev))
        for e in cfg["eps"]:
            eps = torch.full((SHARDS,), e, dtype=torch.float64, device=dev)
            for rec in ("pgm", "rs"):
                exact_len = n if rec == "pgm" else n - 2
                blocked_len = n if rec == "pgm" else n - 1

                def blocked(rec=rec):
                    return cs.corridor_scan(k, eps, recurrence=rec, length=blocked_len,
                                            chunk=BLOCK)

                flags = blocked()
                row(table=ds, eps=e, recurrence=rec, form="blocked", chunk=BLOCK,
                    ms=device_ms(blocked, dev, reps=20, warmup=2), flags=int(flags.sum()),
                    digest=_digest(flags))
                for chunk in chunks:
                    if exact_fn is None:
                        def exact(rec=rec):
                            return cs.corridor_scan(k, eps, recurrence=rec, length=exact_len,
                                                    chunk=exact_len)
                    else:
                        def exact(rec=rec, chunk=chunk):
                            kw = {} if chunk is None else {"chunk": chunk}
                            return exact_fn(k, eps, recurrence=rec, length=exact_len, **kw)
                    flags = exact()
                    reps = 2 if exact_fn is None else 5
                    row(table=ds, eps=e, recurrence=rec, form="exact",
                        chunk=chunk if exact_fn is not None else exact_len,
                        ms=device_ms(exact, dev, reps=reps, warmup=0 if exact_fn is None else 1),
                        flags=int(flags.sum()), digest=_digest(flags))
                if cfg["oracle"]:
                    def oracle(rec=rec):
                        return cs.corridor_scan(k, eps, recurrence=rec, length=exact_len,
                                                chunk=exact_len)

                    flags = oracle()
                    row(table=ds, eps=e, recurrence=rec, form="oracle", chunk=exact_len,
                        ms=device_ms(oracle, dev, reps=1, warmup=0), flags=int(flags.sum()),
                        digest=_digest(flags))
    if cfg["fits"]:
        from repro_torch import tune

        ds = cfg["tables"][0]
        shards = list(np.load(DATA / f"{ds}.npy").reshape(SHARDS, n))
        for kind in FIT_KINDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bm = tune.build_many(kind, shards, fit="vmap", device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            leaves = bm.index.to_numpy()
            digest = hashlib.sha256(b"".join(leaves[key].tobytes() for key in sorted(leaves)))
            row(table=ds, kind=kind, form="fit-vmap", seconds=seconds,
                digest=digest.hexdigest()[:16])


def study(cfg) -> None:
    """``--study``: segment lengths and sync distances on the CPU; one
    ``[study]`` JSON line a table, ε and recurrence."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.pgm import pla_segments
    from repro_torch.core.radix_spline import spline_knots
    from repro_torch.data import generate
    from repro_torch.kernels.corridor_scan import corridor_scan_twin

    for ds in cfg["tables"]:
        shard = generate(ds, SHARDS * SHARD_KEYS)[:SHARD_KEYS].astype(np.float64)
        keys = torch.from_numpy(shard)[None]
        for e in cfg["eps"]:
            for rec in ("pgm", "rs"):
                length = SHARD_KEYS if rec == "pgm" else SHARD_KEYS - 2
                starts = (pla_segments(shard, int(e))[0] if rec == "pgm"
                          else spline_knots(shard, int(e)))
                true = np.zeros(SHARD_KEYS, bool)
                true[starts] = True
                true = true[:length]
                out = {"table": ds, "eps": e, "recurrence": rec, "segments": int(true.sum()),
                       "mean_len": length / max(int(true.sum()), 1), "chunks": {}}
                for chunk in cfg["chunks"] or [256, 4096]:
                    spec = corridor_scan_twin(keys, torch.tensor([e], dtype=torch.float64),
                                              recurrence=rec, length=length, chunk=chunk)[0].numpy()
                    j0 = np.arange(chunk, length, chunk)
                    spec[np.arange(0, length, chunk)] = True  # a fresh start anchors its chunk
                    both = np.flatnonzero(true & spec)
                    at = np.searchsorted(both, j0)
                    dist = np.where(at < len(both), both[np.minimum(at, len(both) - 1)] - j0, length)
                    out["chunks"][chunk] = {"unsynced": float(np.mean(dist >= chunk)),
                                            "mean_distance": float(dist.mean())}
                print("[study] " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, action="append", default=[],
                    help="a checkout holding src/repro_torch (repeatable; default: this one)")
    ap.add_argument("--table", action="append", default=[], help=f"tables (default {TABLES})")
    ap.add_argument("--eps", type=float, action="append", default=[], help=f"ε (default {EPS})")
    ap.add_argument("--chunk", type=int, action="append", default=[],
                    help="also time the exact form at this chunk (repeatable)")
    ap.add_argument("--oracle", action="store_true",
                    help="also time the one-thread walk of the whole rows (once a case)")
    ap.add_argument("--fits", action="store_true",
                    help="also time build_many(fit='vmap') of PGM, PGM_M and RS")
    ap.add_argument("--study", action="store_true",
                    help="on the CPU: segment lengths and the chunks' sync distances")
    ap.add_argument("--out", type=Path, default=None, help="write every row as JSON here")
    ap.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cfg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.label, json.loads(args.cfg))
        return 0

    cfg = {"tables": args.table or list(TABLES), "eps": args.eps or [EPS], "chunks": args.chunk,
           "oracle": args.oracle, "fits": args.fits}
    if args.study:
        study(cfg)
        return 0
    info = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import generate

    DATA.mkdir(parents=True, exist_ok=True)
    for ds in cfg["tables"]:
        if not (DATA / f"{ds}.npy").exists():
            np.save(DATA / f"{ds}.npy", generate(ds, SHARDS * SHARD_KEYS))
    rows = []
    for root in args.root or [ROOT]:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                              str(root.resolve()), "--label", str(root), "--cfg", json.dumps(cfg)],
                             capture_output=True, text=True, timeout=1800)
        if res.returncode != 0:
            fail(f"{root}: exit {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        for ln in res.stdout.splitlines():
            if ln.startswith("[row] "):
                rows.append(json.loads(ln[6:]))
                log(ln)
    first = {}
    for r in rows:
        # the exact form and the oracle compute the same flags
        form = "exact" if r["form"] == "oracle" else r["form"]
        case = (r["table"], r.get("eps"), r.get("recurrence", r.get("kind")), form)
        if first.setdefault(case, r["digest"]) != r["digest"]:
            fail(f"{r['root']}: {case} ({r['form']}, chunk {r.get('chunk')}) differs from the "
                 "first checkout's")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": info, "rows": rows}, indent=1))
    log(f"[device] nvidia-smi: {info['nvidia_smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
