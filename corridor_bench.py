#!/usr/bin/env python3
"""Time the corridor-scan kernel (``csrc/corridor_scan.cu``) of one or
more checkouts on one CUDA card, one process each.

Shapes: phase 5e of ``chip_smoke.py``: the amzn64 and osm tables of 2^24
keys (``data.generate``, seed 0; made once, by this checkout, and saved
under ``build/corridor_bench/``) as 4 shards of 2^22 f64 keys, ε 64.
The exact form (one row a table: 4 threads, 2^22 dependent steps each,
PGM and RS) and the blocked form of the fast fit (256 keys a row, 65,536
rows).  Every checkout's flags are hashed, and must equal the first
checkout's.

A checkout (``--root``) is any directory holding ``src/repro_torch``, for
instance a parent commit unpacked with ``git archive``; give one twice to
see the spread.  ``--ahead N`` adds a copy of this checkout whose kernel
double-buffers N keys a buffer (``kAhead``).  ``--probe`` times two probe
kernels of PGM's exact form (``PROBE_SRC``, built here), one thread a
table, plain loads: ``plain`` walks the recurrence as the kernel does;
``spec`` takes the divisions off the dependent chain by computing, one
step ahead, the next step's quotients for both outcomes of this step
(keep the anchor, or re-anchor here: four divisions a step) and selecting
one.  If the chain's latency set the step, ``spec`` would be faster.

    python3 corridor_bench.py --root _archive/parent --root . --root . \\
        --root _archive/parent --ahead 16 --probe --out chiprun_out/corridor_bench.json

Times are means of CUDA-event-timed calls (``ms``); ``ns_per_step`` is
``ms`` over the steps one thread walks.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false", "-std=c++17",
              "-Xcompiler", "-fPIC", "--shared")

#: the probe kernels: PGM's exact recurrence, one thread a table
PROBE_SRC = r"""
#include <cuda_runtime.h>
namespace {
__device__ __forceinline__ double max_nan(double a, double b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double min_nan(double a, double b) { return (a < b || a != a) ? a : b; }

__global__ void plain_k(const double* keys, long long stride, int n_tables, long long n,
                        const double* eps, unsigned char* out) {
  const int t = threadIdx.x;
  if (t >= n_tables) return;
  const double* k = keys + t * stride;
  unsigned char* f = out + t * n;
  const double e = eps[t], inf = __longlong_as_double(0x7ff0000000000000LL);
  double x0 = 0.0, s = -1.0, lo = 0.0, hi = inf;
  for (long long j = 0; j < n; ++j) {
    const double x = k[j], r = (double)j;
    const double dx = x - x0, dy = r - s;
    const double nlo = max_nan(lo, (dy - e) / dx), nhi = min_nan(hi, (dy + e) / dx);
    const bool bad = (nlo > nhi) || (s < 0.0);
    f[j] = bad;
    x0 = bad ? x : x0; s = bad ? r : s; lo = bad ? 0.0 : nlo; hi = bad ? inf : nhi;
  }
}

__global__ void spec_k(const double* keys, long long stride, int n_tables, long long n,
                       const double* eps, unsigned char* out) {
  const int t = threadIdx.x;
  if (t >= n_tables) return;
  const double* k = keys + t * stride;
  unsigned char* f = out + t * n;
  const double e = eps[t], inf = __longlong_as_double(0x7ff0000000000000LL);
  double x0 = 0.0, s = -1.0, lo = 0.0, hi = inf;
  double qlo = ((0.0 - s) - e) / (k[0] - x0), qhi = ((0.0 - s) + e) / (k[0] - x0);
  for (long long j = 0; j < n; ++j) {
    const double x = k[j], r = (double)j, xn = k[j + 1 < n ? j + 1 : j], rn = r + 1.0;
    // step j + 1's quotients under this step's anchor and under an anchor here
    const double ka = rn - s, kdx = xn - x0, ra = rn - r, rdx = xn - x;
    const double klo = (ka - e) / kdx, khi = (ka + e) / kdx;
    const double rlo = (ra - e) / rdx, rhi = (ra + e) / rdx;
    const double nlo = max_nan(lo, qlo), nhi = min_nan(hi, qhi);
    const bool bad = (nlo > nhi) || (s < 0.0);
    f[j] = bad;
    x0 = bad ? x : x0; s = bad ? r : s; lo = bad ? 0.0 : nlo; hi = bad ? inf : nhi;
    qlo = bad ? rlo : klo; qhi = bad ? rhi : khi;
  }
}
}  // namespace

extern "C" int probe_launch(int which, const void* keys, long long stride, int n_tables,
                            long long n, const void* eps, void* out, void* stream) {
  auto kern = which == 0 ? plain_k : spec_k;
  kern<<<1, 32, 0, (cudaStream_t)stream>>>((const double*)keys, stride, n_tables, n,
                                           (const double*)eps, (unsigned char*)out);
  return (int)cudaGetLastError();
}
"""


def variant_root(ahead: int) -> Path:
    """A copy of this checkout's port whose kernel buffers ``ahead`` keys;
    it builds its own library beside it."""
    if not 1 <= ahead <= 64:
        fail(f"variant ahead={ahead}: must be 1..64")
    root = ROOT / "build" / "corridor_variants" / f"ahead{ahead}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "src" / "repro_torch" / "csrc" / "corridor_scan.cu"
    text, count = re.subn(r"(constexpr int kAhead = )\d+", rf"\g<1>{ahead}", path.read_text())
    if count != 1:
        fail(f"corridor_scan.cu: kAhead matched {count} times")
    path.write_text(text)
    return root


def worker(root: Path, label: str) -> None:
    """Measure the checkout at ``root``; one ``[row]`` JSON line a case."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import keys
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.corridor_scan import corridor_scan

    if not Path(cuda_lib.__file__).resolve().is_relative_to(root.resolve()):
        fail(f"imported {cuda_lib.__file__}, not the checkout at {root}")
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda")
    eps = torch.full((SHARDS,), EPS, dtype=torch.float64, device=dev)
    for ds in TABLES:
        table = np.load(DATA / f"{ds}.npy")
        k = keys.to_f64(keys.encode(table.reshape(SHARDS, SHARD_KEYS), dev))
        n = SHARD_KEYS
        for rec, form, length, chunk in (("pgm", "exact", n, n), ("rs", "exact", n - 2, n - 2),
                                         ("pgm", "blocked", n, BLOCK),
                                         ("rs", "blocked", n - 1, BLOCK)):
            def call(rec=rec, length=length, chunk=chunk):
                return corridor_scan(k, eps, recurrence=rec, length=length, chunk=chunk)

            flags = call()
            digest = hashlib.sha256(flags.cpu().numpy().tobytes()).hexdigest()[:16]
            exact = form == "exact"
            ms = device_ms(call, dev, reps=2 if exact else 20, warmup=0 if exact else 2)
            steps = min(length, chunk)
            print("[row] " + json.dumps({
                "root": label, "table": ds, "recurrence": rec, "form": form,
                "rows": SHARDS * -(-length // chunk), "steps": steps, "ms": ms,
                "ns_per_step": ms * 1e6 / steps, "flags": int(flags.sum()), "digest": digest,
            }), flush=True)


def probe(label: str) -> None:
    """Build ``PROBE_SRC`` and time its two kernels on the exact form's
    shape, against the port's flags; one ``[row]`` a table and kernel."""
    import ctypes

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import keys
    from repro_torch.kernels.corridor_scan import corridor_scan

    src, lib_path = DATA / "probe.cu", DATA / "probe.so"
    src.write_text(PROBE_SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_launch.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p)
    dev = torch.device("cuda")
    eps = torch.full((SHARDS,), EPS, dtype=torch.float64, device=dev)
    n = SHARD_KEYS
    for ds in TABLES:
        k = keys.to_f64(keys.encode(np.load(DATA / f"{ds}.npy").reshape(SHARDS, n), dev))
        want = corridor_scan(k, eps, recurrence="pgm", length=n, chunk=n)
        for which, name in enumerate(("plain", "spec")):
            out = torch.zeros((SHARDS, n), dtype=torch.bool, device=dev)

            def call(which=which, out=out):
                stream = torch.cuda.current_stream(dev).cuda_stream
                if lib.probe_launch(which, k.data_ptr(), n, SHARDS, n, eps.data_ptr(),
                                    out.data_ptr(), stream):
                    fail(f"probe {name}: launch failed")

            ms = device_ms(call, dev, reps=2, warmup=0)
            if not torch.equal(out, want):
                fail(f"probe {name} on {ds}: flags differ from the port's kernel")
            print("[row] " + json.dumps({
                "root": label, "table": ds, "recurrence": "pgm", "form": f"exact-probe-{name}",
                "rows": SHARDS, "steps": n, "ms": ms, "ns_per_step": ms * 1e6 / n,
                "flags": int(out.sum()), "digest": None,
            }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, action="append", default=[],
                    help="a checkout holding src/repro_torch (repeatable; default: this one)")
    ap.add_argument("--ahead", type=int, action="append", default=[],
                    help="N: this checkout with N keys a register buffer")
    ap.add_argument("--probe", action="store_true",
                    help="also time the plain and speculative probe kernels (PGM, exact form)")
    ap.add_argument("--out", type=Path, default=None, help="write every row as JSON here")
    ap.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        if args.label == "probe":
            probe(args.label)
        else:
            worker(args.worker, args.label)
        return 0

    info = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import generate

    DATA.mkdir(parents=True, exist_ok=True)
    for ds in TABLES:
        np.save(DATA / f"{ds}.npy", generate(ds, SHARDS * SHARD_KEYS))
    runs = [(str(r), r.resolve()) for r in args.root or [ROOT]]
    runs += [(f"this checkout, kAhead={a}", variant_root(a)) for a in args.ahead]
    if args.probe:
        runs.append(("probe", ROOT))
    rows = []
    for label, root in runs:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(root),
                              "--label", label], capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"{label}: exit {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        for ln in res.stdout.splitlines():
            if ln.startswith("[row] "):
                rows.append(json.loads(ln[6:]))
                log(ln)
    first = {}
    for r in rows:
        case = (r["table"], r["recurrence"], r["form"])
        if r["digest"] is None:  # a probe, held to the port's flags in its worker
            continue
        if first.setdefault(case, r["digest"]) != r["digest"]:
            fail(f"{r['root']}: {case} flags differ from {rows[0]['root']}'s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": info, "rows": rows}, indent=1))
    log(f"[device] nvidia-smi: {info['nvidia_smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
