"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with its own ``nvcc`` process, all started
together, into an object file; one more ``nvcc`` links them into
``build/repro_torch/libkernels.so`` at the repository root, which is
loaded with :mod:`ctypes`.  A file lock in the build directory
(``fcntl.flock``) serialises the check and the build, so processes that
reach the kernels together (the ranks of a process group, test workers)
build once and load.  The sources expose a plain C interface
(pointers and the stream as ``void*``, sizes as ``int``/``long long``),
so no PyTorch header is compiled and a build takes seconds.

Every flag below matters for parity: ``-fmad=false`` keeps ``a*b+c`` as
two rounded operations, which is the arithmetic the re-encoded ε was
measured with (see :mod:`repro_torch.kernels.ops`).  A source change
invalidates the library through a digest stamp beside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "kary_search.cu", "rmi_search.cu", "pgm_search.cu", "rs_search.cu",
    "decode_attention.cu", "embedding_bag.cu", "corridor_scan.cu",
)
#: included by the search sources: part of the digest, not compiled on its own
HEADERS = ("search_common.cuh",)
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-O3",
    "-fmad=false",
    "-std=c++17",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

#: C entry points and their argument types (see each source's launcher)
SIGNATURES = {
    # table, n, queries, nq, out, stream
    "kary_search_launch": (_P, _I, _P, _L, _P, _P),
    # tables, n_tables, n, queries, q_stride, nq, out, stream
    "batched_kary_search_launch": (_P, _I, _I, _P, _L, _L, _P, _P),
    # queries, nq, kmin, inv_span, table, root, slope, icept, eps, rlo, rhi,
    # b, b_over_n, steps, out, stream
    "rmi_search_launch": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _I, _P, _P),
    # queries, q_stride, nq, n_tables, kmin, inv_span, tables, n, root,
    # slope, icept, eps, rlo, rhi, b, b_over_n, steps, out, stream
    "batched_rmi_search_launch": (
        _P, _L, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _D, _I, _P, _P
    ),
    # queries, nq, kmin, inv_span, table, n, keys, u0, slope, rank0, off,
    # off_r, sizes, eps, levels, steps, out, stream
    "pgm_search_launch": (_P, _L, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    # queries, q_stride, nq, n_tables, kmin, inv_span, tables, n, keys, u0,
    # slope, kn, rank0, rn, off, off_r, sizes, eps, levels, steps, out, stream
    "batched_pgm_search_launch": (
        _P, _L, _L, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P
    ),
    # queries, nq, kmin, shift, rk_kmin, rk_inv_span, table, n, knots, u0,
    # slope, ranks, mk, radix, radix_len, top, m_valid, eps, ksteps, steps,
    # out, stream
    "rs_search_launch": (
        _P, _L, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P
    ),
    # queries, q_stride, nq, n_tables, kmin, shift, rk_kmin, rk_inv_span,
    # tables, n, knots, u0, slope, ranks, mk, radix, radix_len, top, m_valid,
    # eps, ksteps, steps, out, stream
    "batched_rs_search_launch": (
        _P, _L, _L, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I,
        _P, _P
    ),
    # q, k, v, kv_len, out, lse, part_acc, part_ml, counter, B, S, Hkv, D,
    # kv_heads, group, tile, n_split, dtype (0 f32, 1 bf16), stream
    "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P),
    # table, V, D, ids, seg, w, n, num_bags, out, stream
    "embedding_bag_launch": (_P, _I, _I, _P, _P, _P, _L, _I, _P, _P),
    # keys, stride, n_tables, length, chunk, mode (0 PGM, 1 RS), eps, count, out, stream
    "corridor_scan_launch": (_P, _L, _I, _L, _L, _I, _P, _P, _P, _P),
    # keys, stride, n_tables, length, chunk, mode, eps, count, scratch, out, stream
    "corridor_exact_launch": (_P, _L, _I, _L, _L, _I, _P, _P, _P, _P, _P),
}

_lib = None
_ptxas = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


@contextlib.contextmanager
def _build_lock():
    """Hold an exclusive lock on ``BUILD_DIR/build.lock``; the kernel
    releases it when the holder exits, however it exits."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build() -> Path:
    """Compile every source (in parallel) and link ``libkernels.so``, under
    the build lock.  Records ``-Xptxas -v`` output per source (see
    :func:`ptxas_report`)."""
    with _build_lock():
        return _build()


def _build() -> Path:
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    objs, failed = [], []
    for name, obj, p in procs:
        err = p.communicate()[1]
        _ptxas[name] = err
        if p.returncode != 0:
            failed.append(f"{name}:\n{err}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed on\n" + "\n".join(failed))
    lib = BUILD_DIR / "libkernels.so"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(lib)], stderr=subprocess.PIPE, text=True
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {lib} failed:\n{link.stderr}")
    (BUILD_DIR / "libkernels.stamp").write_text(_digest())
    return lib


def ptxas_report() -> dict:
    """Source name -> the ``ptxas info`` lines of the last build in this
    process (registers, shared memory, spills per kernel)."""
    return {
        name: [ln.strip() for ln in err.splitlines() if "ptxas" in ln or "spill" in ln]
        for name, err in _ptxas.items()
    }


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale (checked
    and built under the build lock: a process that waits on another's
    build finds it fresh and loads it)."""
    global _lib
    if _lib is None:
        lib = BUILD_DIR / "libkernels.so"
        stamp = BUILD_DIR / "libkernels.stamp"
        with _build_lock():
            if not (lib.exists() and stamp.exists() and stamp.read_text() == _digest()):
                lib = _build()
        handle = ctypes.CDLL(str(lib))
        for fn, argtypes in SIGNATURES.items():
            getattr(handle, fn).argtypes = list(argtypes)
            getattr(handle, fn).restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


def _require_tensor(t, name: str, dtype, device) -> None:
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def require(t, name: str, dtype, device, numel=None) -> None:
    """Validate one kernel operand: a contiguous 1-D tensor of ``dtype``
    on ``device`` (and of ``numel`` elements when given)."""
    _require_tensor(t, name, dtype, device)
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got shape {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must hold {numel} elements, got {t.numel()}")


def require_rows(t, name: str, dtype, device, rows: int, cols=None) -> None:
    """Validate one batched kernel operand: a contiguous 2-D tensor of
    ``dtype`` on ``device`` with ``rows`` rows (and ``cols`` columns when
    given), one row per table."""
    _require_tensor(t, name, dtype, device)
    if t.dim() != 2 or not t.is_contiguous() or t.shape[0] != rows:
        raise ValueError(f"{name} must be a contiguous ({rows}, m) tensor, got {tuple(t.shape)}")
    if cols is not None and t.shape[1] != cols:
        raise ValueError(f"{name} must have {cols} columns, got {t.shape[1]}")


def query_rows(queries, rows: int, device) -> int:
    """Validate the batched queries: ``(rows, B)`` int64 on ``device``,
    each row contiguous, rows either packed or one row broadcast (stride
    0, from ``expand``).  Returns the row stride the kernels take."""
    _require_tensor(queries, "queries", torch.int64, device)
    if queries.dim() != 2 or queries.shape[0] != rows:
        raise ValueError(f"queries must be ({rows}, B), got {tuple(queries.shape)}")
    row_stride, col_stride = queries.stride()
    if col_stride != 1 and queries.shape[1] > 1:
        raise ValueError("each row of queries must be contiguous")
    if row_stride not in (0, queries.shape[1]) and rows > 1:
        raise ValueError("queries must be packed rows or one row broadcast to every table")
    return row_stride if rows > 1 else queries.shape[1]


def launch(fn: str, device, *args) -> None:
    """Call the C launcher ``fn`` on ``device``'s current stream and raise
    when it reports a CUDA error.  The launch runs on the current device,
    switched to ``device`` around the call only when it differs; the
    stream comes as a raw handle, without a ``torch.cuda.Stream`` object
    (together a third of a small kernel's host cost, PERF.md)."""
    launcher = getattr(library(), fn)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        rc = launcher(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = launcher(*args, torch._C._cuda_getCurrentRawStream(index))
    check(rc, fn)
