"""Step-atomic checkpointing with integrity checks (counterpart of
``repro.train.checkpoint``; no orbax, no ``torch.save``).

Layout:  <dir>/step_<N>/
           manifest.json   — each leaf's path, file, shape, dtype, crc32
           leaf_<i>.npy    — one file per leaf, host copies
         <dir>/LATEST      — atomically updated pointer (write + rename)

The manifest is the reference's: leaves in ``jax.tree_util`` order,
their paths rendered as JAX renders them (``"['params']/['embed']"``),
so an f32/int32 checkpoint written by either package restores into the
other.  A bf16 leaf is stored as its raw 16-bit words under the dtype
string ``"bfloat16"`` (numpy has no bfloat16; the reference's ``.npy``
holds the same bytes as ``V2``), and the crc32 covers those bytes.

* step-atomic: a step is written under ``.tmp_step_N`` and renamed; a
  crash mid-write never moves ``LATEST``;
* async: the host copy is made synchronously, the disk write runs on a
  background thread (``save`` returns it to ``join()``);
* integrity: ``restore`` checks each leaf's crc32 (``IOError``) and its
  shape against the template (``ValueError``), and puts each leaf on the
  template leaf's device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree

BF16 = "bfloat16"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(ckpt_dir, state, step: int, async_write: bool = True):
    """Save the tree ``state`` at ``step``.  Returns the writer thread
    (``join()`` it) when ``async_write``, else None after the write."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)

    paths, leaves = tree.flatten_with_paths(state)
    dtypes = [BF16 if l.dtype == torch.bfloat16 else None for l in leaves]
    host_leaves = [tree.to_numpy(l) for l in leaves]

    def write():
        manifest = {"step": step, "leaves": []}
        for i, (p, arr, dt) in enumerate(zip(paths, host_leaves, dtypes)):
            fn = f"leaf_{i}.npy"
            np.save(tmp / fn, arr)
            manifest["leaves"].append({"path": p, "file": fn, "shape": list(arr.shape),
                                       "dtype": dt or str(arr.dtype), "crc32": _crc(arr)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.rename(latest_tmp, ckpt_dir / "LATEST")  # atomic pointer flip

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir):
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(ckpt_dir, state_template, step: int | None = None):
    """``(state, step)``: the checkpoint at ``step`` (default: ``LATEST``)
    in ``state_template``'s structure, each leaf on its template leaf's
    device in the dtype the manifest names."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)

    paths, leaves = tree.flatten_with_paths(state_template)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p, tmpl in zip(paths, leaves):
        e = by_path[p]
        arr = np.load(d / e["file"])
        if _crc(arr) != e["crc32"]:
            raise IOError(f"checksum mismatch for leaf {p}")
        if list(arr.shape) != list(tmpl.shape):
            raise ValueError(f"shape mismatch for {p}: {arr.shape} vs {tuple(tmpl.shape)}")
        out.append(tree.from_numpy(arr, tmpl.device, e["dtype"]))
    return tree.unflatten(state_template, out), step
