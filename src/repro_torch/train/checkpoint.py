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
  template leaf's device;
* elastic restore: with ``shardings`` (a matching tree of
  :class:`~repro_torch.dist.sharding.NamedSharding` on a live
  ``DeviceMesh``, e.g. ``launch.steps.state_shardings``) each leaf comes
  back as a ``DTensor`` on that mesh whose ``to_local()`` is this rank's
  block, whatever layout wrote it: a checkpoint restores onto any other
  mesh;
* placed states (plain tensors, each rank its blocks: the LM under
  ``tp``/``fsdp``/``ep``): with ``placement`` (a
  :class:`~repro_torch.dist.sharding.StatePlacement`) the state is gathered
  whole once (``gather_state``, on the host) and rank 0 writes it, so the
  files are a whole state's and restore onto any layout; ``restore`` with
  ``placement`` cuts each whole leaf to this rank's block under that
  placement.
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
import torch.distributed

from repro_torch import tree

BF16 = "bfloat16"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(ckpt_dir, state, step: int, async_write: bool = True, *, placement=None):
    """Save the tree ``state`` at ``step``.  Returns the writer thread
    (``join()`` it) when ``async_write``, else None after the write.  A
    state holding ``DTensor`` leaves is saved by every rank of their mesh
    together: each leaf is gathered whole (``full_tensor``), and the
    default group's rank 0 writes the files (the others' thread does
    nothing).  So is a placed state with its ``placement``
    (:class:`~repro_torch.dist.sharding.StatePlacement`): gathered whole
    once on the host, then written by rank 0."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"

    if placement is not None:
        state = placement.gather(state)
    paths, leaves = tree.flatten_with_paths(state)
    sharded = [_is_dtensor(l) for l in leaves]
    # a DTensor leaf is gathered whole on every rank; then rank 0 writes
    leaves = [l.full_tensor() if d else l for l, d in zip(leaves, sharded)]
    dtypes = [BF16 if l.dtype == torch.bfloat16 else None for l in leaves]
    host_leaves = [tree.to_numpy(l) for l in leaves]
    if (any(sharded) or placement is not None) and torch.distributed.get_rank() != 0:
        return _done(async_write)
    tmp.mkdir(parents=True, exist_ok=True)

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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _done(async_write: bool):
    """What :func:`save` returns on a rank that writes nothing."""
    if not async_write:
        return None
    t = threading.Thread(target=lambda: None, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir):
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(ckpt_dir, state_template, step: int | None = None, shardings=None, *,
            placement=None):
    """``(state, step)``: the checkpoint at ``step`` (default: ``LATEST``)
    in ``state_template``'s structure, each leaf on its template leaf's
    device in the dtype the manifest names.  The template's leaves need
    only ``shape`` (and ``device`` without ``shardings``).

    ``shardings``: a matching tree of ``NamedSharding`` on a live mesh;
    each leaf is then a ``DTensor`` on that mesh, placed as its sharding
    says, holding this rank's block on the mesh's device type.

    ``placement``: a :class:`~repro_torch.dist.sharding.StatePlacement` of
    a placed state; the template holds this rank's blocks, each saved
    (whole) leaf must have the placement's whole shape, and this rank
    gets its block of it as a plain tensor on the template leaf's device,
    whatever layout wrote the checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)

    paths, leaves = tree.flatten_with_paths(state_template)
    shards = (tree.flatten_up_to(state_template, shardings) if shardings is not None
              else [None] * len(leaves))
    blocks = placement.shardings() if placement is not None else [None] * len(leaves)
    wholes = tree.leaves(placement.whole) if placement is not None else leaves
    coord = placement.ctx.coordinate() if placement is not None else None
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p, tmpl, shd, blk, whole in zip(paths, leaves, shards, blocks, wholes):
        e = by_path[p]
        arr = np.load(d / e["file"])
        if _crc(arr) != e["crc32"]:
            raise IOError(f"checksum mismatch for leaf {p}")
        if list(arr.shape) != list(whole.shape):
            raise ValueError(f"shape mismatch for {p}: {arr.shape} vs {tuple(whole.shape)}")
        if blk is not None:
            t = blk.local_block(tree.from_numpy(arr, "cpu", e["dtype"]), coord)
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {p}: block {tuple(t.shape)} vs "
                                 f"{tuple(tmpl.shape)}")
            out.append(t.contiguous().to(tmpl.device))
        elif shd is None:
            out.append(tree.from_numpy(arr, tmpl.device, e["dtype"]))
        else:
            out.append(_placed(arr, e["dtype"], shd))
    return tree.unflatten(state_template, out), step


def _placed(arr, dtype_name, sharding):
    """The host array ``arr`` as a ``DTensor`` on ``sharding``'s mesh: this
    rank's block, copied to the mesh's device."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    whole = tree.from_numpy(arr, "cpu", dtype_name)
    local = sharding.local_block(whole, coord).contiguous().to(mesh.device_type)
    return DTensor.from_local(local, mesh, sharding.placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())
