"""Static array-packed B+-tree baseline (counterpart of ``repro.core.btree``).

Built bottom-up over the sorted table: each internal level holds the
first key of every fanout-F group of the level below, padded with the
max key.  Query: descend with an F-way fence compare per level, then a
bounded search inside the final leaf block (:func:`btree_window`, on
encoded key tensors).  The kernel backend answers BTREE with the
model-free search, as the reference's ``backend="pallas"`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs.timing import stopwatch

from . import search
from .keys import encode


def btree_window(q, keys, off, valid, *, fanout: int, levels: int, n: int):
    """Inclusive window of each encoded query: the descent over the
    level-concatenated fence ``keys`` (``off``/``valid`` per level, root
    first) reaches a leaf block of ``fanout`` keys; the predecessor may
    sit one key left of it.  Fence reads clip, as the reference's do.
    The leaves are a stack's, the queries ``(N, B)``; one tree is the
    stack of one (:func:`search.one_table`)."""
    if levels == 0:  # degenerate: the table fits one block
        z = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
        return z, z + (n - 1)
    f = fanout
    lanes = torch.arange(f, dtype=torch.int64, device=q.device)
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lvl in range(levels):
        base = node * f
        fence = off[:, lvl, None, None] + base[..., None] + lanes
        v = search.take_clip(keys, fence)
        child = torch.clamp((v <= q[..., None]).to(torch.int64).sum(-1) - 1, min=0)
        # clamp into the real entries: q == max-key pads would walk into padding
        node = torch.minimum(base + child, valid[:, lvl, None] - 1)
    node = torch.clamp(node, max=(n + f - 1) // f - 1)
    lo = node * f
    hi = torch.clamp(lo + f - 1, max=n - 1)
    return torch.clamp(lo - 1, min=0), hi


@dataclass
class BTreeModel:
    fanout: int
    levels: list  # root-first uint64 arrays, padded to fanout multiples
    valid: list  # real (non-pad) entries per level
    n: int
    build_time: float = 0.0
    name: str = "BTree"

    def intervals(self, table, q):
        """Window of each encoded query (``table`` and ``q`` are encoded
        key tensors on one device)."""
        dev = q.device
        keys = np.concatenate(self.levels) if self.levels else np.zeros((0,), dtype=np.uint64)
        off = np.concatenate([[0], np.cumsum([len(lvl) for lvl in self.levels])]).astype(np.int64)
        return search.one_table(btree_window, q, encode(keys, dev), torch.as_tensor(off, device=dev),
                                torch.as_tensor(np.asarray(self.valid, dtype=np.int64), device=dev),
                                fanout=self.fanout, levels=len(self.levels), n=self.n)

    @property
    def max_window(self) -> int:
        return min(self.fanout + 1, self.n)

    def predecessor(self, table, q):
        lo, hi = self.intervals(table, q)
        return search.bounded_bfs(table, q, lo, hi, max_window=self.max_window)

    def space_bytes(self) -> int:
        return sum(int(lvl.shape[0]) for lvl in self.levels) * 8 + 8


def build_btree(table_np: np.ndarray, fanout: int = 16) -> BTreeModel:
    sw = stopwatch()
    n = len(table_np)
    f = max(2, fanout)
    maxk = np.iinfo(np.uint64).max

    levels = []
    valid = []
    cur = table_np
    while len(cur) > f:
        first = cur[::f]
        n_groups = len(first)
        padded_len = ((n_groups + f - 1) // f) * f
        lvl = np.full(padded_len, maxk, dtype=np.uint64)
        lvl[:n_groups] = first
        levels.append(lvl)
        valid.append(n_groups)
        cur = first

    levels.reverse()  # root first (empty when the table fits one block)
    valid.reverse()
    return BTreeModel(
        fanout=f,
        levels=levels,
        valid=valid,
        n=n,
        build_time=sw.elapsed,
        name=f"BTree[f={f}]",
    )
