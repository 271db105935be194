"""Static array-packed B+-tree baseline (counterpart of ``repro.core.btree``).

Built bottom-up over the sorted table: each internal level holds the
first key of every fanout-F group of the level below, padded with the
max key.  The port answers BTREE lookups with the model-free search, as
the reference's ``backend="pallas"`` does, so only the build is here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class BTreeModel:
    fanout: int
    levels: list  # root-first uint64 arrays, padded to fanout multiples
    valid: list  # real (non-pad) entries per level
    n: int
    build_time: float = 0.0
    name: str = "BTree"

    def space_bytes(self) -> int:
        return sum(int(lvl.shape[0]) for lvl in self.levels) * 8 + 8


def build_btree(table_np: np.ndarray, fanout: int = 16) -> BTreeModel:
    t0 = time.perf_counter()
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
        build_time=time.perf_counter() - t0,
        name=f"BTree[f={f}]",
    )
