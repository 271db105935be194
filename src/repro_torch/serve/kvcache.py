"""Paged KV cache with a learned-index page table (counterpart of
``repro.serve.kvcache``).

Pages of ``page_size`` tokens are allocated from a global pool; each
sequence owns an ordered list of pages.  Mapping a global token position
to (page, offset) is predecessor search over the sequence's sorted
page-start table: the paper's technique on the serving hot path.
:class:`ContiguousCache` is the reference's contiguous (L, B, S, Hkv, D)
K/V pair; :class:`repro_torch.serve.DecodeEngine` keeps its own cache
dict from :func:`repro_torch.models.transformer.init_cache` instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.pgm import build_pgm
from repro_torch.device import resolve_device


@dataclass
class ContiguousCache:
    k: torch.Tensor  # (L, B, S, Hkv, D)
    v: torch.Tensor
    length: int = 0

    @staticmethod
    def init(n_layers, batch, max_seq, n_kv, head_dim, dtype=torch.bfloat16, device=None):
        shape = (n_layers, batch, max_seq, n_kv, head_dim)
        dev = resolve_device(device)
        return ContiguousCache(torch.zeros(shape, dtype=dtype, device=dev),
                               torch.zeros(shape, dtype=dtype, device=dev), 0)


class PagedPool:
    """Host-side page allocator + device page store.

    The device store is (n_pages, L, page, Hkv, D) per k/v, on ``device``
    (the card when None); sequences hold page id lists.
    ``position_lookup`` builds (once per page-table change) and uses a
    PGM index (:func:`repro_torch.core.pgm.build_pgm`, eps 4) over each
    sequence's page-start offsets, and answers on the pool's device.
    """

    def __init__(self, n_pages, n_layers, page_size, n_kv, head_dim, dtype=torch.bfloat16,
                 device=None):
        self.device = resolve_device(device)
        self.page_size = page_size
        shape = (n_pages, n_layers, page_size, n_kv, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.free = list(range(n_pages))[::-1]
        self.seq_pages: dict = {}
        self.seq_len: dict = {}
        self._pgm: dict = {}

    def add_sequence(self, seq_id: int):
        self.seq_pages[seq_id] = []
        self.seq_len[seq_id] = 0

    def release(self, seq_id: int):
        self.free.extend(self.seq_pages.pop(seq_id, []))
        self.seq_len.pop(seq_id, None)
        self._pgm.pop(seq_id, None)

    def ensure_capacity(self, seq_id: int, new_len: int):
        pages = self.seq_pages[seq_id]
        while len(pages) * self.page_size < new_len:
            if not self.free:
                raise MemoryError("KV pool exhausted")
            pages.append(self.free.pop())
        self.seq_len[seq_id] = new_len
        self._pgm.pop(seq_id, None)  # page table changed -> rebuild index

    def page_starts(self, seq_id: int) -> np.ndarray:
        n = len(self.seq_pages[seq_id])
        return (np.arange(n, dtype=np.uint64) * self.page_size).astype(np.uint64)

    def position_lookup(self, seq_id: int, positions):
        """Global positions -> ``(page_id, offset)``, int64 tensors on the
        pool's device, via learned predecessor search over the page-start
        table."""
        starts = self.page_starts(seq_id)
        if seq_id not in self._pgm:
            self._pgm[seq_id] = build_pgm(starts, eps=4)
        pgm = self._pgm[seq_id]
        pos_np = np.asarray(positions, dtype=np.uint64)
        q = keymod.encode(pos_np, self.device)
        idx = pgm.predecessor(keymod.encode(starts, self.device), q)
        pages = torch.as_tensor(np.asarray(self.seq_pages[seq_id], dtype=np.int64),
                                device=self.device)
        at = torch.clamp(idx, min=0)
        page_id = pages[at]
        offset = torch.from_numpy(pos_np.astype(np.int64)).to(self.device) - at * self.page_size
        return page_id, offset

    def utilization(self) -> float:
        total = len(self.free) + sum(len(p) for p in self.seq_pages.values())
        return 1.0 - len(self.free) / max(total, 1)
