"""Embedding substrate of the recsys architectures (counterpart of
``repro.models.embedding``).

* :func:`sharded_lookup` — rows of one mega-table, gathered by id.  On
  one rank both modes are a gather.  Under a
  :class:`~repro_torch.dist.sharding.ShardingCtx` each rank holds its
  contiguous shard of ``V / n_shards`` rows (the reference's split over
  the whole mesh) and:
    - ``"allreduce"``: a masked local gather, summed over the ranks with
      one ``all_reduce``;
    - ``"a2a"``: each rank buckets its slice of the ids by owner into a
      capacity-factored request matrix, one ``all_to_all`` sends the
      requests, each owner gathers its rows, a second ``all_to_all``
      sends the vectors back; over-capacity ids get the zero vector.
  Every rank returns the same ``(B, F, D)``.  Under a context with
  ``local_batch`` (a train step's :meth:`ShardingCtx.local_view`) each
  rank passes its own ids and gets their rows: ``"a2a"`` exchanges them
  as its slice, ``"allreduce"`` all-gathers the ids, sums the masked
  gathers and keeps this rank's block.  Both carry gradients back to the
  owners' rows: the all-to-all's backward is the reverse exchange, the
  psum's the psum of the ranks' gradients, and a capacity-dropped id,
  whose forward is the zero vector, sends no gradient.
* :class:`LearnedKeyedEmbedding` — the paper's technique on a model's
  hot path: raw 64-bit hashed ids become dense rows through a
  predecessor search in a learned index over the sorted key set (one
  index: ``rmi_search``; a sharded tier: ``batched_rmi_search``).
* :func:`embedding_bag` — take + ``index_add_``, the reference's plain
  path.  No model calls it, in either package; the hand-written kernel
  is :func:`repro_torch.kernels.ops.embedding_bag`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.cdf import sorted_unique
from repro_torch.device import resolve_device
from repro_torch.dist import collectives

#: the reference's lookup modes
MODES = ("allreduce", "a2a")


def embedding_bag(table, ids, seg_ids, num_bags: int, weights=None):
    """EmbeddingBag (sum mode): ``out[b] = sum_{seg_ids[i] = b} w[i] *
    table[ids[i]]``.  As ``jax.ops.segment_sum``, an item whose segment id
    lies outside ``[0, num_bags)`` adds nothing."""
    vecs = table[ids.long()]
    if weights is not None:
        vecs = vecs * weights[:, None].to(vecs.dtype)
    seg = seg_ids.long()
    keep = (seg >= 0) & (seg < num_bags)
    out = torch.zeros((num_bags,) + tuple(table.shape[1:]), dtype=vecs.dtype, device=vecs.device)
    return out.index_add_(0, seg[keep], vecs[keep])


def n_row_shards(ctx) -> int:
    """Shards of a row-sharded table under ``ctx``: every rank of its mesh
    (the reference's product over all mesh axes); 1 without a context."""
    return 1 if ctx is None else ctx.n("row")


def local_rows(table, ctx):
    """This rank's contiguous shard of a ``(V, ...)`` table under ``ctx``
    (``V`` a multiple of the shard count, as ``recsys.init`` rounds it);
    the whole table without a context."""
    n = n_row_shards(ctx)
    if n == 1:
        return table
    rows_per = table.shape[0] // n
    me = ctx.index("row")
    return table[me * rows_per:(me + 1) * rows_per]


def sharded_lookup(table, ids, ctx=None, mode: str = "allreduce", cap_factor: float = 2.0):
    """ids (B, F) ints into a row-sharded table -> (B, F, D).

    Without ``ctx`` (or on one rank) ``table`` is the whole ``(V, D)``
    table and both modes are a gather: one shard's capacity is at least
    its batch, so ``"a2a"`` drops nothing.  Under ``ctx`` ``table`` is
    this rank's ``(V / n_shards, D)`` shard (:func:`local_rows`), every
    rank calls with the same ``ids``, and every rank gets the same
    answer; ``"a2a"`` gives the zero vector to ids beyond a (source,
    owner) pair's ``cap_factor`` capacity (``cap_factor >= n_shards``
    never drops).  With ``ctx.local_batch`` each rank passes its own
    ``ids`` and gets its own rows (module docstring)."""
    if mode not in MODES:
        raise ValueError(mode)
    n_shards = n_row_shards(ctx)
    if n_shards == 1:
        return table[ids.long()]
    if ctx.local_batch:
        if mode == "allreduce":
            return _allreduce_local(table, ids, ctx)
        return _a2a_lookup(table, ids, ctx, n_shards, cap_factor)
    if mode == "allreduce":
        return _allreduce_lookup(table, ids, ctx, n_shards)
    dp = ctx.n("dp")
    b = ids.shape[0]
    pad = (-b) % dp
    if pad:
        ids = torch.cat([ids, ids.new_zeros((pad,) + tuple(ids.shape[1:]))])
    b_loc = ids.shape[0] // dp
    me = ctx.index("dp")
    part = _a2a_lookup(table, ids[me * b_loc:(me + 1) * b_loc], ctx, n_shards, cap_factor)
    if dp > 1:
        part = collectives.all_gather(part, ctx.group("dp"))
    return part[:b]


def _allreduce_lookup(table, ids, ctx, n_shards: int):
    """The masked local gather of every id, summed over the row group."""
    rows_per = table.shape[0]
    local = ids.long() - ctx.index("row") * rows_per
    mine = (local >= 0) & (local < rows_per)
    out = table[torch.clamp(local, 0, rows_per - 1)] * mine[..., None].to(table.dtype)
    return collectives.psum_if_mapped(out, ctx.mesh_axes("row"), ctx)


def _allreduce_local(table, ids, ctx):
    """Each rank's own ``ids`` (the same count on every rank): every rank's
    ids all-gathered over the row group, the masked gathers summed, this
    rank's block kept."""
    every = collectives.all_gather(ids, ctx.group("row"))
    out = _allreduce_lookup(table, every, ctx, n_row_shards(ctx))
    b = ids.shape[0]
    me = ctx.index("row")
    return out[me * b:(me + 1) * b]


def _a2a_lookup(table, local_ids, ctx, n_shards: int, cap_factor: float):
    """The reference's owner exchange on this rank's slice ``local_ids``
    (B_loc, F): requests to their owners, the owners' local gather, the
    vectors back, scattered into input order (over capacity: zeros)."""
    rows_per, d = table.shape
    group = ctx.group("row")
    flat = local_ids.reshape(-1).long()
    n = flat.shape[0]
    owner = torch.clamp(flat // rows_per, 0, n_shards - 1)
    cap = collectives.exchange_capacity(n, n_shards, cap_factor)
    req, slots, valid, order = collectives.bucket_by_owner(owner, flat, n_shards, cap, 0)
    req_x = collectives.all_to_all(req, group)  # (n_shards, cap) ids this rank owns
    rows = torch.clamp(req_x - ctx.index("row") * rows_per, 0, rows_per - 1)
    vecs = table[rows.reshape(-1)].reshape(n_shards, cap, d)
    back = collectives.all_to_all(vecs, group)
    out = collectives.unbucket_inverse(back, slots, valid, order, n, 0)
    return out.reshape(local_ids.shape[0], local_ids.shape[1], d)


@dataclass
class LearnedKeyedEmbedding:
    """Compressed-vocabulary embedding keyed by a learned index.

    Production recsys ids are 64-bit hashes; a dense table over the hash
    space is impossible.  The sorted unique key set (built offline) is
    searched with the paper's learned index to map a raw id to its dense
    row (the id-translation step); an absent id, or one the tier's
    exchange dropped, reads the OOV row, the table's last.

    Built with ``n_shards > 1`` the key set is a
    :class:`~repro_torch.dist.ShardedIndex` tier, and translation runs
    through :func:`repro_torch.dist.sharded_lookup`: without ``ctx`` one
    process answers every shard (one batched launch), with a context one
    shard a rank.
    """

    keys: torch.Tensor  # (V,) sorted unique raw ids, sign-flipped int64
    table: torch.Tensor  # (V+1, D) f32; the last row is the OOV vector
    index: object = None  # repro_torch.index.Index over ``keys`` (one index)
    sharded: object = None  # repro_torch.dist.ShardedIndex (n_shards > 1)
    ctx: object = None  # ShardingCtx the tier is laid out on
    cap_factor: float = 0.0  # 0 -> n_shards (the exchange can never drop)

    @staticmethod
    def build(raw_keys, dim: int, seed: int = 0, b: int | None = None, *, kind: str = "RMI",
              ctx=None, n_shards: int = 1, device=None, **params):
        """The sorted unique keys of ``raw_keys`` (uint64), a ``(V+1,
        dim)`` table drawn as the reference draws it (so the two are equal
        bit for bit), and a ``kind`` index over the keys (RMI: ``b =
        max(2, V // 128)`` unless given) on ``device`` (default: the
        card)."""
        from repro_torch import index as ix
        from repro_torch.dist.sharded_index import ShardedIndex

        dev = resolve_device(device)
        keys = sorted_unique(np.asarray(raw_keys, dtype=np.uint64))
        v = len(keys)
        rng = np.random.default_rng(seed)
        table = (rng.normal(0, 0.05, size=(v + 1, dim))).astype(np.float32)
        if kind.upper() == "RMI" and "b" not in params:
            params["b"] = b or max(2, v // 128)
        index = sharded = None
        if n_shards > 1:
            sharded = ShardedIndex.build(kind, keys, n_shards=n_shards, device=dev, **params)
        else:
            index = ix.build(kind, keys, device=dev, **params)
        return LearnedKeyedEmbedding(keys=keymod.encode(keys, dev),
                                     table=torch.from_numpy(table).to(dev), index=index,
                                     sharded=sharded, ctx=ctx)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def translate(self, raw_ids, *, backend: str = "kernel"):
        """Raw 64-bit ids (uint64 numpy or encoded int64) -> predecessor
        ranks (int64) in the sorted key set, flat."""
        qf = keymod.as_keys(raw_ids, self.device).reshape(-1)
        if self.sharded is not None:
            from repro_torch.dist.sharded_index import sharded_lookup as tier_lookup

            cap = self.cap_factor or float(self.sharded.n_shards)
            return tier_lookup(self.sharded, qf, self.ctx, backend=backend, cap_factor=cap)
        return self.index.lookup(self.keys, qf, backend=backend)

    def lookup(self, raw_ids, *, backend: str = "kernel"):
        """Raw ids of any shape -> their rows, ``raw_ids.shape + (D,)``;
        misses (no exact key, capacity drops) read the OOV row."""
        q = keymod.as_keys(raw_ids, self.device)
        qf = q.reshape(-1)
        rank = self.translate(qf, backend=backend)
        at = torch.clamp(rank, min=0)
        hit = (rank >= 0) & (self.keys[at] == qf)
        row = torch.where(hit, at, self.table.shape[0] - 1)
        return self.table[row].reshape(*q.shape, -1)
