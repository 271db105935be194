"""Plain oracles for the kernels (counterpart of ``repro.kernels.ref``),
and the row loop the batched twins share."""

from __future__ import annotations

import torch


def predecessor_ref(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Predecessor rank of each query over encoded (sign-flipped int64)
    keys: ``searchsorted(right=True) - 1`` as int64."""
    return torch.searchsorted(table, queries, right=True) - 1


def rows_with_probes(tables: torch.Tensor, probes, row_fn):
    """Run a single-table twin once per table row (``row_fn(t, probes)``)
    and stack the ranks.  ``probes``, when a list, receives every table
    index gathered, as an index into ``tables.reshape(-1)``."""
    n = tables.shape[1]
    out = []
    for t in range(tables.shape[0]):
        mine = [] if probes is not None else None
        out.append(row_fn(t, mine))
        if probes is not None:
            probes.extend(p + t * n for p in mine)
    return torch.stack(out) if out else torch.empty((0, 0), dtype=torch.int32)


def embedding_bag_ref(table, ids, seg_ids, weights, num_bags: int) -> torch.Tensor:
    """EmbeddingBag oracle: ``out[b] = sum_i [seg_ids[i] == b] w[i] *
    table[ids[i]]``, as gather then segment sum.  As in the reference
    (``jnp.take`` fills), an id outside ``[0, V)`` gathers a NaN row; a
    segment id outside ``[0, num_bags)`` is dropped."""
    v, d = table.shape
    ids, seg = ids.long(), seg_ids.long()
    inside = (ids >= 0) & (ids < v)
    rows = table[torch.where(inside, ids, 0)] if v else table.new_zeros((ids.numel(), d))
    rows = torch.where(inside[:, None], rows, torch.full_like(rows, float("nan")))
    gathered = rows * weights[:, None]
    keep = (seg >= 0) & (seg < num_bags)
    out = torch.zeros((num_bags, d), dtype=gathered.dtype, device=table.device)
    return out.index_add_(0, seg[keep], gathered[keep])


def decode_attention_ref(q, k, v, kv_len) -> torch.Tensor:
    """Single-token GQA decode attention oracle: q (B, Hq, D), k/v (B, S,
    Hkv, D), kv_len (B,) valid lengths.  Masked logits are -inf, so a row
    with ``kv_len = 0`` gives NaN, as in the reference."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=2)
    vv = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q, kk) / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
    mask = torch.arange(s, device=q.device)[None, None, :] < kv_len.long()[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, float("-inf")))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(logits, dim=-1), vv)
