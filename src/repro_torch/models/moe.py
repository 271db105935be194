"""Mixture-of-Experts block on one card (counterpart of ``repro.models.moe``).

The reference runs the block under ``shard_map``: each model column
routes the local tokens to its own ``E / ep`` experts, FSDP-sharded
expert weights are all-gathered a layer at a time, and a psum over the
expert axis assembles the output.  On one card the mesh has one column:
``ep = dp = 1``, ``col = 0``, ``e_loc = n_experts``, no all-gather and no
psum, and the ``shard_map`` body runs once on every token.

The capacity dispatch is **sort-based**, as the reference's: flatten the
(token, k) pairs, sort them by expert id, find each expert's boundary
with the paper's branch-free predecessor search over the sorted
expert-id table (:func:`repro_torch.core.search.bfs`), then slot tokens
with gathers.  Each expert takes at most ``capacity`` pairs; the rest are
dropped and add nothing to their token's output.  Two orderings must
follow the reference's for the same pairs to drop:

* ``lax.top_k`` breaks ties toward the lower expert index and
  ``torch.topk`` promises no order, so the top k come from a stable
  descending sort (the router's logits are rounded to the compute dtype
  before the f32 softmax, so ties are real in bf16);
* ``jnp.argsort`` is stable, so the pair sort passes ``stable=True``.

The router product and the three expert products are plain products in
the reference too (outside any Pallas kernel): ``torch.bmm`` here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import search


def _top_k(probs: torch.Tensor, k: int) -> tuple:
    """``lax.top_k`` over the last axis: the ``k`` largest values of each
    row and their indices, largest first, ties toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_of(n_tokens: int, cfg) -> int:
    """Pairs an expert takes at most: the reference's
    ``ceil(T * top_k / E * capacity_factor)``, at least 1."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def _dispatch_local(x, gate_w, *, e_loc: int, col, n_experts: int, top_k: int,
                    capacity: int, dtype):
    """Route local tokens to this column's experts.

    x: (T, d) local tokens.  Returns ``(xe, combine)`` where xe: (E_loc,
    C, d) dispatched tokens and ``combine(ye) -> (T, d)``."""
    t, d = x.shape
    dev = x.device
    logits = (x @ gate_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, top_k)  # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1).to(torch.int32)  # (T*k,)
    flat_t = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(top_k)
    local = (flat_e >= col * e_loc) & (flat_e < (col + 1) * e_loc)
    # push non-local pairs to the end of the sort with a sentinel
    sort_key = torch.where(local, flat_e - col * e_loc, n_experts + 1).to(torch.int32)
    order = torch.argsort(sort_key, stable=True)
    s_key = sort_key[order]
    s_tok = flat_t[order]

    # expert boundaries via the paper's branch-free predecessor search
    eq = torch.arange(e_loc, dtype=torch.int32, device=dev)
    bounds = search.bfs(s_key, eq - 1) + 1  # first sorted pos of each local expert
    ends = search.bfs(s_key, eq) + 1

    # slot gather: expert e takes sorted positions [bounds[e], bounds[e]+C)
    slots = bounds[:, None] + torch.arange(capacity, dtype=torch.int64, device=dev)[None, :]
    valid = slots < ends[:, None]
    tok_idx = s_tok[torch.clamp(slots, max=t * top_k - 1)]
    xe = x[tok_idx.long()] * valid[..., None].to(x.dtype)  # (E_loc, C, d)

    # combine indices: position of each (t, k) pair within its expert
    pos_sorted = (torch.arange(t * top_k, dtype=torch.int64, device=dev)
                  - bounds[torch.clamp(s_key, 0, e_loc - 1).long()])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), dtype=order.dtype, device=dev)
    pos = pos_sorted[inv]  # (T*k,) position-in-expert
    keep = local & (pos < capacity)
    le = torch.clamp(flat_e - col * e_loc, 0, e_loc - 1).long()

    def combine(ye):  # ye: (E_loc, C, d)
        flat_pos = torch.clamp(pos, 0, capacity - 1)
        vecs = ye[le, flat_pos]  # (T*k, d) gather
        w = (top_p.reshape(-1).to(ye.dtype) * keep.to(ye.dtype))[:, None]
        return (vecs * w).reshape(t, top_k, d).sum(dim=1)

    return xe, combine


def moe_ffn(x2d, moe_params, cfg):
    """x2d: (T, d) tokens on one card.

    moe_params: ``{'router': (d, E), 'wg', 'wu': (E, d, ffe), 'wd': (E,
    ffe, d)}``, one layer's.  Returns (T, d) in ``x2d``'s dtype: the
    reference's ``moe_ffn`` with one mesh column."""
    dtype = x2d.dtype
    xe, combine = _dispatch_local(
        x2d, moe_params["router"], e_loc=cfg.n_experts, col=0, n_experts=cfg.n_experts,
        top_k=cfg.top_k, capacity=capacity_of(x2d.shape[0], cfg), dtype=dtype,
    )
    g = torch.bmm(xe, moe_params["wg"].to(dtype))
    u = torch.bmm(xe, moe_params["wu"].to(dtype))
    h = torch.nn.functional.silu(g) * u
    ye = torch.bmm(h, moe_params["wd"].to(dtype))
    return combine(ye)
