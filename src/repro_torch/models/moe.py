"""Mixture-of-Experts block, on one card or expert-parallel over ranks
(counterpart of ``repro.models.moe``).

The reference runs the block under ``shard_map``: each model column
routes the local tokens to its own ``E / ep`` experts, FSDP-sharded
expert weights are cast to the compute dtype and all-gathered over the
dp axes a layer at a time, and a psum over the expert axis assembles the
output.  :func:`moe_ffn` under a :class:`~repro_torch.dist.sharding.ShardingCtx`
does the same with the collectives written out: ``col`` is this rank's
index along ``ep``, ``e_loc = E / n(ep)``, and the capacity comes from the
rank's ``t_loc`` tokens (so a mesh drops other pairs than one card does
on the same batch).  On one card the mesh has one column: ``ep = dp =
1``, ``col = 0``, ``e_loc = n_experts``, no all-gather and no psum, and
the ``shard_map`` body runs once on every token.

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
from repro_torch.dist import collectives


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


def expert_placement(cfg, ctx):
    """``(ep_axes, fsdp_axes)`` of the expert weights under ``ctx``: the
    mesh axes (of more than one rank) that split the expert dim and the
    ``d_model`` dim of ``wg``/``wu``/``wd`` once fitted to the whole
    shapes (``()`` where a dim stays whole)."""
    from repro_torch.dist.sharding import _entry_axes, fit_sharding, mesh_shape

    sizes = mesh_shape(ctx.mesh)
    shape = (cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    spec = fit_sharding(shape, ctx.sharding("ep", "fsdp", None), ctx.mesh).spec
    return tuple(tuple(a for a in _entry_axes(e) if sizes[a] > 1) for e in spec[:2])


def moe_ffn(x2d, moe_params, cfg, ctx=None, *, replicated_tokens: bool = False):
    """x2d: (T, d) tokens.

    moe_params: ``{'router': (d, E), 'wg', 'wu': (E, d, ffe), 'wd': (E,
    ffe, d)}``, one layer's.  Returns (T, d) in ``x2d``'s dtype.  Without
    ``ctx``: the reference's ``moe_ffn`` with one mesh column.

    Under ``ctx`` the expert weights are this rank's blocks
    (:func:`expert_placement`): cast to the compute dtype, then gathered
    over their ``fsdp`` dim; the tokens and the (replicated) router enter
    through ``copy_to`` over ``ep`` and the experts' output leaves through
    ``reduce_from``, so every rank of the ``ep`` group gets the block's
    whole output and the router's and tokens' gradients sum the columns'
    parts.  In the context's local view ``x2d`` is this rank's own tokens;
    in the global view every rank passes all ``T`` and takes its ``T /
    n(dp)`` rows (all of them with ``replicated_tokens``, for a ``T`` that
    does not divide), the outputs gathered back over ``dp``."""
    dtype = x2d.dtype
    ep = fsdp = dp = ()
    if ctx is not None:
        ep, fsdp = expert_placement(cfg, ctx)
        if not (ctx.local_batch or replicated_tokens or ctx.n("dp") == 1):
            dp = ctx.mesh_axes("dp")
    x = x2d
    if dp:
        group, i = ctx.axes_group(dp)
        t_loc = x2d.shape[0] // collectives.group_size(group)
        x = x2d[i * t_loc:(i + 1) * t_loc]
    wg = collectives.all_gather_dim(moe_params["wg"].to(dtype), fsdp, ctx, 1)
    wu = collectives.all_gather_dim(moe_params["wu"].to(dtype), fsdp, ctx, 1)
    wd = collectives.all_gather_dim(moe_params["wd"].to(dtype), fsdp, ctx, 2)
    x = collectives.copy_to(x, ep, ctx)
    router = collectives.copy_to(moe_params["router"], ep, ctx)
    xe, combine = _dispatch_local(
        x, router, e_loc=wg.shape[0], col=ctx.axes_group(ep)[1] if ep else 0,
        n_experts=cfg.n_experts, top_k=cfg.top_k, capacity=capacity_of(x.shape[0], cfg),
        dtype=dtype,
    )
    g = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    h = torch.nn.functional.silu(g) * u
    y = collectives.reduce_from(combine(torch.bmm(h, wd)), ep, ctx)
    return collectives.all_gather_dim(y, dp, ctx, 0)
