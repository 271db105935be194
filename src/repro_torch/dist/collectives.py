"""Cross-rank collective helpers on ``torch.distributed`` (counterpart of
``repro.dist.collectives``).

* Owner-exchange bucketing (:func:`exchange_capacity`,
  :func:`bucket_by_owner`, :func:`unbucket_inverse`): the
  capacity-factored ``(n_shards, cap)`` request matrix that an
  all-to-all exchange sends, and the scatter of the replies back to
  input order.  :func:`all_to_all` is the exchange itself: row ``j``
  goes to group rank ``j``, and the rows received are stacked by source
  rank (``lax.all_to_all(..., tiled=True)`` on axis 0).
* psum helpers: ``all_reduce`` over the group of some mesh dims of a
  :class:`~repro_torch.dist.sharding.ShardingCtx`, a no-op when there
  are no dims, so step code stays mesh-shape agnostic.
* :func:`all_gather` and :func:`reduce_scatter` (along dim 0, in the
  tensor's own dtype), and :func:`all_gather_dim` along any dim over the
  group of some mesh dims (the FSDP gather of a stacked weight's dim 1
  or 2), whose backward reduce-scatters along that dim.
* The tensor-parallel pair (Megatron's ``f``/``g``): :func:`copy_to`
  (identity forward, psum backward) at the entry to a column-parallel
  product, and :func:`reduce_from` (psum forward, identity backward) after
  a row-parallel one.  :func:`psum_if_mapped` sums in both directions:
  after a row-parallel product whose result feeds a loss that every rank
  of the group computes alike it would hand each rank ``n`` times the
  gradient, so the placed LM uses the pair.

The exchanges are differentiable, so gradients cross ranks as the
reference's ``shard_map`` collectives carry them: an all-to-all's
backward is the reverse all-to-all, a psum's backward is the psum of the
ranks' gradients (each rank's downstream may differ), an all-gather's
backward is a reduce-scatter in the same dtype (and a reduce-scatter's an
all-gather).  On a gloo group the
reduce-scatter is an all-reduce and this rank's block of it (gloo has no
reduce-scatter); gloo carries CUDA tensors through the host.  On the dry
run's abstract mesh (a :class:`~repro_torch.dist.sharding.CountingGroup`)
each helper returns a tensor of the right shape and records the bytes
the rank would move.

* Error-feedback gradient compression (:func:`compressed_grad_leaf`,
  :func:`apply_grad_compression`): each leaf sent as bf16 or as int8 with
  one f32 scale, the rounding error carried to the next step.

The port sets no XLA or NCCL flags: the reference's ``OVERLAP_XLA_FLAGS``
are TPU flags (``launch.train --print-xla-flags`` says so).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree

# ---------------------------------------------------------------------------
# Owner-exchange bucketing (the all_to_all request-matrix pattern)
# ---------------------------------------------------------------------------


def exchange_capacity(n_local: int, n_shards: int, cap_factor: float) -> int:
    """Slots per (source, owner) pair: ``ceil(cap_factor * n / shards)``,
    at least 1 (the reference's float arithmetic).  ``cap_factor >=
    n_shards`` can never drop."""
    return max(1, int(-(-cap_factor * n_local // n_shards)))


def bucket_by_owner(owner, values, n_shards: int, cap: int, fill):
    """Bucket ``values`` (``(n, ...)``) into a capacity-bounded
    ``(n_shards, cap, ...)`` request matrix by ``owner``.

    A stable sort by owner (``jnp.argsort`` is stable; ``torch.argsort``
    only when asked), each owner's bucket bounds by a search of the sorted
    owners, and the first ``cap`` entries of each owner laid into its row;
    over-capacity slots hold ``fill`` and ``valid=False``.

    Returns ``(req, slots, valid, order)``: the request matrix, each slot's
    position in the sorted order, the in-capacity mask and the sort
    permutation (pass them to :func:`unbucket_inverse`).
    """
    n = values.shape[0]
    order = torch.argsort(owner, stable=True)
    s_owner = owner[order].long()
    s_val = values[order]
    shard_q = torch.arange(n_shards, dtype=torch.int64, device=values.device)
    # count of sorted owners <= q: the reference's bfs(s_owner, q) + 1
    starts = torch.searchsorted(s_owner, shard_q - 1, right=True)
    ends = torch.searchsorted(s_owner, shard_q, right=True)
    slots = starts[:, None] + torch.arange(cap, dtype=torch.int64, device=values.device)[None, :]
    valid = slots < ends[:, None]
    if n == 0:
        req = torch.full((n_shards, cap) + tuple(values.shape[1:]), fill, dtype=values.dtype,
                         device=values.device)
        return req, slots, valid, order
    picked = s_val[torch.clamp(slots, max=n - 1)]
    mask = valid.reshape(valid.shape + (1,) * (values.dim() - 1))
    req = torch.where(mask, picked, torch.as_tensor(fill, dtype=values.dtype, device=values.device))
    return req, slots, valid, order


def unbucket_inverse(replies, slots, valid, order, n: int, init):
    """Scatter ``(n_shards, cap, ...)`` replies back to input order.

    Entries never sent (``valid=False``) keep ``init``: callers encode
    their drop policy there (sentinel rank, zero vector, ...).  The
    reference's ``.at[...].set(mode="drop")`` drops index ``n``; here the
    scatter goes into ``n + 1`` rows and the last is cut."""
    tail = tuple(replies.shape[2:])
    out_sorted = torch.full((n + 1,) + tail, init, dtype=replies.dtype, device=replies.device)
    scatter_at = torch.where(valid.reshape(-1), slots.reshape(-1), n)
    out_sorted[scatter_at] = replies.reshape((-1,) + tail)
    return out_sorted[:n][torch.argsort(order)]


def _counting(group) -> bool:
    from repro_torch.dist.sharding import CountingGroup

    return isinstance(group, CountingGroup)


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def group_size(group) -> int:
    """The number of ranks of a process group (or of a dry run's
    :class:`~repro_torch.dist.sharding.CountingGroup`)."""
    return group.size if _counting(group) else dist.get_world_size(group)


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    if _counting(group):
        group.ledger.add("all-to-all", _nbytes(out))
        return out
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone()
    if _counting(group):
        group.ledger.add("all-reduce", 2 * _nbytes(out))
        return out
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x, group, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in group rank order."""
    x = x.contiguous()
    n = group_size(group)
    if _counting(group):
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_empty(shape)
        group.ledger.add("all-gather", _nbytes(out))
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _reduce_scatter(x, group):
    """This rank's block (along dim 0) of the sum of every rank's ``x``."""
    x = x.contiguous()
    n = group_size(group)
    rows = x.shape[0] // n
    if _counting(group):
        group.ledger.add("reduce-scatter", _nbytes(x))
        return x.new_empty((rows,) + tuple(x.shape[1:]))
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    me = dist.get_rank(group)
    return _all_reduce(x, group)[me * rows:(me + 1) * rows]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


def _scatter_along(x, group, dim: int):
    """This rank's block along ``dim`` of the sum of every rank's ``x``."""
    if dim == 0:
        return _reduce_scatter(x, group)
    return _reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_along(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_to_all(x, group):
    """Exchange the rows of ``x`` (``(n_ranks, ...)``): row ``j`` goes to
    group rank ``j``, and row ``i`` of the result came from group rank
    ``i``.  One ``all_to_all_single`` with equal splits; its backward is
    the reverse exchange."""
    return _AllToAll.apply(x, group)


def all_gather(x, group):
    """Every rank's ``x`` stacked along dim 0, in group rank order, in
    ``x``'s dtype; the backward is a reduce-scatter of the gradient in
    that dtype (each rank gets the sum of the ranks' gradients of its
    block)."""
    return _AllGather.apply(x, group, 0)


def reduce_scatter(x, group):
    """This rank's block (along dim 0, in group rank order) of the sum of
    every rank's ``x``; the backward all-gathers the gradient."""
    return _ReduceScatter.apply(x, group)


# ---------------------------------------------------------------------------
# psum helpers
# ---------------------------------------------------------------------------


def psum_if_mapped(x, axes, ctx=None):
    """The sum of ``x`` over the group of the mesh dims ``axes`` of
    ``ctx`` (a new tensor); ``x`` itself when ``axes`` is empty/None.  Its
    backward sums the ranks' gradients over the same group."""
    axes = tuple(axes or ())
    if not axes:
        return x
    return _PSum.apply(x, ctx.axes_group(axes)[0])


def pmean_if_mapped(x, axes, ctx=None):
    """The mean of ``x`` over the group of the mesh dims ``axes`` of
    ``ctx``; ``x`` itself when ``axes`` is empty/None."""
    axes = tuple(axes or ())
    if not axes:
        return x
    return psum_if_mapped(x, axes, ctx) / group_size(ctx.axes_group(axes)[0])


def psum_tree(t, axes, ctx=None):
    """:func:`psum_if_mapped` of every tensor leaf of a nest of dicts,
    lists and tuples (a gradient all-reduce)."""
    axes = tuple(axes or ())
    if not axes:
        return t
    return tree.tree_map(lambda leaf: psum_if_mapped(leaf, axes, ctx), t)


def all_gather_dim(x, axes, ctx, dim: int):
    """Every rank's ``x`` over the group of the mesh dims ``axes`` of
    ``ctx``, concatenated along ``dim`` in the order of the flattened axis
    (a tiled all-gather, in ``x``'s dtype); ``x`` itself when ``axes`` is
    empty.  The backward reduce-scatters the gradient along ``dim``: each
    rank gets the sum over the group of its block's gradients."""
    axes = tuple(axes or ())
    if not axes:
        return x
    return _AllGather.apply(x, ctx.axes_group(axes)[0], dim)


def copy_to(x, axes, ctx):
    """``x`` as it is, entering a region whose ranks over ``axes`` each
    compute a part (a column-parallel product, this rank's experts): the
    backward sums the parts' gradients over the group.  ``x`` itself when
    ``axes`` is empty."""
    axes = tuple(axes or ())
    if not axes:
        return x
    return _CopyTo.apply(x, ctx.axes_group(axes)[0])


def reduce_from(x, axes, ctx):
    """The sum over the group of ``axes`` of each rank's part, leaving the
    region :func:`copy_to` entered: every rank gets the whole, and its
    gradient passes back unchanged (each rank's downstream computes the
    same).  ``x`` itself when ``axes`` is empty."""
    axes = tuple(axes or ())
    if not axes:
        return x
    return _ReduceFrom.apply(x, ctx.axes_group(axes)[0])


def max_if_mapped(x, axes, ctx=None):
    """The elementwise max of ``x`` over the group of the mesh dims
    ``axes`` of ``ctx`` (no gradient); ``x`` itself when there are none."""
    axes = tuple(axes or ())
    if not axes:
        return x
    return _all_reduce(x, ctx.axes_group(axes)[0], op=dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# Error-feedback gradient compression
# ---------------------------------------------------------------------------

METHODS = ("bf16", "int8")


def compressed_grad_leaf(g, err, method: str, reduce_max=None):
    """Compress one gradient leaf with error feedback.

    Returns ``(g_hat, new_err)``: ``g_hat`` the decompressed (wire-format)
    gradient in f32 and ``new_err = (g + err) - g_hat``, carried to the
    next step, so the accumulated compressed gradients track the
    accumulated true ones within one step's rounding.  ``bf16`` rounds to
    nearest even; ``int8`` scales by ``max(max|x|, 1e-30) / 127`` and
    rounds half to even (``torch.round``, as ``jnp.round``).

    Bit-equal to the reference as XLA compiles it: XLA folds ``/ 127.0``
    into a product with the f32 reciprocal, and fuses ``x - g_hat`` into
    one multiply-subtract against the unrounded ``round(x / scale) *
    scale``.  The port takes the same scale and forms that residual
    exactly in f64 (a 7-bit integer times an f32 fits in 53 bits) before
    its one rounding to f32.

    ``reduce_max`` (int8) takes this rank's ``max|x|`` to the leaf's:
    a leaf whose rows are spread over ranks scales by the max over all of
    them, as the reference's global array does."""
    x = g.to(torch.float32) + err
    if method == "bf16":
        g_hat = x.to(torch.bfloat16).to(torch.float32)
        return g_hat, x - g_hat
    if method == "int8":
        amax = torch.max(torch.abs(x))
        if reduce_max is not None:
            amax = reduce_max(amax)
        scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
        k = torch.round(x / scale)
        return k * scale, (x.double() - k.double() * scale.double()).to(torch.float32)
    raise ValueError(f"unknown grad compression {method!r}; choose from {METHODS}")


def apply_grad_compression(grads, errs, method: str, reduce_max=None):
    """:func:`compressed_grad_leaf` leaf by leaf over a nest of dicts,
    lists and tuples and the matching nest of errors (``reduce_max``: one
    entry a leaf, or None).  Returns ``(grads_hat, new_errs)``, both in
    ``grads``' structure."""
    leaves = tree.leaves(grads)
    maxes = reduce_max or [None] * len(leaves)
    pairs = [compressed_grad_leaf(g, e, method, r)
             for g, e, r in zip(leaves, tree.flatten_up_to(grads, errs), maxes)]
    return (tree.unflatten(grads, [p[0] for p in pairs]),
            tree.unflatten(grads, [p[1] for p in pairs]))
