"""Decoder-only LM (dense GQA and MoE variants): training and serving
(counterpart of ``repro.models.transformer``).

Parameters are a plain dict that mirrors the reference's pytree: the
per-layer leaves are stacked on a leading layer axis, and every weight
keeps the reference's ``(in, out)`` layout, so ``h @ w`` is the
reference's product and :func:`params_from_numpy` carries the reference's
weights across unchanged.

Entry points:
  init(gen, cfg, ctx=None)                        -> params (this rank's blocks under ctx)
  forward(params, tokens, cfg, ctx=None)          -> final hidden states
  loss_fn(params, batch, cfg, ctx=None)           -> scalar next-token loss
  init_cache(cfg, batch, max_seq, ctx=None)       -> KV cache dict (a rank's block under ctx)
  decode_step(params, cache, tokens, pos, cfg, ctx=None) -> (logits, cache)
  params_from_numpy(np_params, cfg)               -> params
  param_logical_axes(cfg) / cache_logical_axes()  -> logical placement trees

Each runs on the card unless given a CPU generator or ``device="cpu"``.
A config with ``moe=True`` routes each layer's FFN through
:func:`repro_torch.models.moe.moe_ffn` (plus the shared expert's SwiGLU
when ``n_shared`` is set).

Under a :class:`~repro_torch.dist.sharding.ShardingCtx` whose ``tp``,
``fsdp`` or ``ep`` axes hold more than one rank, the parameters are placed
as the reference places them (:func:`placement`: ``param_logical_axes``
through ``fit_sharding``; a dim its axes do not divide stays whole) and a
rank holds only its blocks.  ``forward``/``loss_fn`` then follow the
reference's ``transformer.py:162-262`` with the collectives written out:
each ``w*``/``b*`` block is cast to the compute dtype and then
all-gathered over its ``fsdp`` dim (so the ranks move bf16; the backward
reduce-scatters); ``wq``/``wk``/``wv``/``wg``/``wu`` are column-parallel and
``wo``/``wd`` row-parallel over ``tp``, between
:func:`~repro_torch.dist.collectives.copy_to` and
:func:`~repro_torch.models.layers.row_parallel` (the partials summed in
f32 and rounded once, as the one-card product is); a rank attends with its
own heads (all heads, its slice of the output taken, when ``n_heads``
does not divide), with K/V gathered whole and each local head's KV head
picked when ``n_kv_heads`` does not divide (the reference's replicated
K/V); the embedding is vocabulary-parallel (the ``fsdp`` columns gathered,
a masked gather of the local rows, a sum over ``tp``) and so is the loss
(:func:`~repro_torch.models.layers.vocab_parallel_xent` over the ``tp``
columns of ``head``).  A block whose shape is not this rank's (a whole
replica under a placed context) raises.  Without a context, or on a mesh
of one rank, they compute exactly what the one-card model computes.

Serving under such a context (or one whose rules split only the cache):
``decode_step`` runs on each rank's parameter and cache blocks, the cache
placed as the reference places it (:func:`cache_placement`: batch on
``dp``, sequence on ``seqm``, or on ``sp`` for ``long_500k``), each
rank's sequence block attended by the kernel with its log-sum-exp and the
blocks combined over ranks; one body serves one card and the ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.dist import collectives

from . import layers as L
from .moe import moe_ffn


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # numerics / scheduling
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    q_chunk: int = 1024
    xent_chunk: int = 512
    remat: bool = True

    @property
    def params_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe:
            ffn = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            ffn += self.n_shared * 3 * d * self.d_ff_expert
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def active_params_count(self) -> int:
        if not self.moe:
            return self.params_count
        d = self.d_model
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ffn = (self.top_k + self.n_shared) * 3 * d * self.d_ff_expert + d * self.n_experts
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def _param_specs(cfg: LMConfig) -> list:
    """``(path, shape, how)`` of every parameter leaf, in the order
    :func:`init` draws them (``how``: ``ones``, ``zeros``, ``dense`` or
    ``embed``)."""
    d, hd, n = cfg.d_model, cfg.head_dim, cfg.n_layers
    out = [(("layers", "ln1"), (n, d), "ones"), (("layers", "ln2"), (n, d), "ones"),
           (("layers", "wq"), (n, d, cfg.n_heads * hd), "dense"),
           (("layers", "wk"), (n, d, cfg.n_kv_heads * hd), "dense"),
           (("layers", "wv"), (n, d, cfg.n_kv_heads * hd), "dense"),
           (("layers", "wo"), (n, cfg.n_heads * hd, d), "dense")]
    if cfg.qkv_bias:
        out += [(("layers", "bq"), (n, cfg.n_heads * hd), "zeros"),
                (("layers", "bk"), (n, cfg.n_kv_heads * hd), "zeros"),
                (("layers", "bv"), (n, cfg.n_kv_heads * hd), "zeros")]
    if cfg.moe:
        e, ffe = cfg.n_experts, cfg.d_ff_expert
        out += [(("layers", "moe", "router"), (n, d, e), "dense"),
                (("layers", "moe", "wg"), (n, e, d, ffe), "dense"),
                (("layers", "moe", "wu"), (n, e, d, ffe), "dense"),
                (("layers", "moe", "wd"), (n, e, ffe, d), "dense")]
        ff = cfg.n_shared * ffe  # the shared expert, when there is one
    else:
        ff = cfg.d_ff
    if ff:
        out += [(("layers", "wg"), (n, d, ff), "dense"), (("layers", "wu"), (n, d, ff), "dense"),
                (("layers", "wd"), (n, ff, d), "dense")]
    return out + [(("embed",), (cfg.vocab, d), "embed"), (("ln_f",), (d,), "ones"),
                  (("head",), (d, cfg.vocab), "dense")]


def _put(t: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        t = t.setdefault(k, {})
    t[path[-1]] = leaf


def param_shapes(cfg: LMConfig) -> dict:
    """The whole shape of every parameter leaf, in the parameters' nest."""
    out = {}
    for path, shape, _ in _param_specs(cfg):
        _put(out, path, shape)
    return out


def param_template(cfg: LMConfig) -> dict:
    """The parameters as meta tensors of their whole shapes and
    ``param_dtype`` (for ``init_train_state`` of a whole-state template)."""
    pd = L.dtype_of(cfg.param_dtype)
    out = {}
    for path, shape, _ in _param_specs(cfg):
        _put(out, path, torch.empty(shape, dtype=pd, device="meta"))
    return out


def init(gen: torch.Generator, cfg: LMConfig, ctx=None):
    """Random parameters drawn from ``gen`` on its device (a CUDA generator
    for the card, ``torch.Generator()`` for the CPU).  The reference's
    ``jax.random`` draws cannot be reproduced; carry its weights across
    with :func:`params_from_numpy` instead.  Each stacked tensor is drawn
    a layer at a time into its ``param_dtype`` storage, so a bf16 model
    at full width never holds an f32 copy of a whole stack.

    Under a placed ``ctx`` (:func:`placement`) each leaf is drawn whole,
    this rank's block kept (a copy) and the rest freed before the next
    leaf: the same draws, so the blocks are ``shard_state`` of the whole
    parameters drawn from the same seed."""
    pd = L.dtype_of(cfg.param_dtype)
    dev = gen.device
    plan = placement(cfg, ctx)
    coord = ctx.coordinate() if plan is not None else None
    out = {}
    for path, shape, how in _param_specs(cfg):
        if how == "ones":
            leaf = torch.ones(shape, dtype=pd, device=dev)
        elif how == "zeros":
            leaf = torch.zeros(shape, dtype=pd, device=dev)
        elif how == "dense":
            leaf = L.dense_init(gen, shape, pd)
        else:
            leaf = L.embed_init(gen, shape, pd)
        if plan is not None:
            node = plan
            for k in path:
                node = node[k]
            leaf = node.sharding.local_block(leaf, coord).clone()
        _put(out, path, leaf)
    return out


def params_from_numpy(np_params, cfg: LMConfig, device=None):
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, repro_params)``) as tensors on ``device``
    (the card when None), in the same layout and dtype; the nested
    ``layers["moe"]`` dict of an MoE config comes across as a dict."""
    return tree.tree_from_numpy(np_params, resolve_device(device))


def cast_params(params, dtype: torch.dtype):
    """Every leaf in ``dtype``: the compute copy the reference makes with
    ``astype(dt)`` inside each step, made once."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


def param_logical_axes(cfg: LMConfig):
    """Logical sharding axes per parameter leaf (stacked layer dim first),
    as the reference's: resolved by ``ShardingCtx.sharding`` and fitted
    (:func:`placement`) they place the leaves."""
    lay = {
        "ln1": (None, None),
        "ln2": (None, None),
        "wq": (None, "fsdp", "tp"),
        "wk": (None, "fsdp", "tp"),
        "wv": (None, "fsdp", "tp"),
        "wo": (None, "tp", "fsdp"),
        "wg": (None, "fsdp", "tp"),
        "wu": (None, "fsdp", "tp"),
        "wd": (None, "tp", "fsdp"),
    }
    if cfg.qkv_bias:
        lay.update({"bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp")})
    if cfg.moe:
        lay["moe"] = {
            "router": (None, None, None),
            "wg": (None, "ep", "fsdp", None),
            "wu": (None, "ep", "fsdp", None),
            "wd": (None, "ep", None, "fsdp"),
        }
    return {"embed": ("tp", "fsdp"), "layers": lay, "ln_f": (None,), "head": ("fsdp", "tp")}


def cache_logical_axes(seq_shard: bool = False):
    """Logical axes of the KV cache's ``k``/``v`` (layers, batch, sequence,
    KV heads, head dim), as the reference's: batch on ``dp`` and the
    sequence on ``seqm`` (decode_32k), or the sequence on ``sp``
    (long_500k, batch 1).  ``seqm``/``sp`` have no rule in either
    profile, so they resolve to no mesh axis."""
    if seq_shard:
        return {"k": (None, None, "sp", None, None), "v": (None, None, "sp", None, None)}
    return {"k": (None, "dp", "seqm", None, None), "v": (None, "dp", "seqm", None, None)}


@dataclass(frozen=True)
class Placed:
    """One placed parameter leaf: its fitted ``sharding``, its whole
    ``shape``, this rank's ``block`` shape and, per dim, the logical axis
    and the mesh axes of more than one rank that split it."""

    sharding: object
    shape: tuple
    block: tuple
    dims: tuple

    @classmethod
    def of(cls, sharding, shape, logical, sizes) -> "Placed":
        dims = tuple((lg, tuple(a for a in (e if isinstance(e, tuple) else (e,))
                                if e is not None and sizes[a] > 1))
                     for lg, e in zip(logical, sharding.spec))
        return cls(sharding, tuple(shape), tuple(sharding.shard_shape(tuple(shape))), dims)

    def axes(self, i: int, logical: str | None = None) -> tuple:
        """The mesh axes splitting dim ``i`` (``()`` when whole, or when
        its logical axis is not ``logical``)."""
        lg, axes = self.dims[i]
        return axes if logical is None or lg == logical else ()

    def layer(self) -> "Placed":
        """This leaf's placement with the stacked layer dim dropped."""
        return replace(self, shape=self.shape[1:], block=self.block[1:], dims=self.dims[1:])


def placement(cfg: LMConfig, ctx):
    """The placement of each parameter leaf under ``ctx`` (a nest of
    :class:`Placed` like the parameters'), or None when nothing is split
    (no context, or every axis of one rank): ``param_logical_axes``
    resolved by ``ctx`` and fitted to the whole shapes by
    ``dist.sharding.fit_sharding``, as the reference's
    ``fit_tree(state_shardings)`` places them."""
    if ctx is None:
        return None
    from repro_torch.dist.sharding import fit_sharding, mesh_shape

    sizes = mesh_shape(ctx.mesh)
    logical = param_logical_axes(cfg)
    out, split = {}, False
    for path, shape, _ in _param_specs(cfg):
        lg = logical
        for k in path:
            lg = lg[k]
        leaf = Placed.of(fit_sharding(shape, ctx.sharding(*lg), ctx.mesh), shape, lg, sizes)
        split = split or any(axes for _, axes in leaf.dims)
        _put(out, path, leaf)
    return out if split else None


def check_blocks(params, plan) -> None:
    """Every leaf of ``params`` has this rank's block shape under ``plan``:
    a whole copy of a split leaf (or any other shape) raises."""
    paths, leaves = tree.flatten_with_paths(params)
    for p, t, want in zip(paths, leaves, tree.flatten_up_to(params, plan)):
        if tuple(t.shape) != want.block:
            raise ValueError(f"parameter {p} has shape {tuple(t.shape)}, not this rank's block "
                             f"{want.block} of {want.shape} under {want.sharding.spec}: a placed "
                             "context runs on each rank's blocks (dist.sharding.shard_state)")


def _layer_plan(plan):
    return {k: ({e: w.layer() for e, w in v.items()} if k == "moe" else v.layer())
            for k, v in plan["layers"].items()}


def _attention_tp(h, lp, cfg: LMConfig, cos, sin, ctx, plan, att):
    """This rank's part of the attention output, before ``wo``'s row block:
    ``(B, S, hq * hd / n)`` over the ``n`` ranks of ``att`` (the ``tp`` axes
    of ``wo``'s rows, which split ``wq``'s columns alike)."""
    b, s, _ = h.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    group, r = ctx.axes_group(att)
    n = collectives.group_size(group)
    kv_axes = plan["wk"].axes(1)
    heads = hq % n == 0  # each rank its own heads; else all heads, its output slice
    kv_split = heads and hkv % n == 0 and kv_axes == att
    h = collectives.copy_to(h, att, ctx)
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if not heads:
        q = collectives.all_gather_dim(q, att, ctx, 2)
    if not kv_split:  # K/V whole on every rank (the reference's replicated K/V)
        k = collectives.all_gather_dim(k, kv_axes, ctx, 2)
        v = collectives.all_gather_dim(v, kv_axes, ctx, 2)
    hq_loc = hq // n if heads else hq
    hkv_loc = hkv // n if kv_split else hkv
    q = L.apply_rope(q.reshape(b, s, hq_loc, hd), cos, sin)
    k = L.apply_rope(k.reshape(b, s, hkv_loc, hd), cos, sin)
    v = v.reshape(b, s, hkv_loc, hd)
    if heads and not kv_split:  # the one KV head this rank's query heads share
        per = hq // hkv
        if per % hq_loc:
            raise NotImplementedError(f"{hq} query heads over {n} ranks and {hkv} KV heads: a "
                                      "rank's query heads would read several KV heads unevenly")
        kv = r * hq_loc // per
        k, v = k[:, :, kv:kv + 1], v[:, :, kv:kv + 1]
    o = L.causal_attention(q, k, v, q_chunk=cfg.q_chunk).reshape(b, s, hq_loc * hd)
    if not heads:
        cols = hq * hd // n
        o = o[..., r * cols:(r + 1) * cols]
    return o


def _layer_weights(lp, dt, ctx, plan):
    """One layer's leaves with each ``w*``/``b*`` cast to ``dt`` and, under
    a ``plan``, FSDP-gathered after the cast; and the ``tp`` axes of
    ``wo``'s and ``wd``'s rows (``()`` without a plan)."""
    lp = {k: (v.to(dt) if k.startswith(("w", "b")) else v) for k, v in lp.items()}
    att = ffn = ()
    if plan is not None:
        for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):  # FSDP: cast (above), then gathered
            if k in lp:
                i = next(i for i, (lg, _) in enumerate(plan[k].dims) if lg == "fsdp")
                lp[k] = collectives.all_gather_dim(lp[k], plan[k].axes(i), ctx, i)
        att = plan["wo"].axes(0)
        ffn = plan["wd"].axes(0) if "wd" in plan else ()
    return lp, att, ffn


def _layer_body(x, lp, cfg: LMConfig, cos, sin, ctx=None, plan=None):
    """One layer over the whole sequence: x (B, S, d) in the compute dtype;
    ``lp`` one layer's leaves.  The reference casts the ``w*``/``b*``
    leaves to the compute dtype up front (its MoE leaves inside
    ``moe_ffn``).  ``plan``: the layer's :class:`Placed` leaves under a
    placed ``ctx`` (module docstring)."""
    b, s, d = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    lp, att, ffn = _layer_weights(lp, x.dtype, ctx, plan)
    h = L.rms_norm(x, lp["ln1"])
    if att:
        o = _attention_tp(h, lp, cfg, cos, sin, ctx, plan, att)
        x = x + L.row_parallel(o, lp["wo"], att, ctx)
    else:
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = L.apply_rope(q.reshape(b, s, hq, hd), cos, sin)
        k = L.apply_rope(k.reshape(b, s, hkv, hd), cos, sin)
        o = L.causal_attention(q, k, v.reshape(b, s, hkv, hd), q_chunk=cfg.q_chunk)
        x = x + o.reshape(b, s, hq * hd) @ lp["wo"]
    h = L.rms_norm(x, lp["ln2"])
    if cfg.moe:
        rep = ctx is not None and not ctx.local_batch and (b * s) % ctx.n("dp") != 0
        y = moe_ffn(h.reshape(b * s, d), lp["moe"], cfg, ctx,
                    replicated_tokens=rep).reshape(b, s, d)
        if cfg.n_shared:
            y = y + L.swiglu(h, lp["wg"], lp["wu"], lp["wd"], ctx=ctx, axes=ffn)
    else:
        y = L.swiglu(h, lp["wg"], lp["wu"], lp["wd"], ctx=ctx, axes=ffn)
    return x + y


def _embed(params, tokens, cfg: LMConfig, ctx, plan):
    """The embedding rows of ``tokens`` in the compute dtype; under a plan,
    vocabulary-parallel: the block cast, its ``fsdp`` columns gathered, a
    masked gather of this rank's rows, the sum over ``tp``.  The gathered
    table is held in f32 for the row gather, so the gradients of a token's
    repeats sum in f32 as the one-card gather's do (the values are the
    compute dtype's either way)."""
    dt = L.dtype_of(cfg.dtype)
    if plan is None:
        return params["embed"][tokens.long()].to(dt)
    pe = plan["embed"]
    tbl = collectives.all_gather_dim(params["embed"].to(dt), pe.axes(1, "fsdp"), ctx, 1).float()
    tp = pe.axes(0, "tp")
    if not tp:
        return tbl[tokens.long()].to(dt)
    rows = tbl.shape[0]
    ids = tokens.long() - ctx.axes_group(tp)[1] * rows
    mine = (ids >= 0) & (ids < rows)
    x = tbl[torch.clamp(ids, 0, rows - 1)] * mine[..., None].to(tbl.dtype)
    return collectives.reduce_from(x.to(dt), tp, ctx)


def forward(params, tokens, cfg: LMConfig, ctx=None):
    """tokens (B, S) int -> final hidden states (B, S, d) in the compute
    dtype: the reference's full-sequence pass (embed, the layers with RoPE
    over positions ``0..S-1`` and :func:`~repro_torch.models.layers.causal_attention`
    in chunks of ``cfg.q_chunk`` query rows, ``ln_f``).  An MoE layer runs
    :func:`~repro_torch.models.moe.moe_ffn` over the ``B * S`` rows, its
    capacity set by that count, plus the shared expert.

    With ``cfg.remat`` and grad enabled each layer body is checkpointed
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint(body)``: only a layer's input is kept, the body runs
    again in the backward pass (its FSDP gathers too).  The stacked
    leaves are unbound once, so their gradient is one stack of the
    per-layer gradients.  Under a placed ``ctx`` the parameters are this
    rank's blocks and ``tokens`` the rows the context's view gives it
    (module docstring)."""
    plan = placement(cfg, ctx)
    if plan is not None:
        check_blocks(params, plan)
    lplan = None if plan is None else _layer_plan(plan)
    dev = params["embed"].device
    per_layer = {k: ({e: w.unbind(0) for e, w in v.items()} if k == "moe" else v.unbind(0))
                 for k, v in params["layers"].items()}
    x = _embed(params, tokens, cfg, ctx, plan)
    cos, sin = L.rope_tables(tokens.shape[1], cfg.head_dim, cfg.rope_theta, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    extra = () if plan is None else (ctx, lplan)
    for i in range(cfg.n_layers):
        lp = {k: ({e: w[i] for e, w in v.items()} if k == "moe" else v[i])
              for k, v in per_layer.items()}
        if remat:
            x = checkpoint(_layer_body, x, lp, cfg, cos, sin, *extra, use_reentrant=False)
        else:
            x = _layer_body(x, lp, cfg, cos, sin, *extra)
    return L.rms_norm(x, params["ln_f"])


def _xent_chunk(xc, lc, head):
    """Summed ``logsumexp - gold`` of one chunk: ``(B, chunk, d) @ head``
    in the compute dtype, the logits cast to f32."""
    logits = (xc @ head.to(xc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def _xent_chunk_tp(xc, lc, head, ctx, axes):
    """:func:`_xent_chunk` on this rank's vocabulary columns of ``head``."""
    logits = (xc @ head.to(xc.dtype)).float()
    return torch.sum(L.vocab_parallel_xent(logits, lc, ctx, axes))


def head_block(params, cfg: LMConfig, ctx, plan, dtype):
    """``head`` cast to ``dtype`` with its ``fsdp`` rows gathered: the whole
    head, or this rank's ``tp`` columns of it; and those ``tp`` axes."""
    if plan is None:
        return params["head"].to(dtype), ()
    ph = plan["head"]
    head = collectives.all_gather_dim(params["head"].to(dtype), ph.axes(0, "fsdp"), ctx, 0)
    return head, ph.axes(1, "tp")


def loss_fn(params, batch, cfg: LMConfig, ctx=None):
    """Next-token loss over ``batch["tokens"]``/``batch["labels"]`` (B, S),
    with the reference's sequence-chunked projection and softmax: the
    sequence is cut into chunks of ``cfg.xent_chunk`` positions (one chunk
    when that does not divide S), each chunk's ``(B, chunk, V)`` logits
    are made in the compute dtype, cast to f32 and reduced, and under grad
    the chunk is checkpointed, so its logits are made again in the
    backward pass instead of being kept.  The f32 total over the chunks,
    in order, divided by ``B * S``.  Under a placed ``ctx`` the head's
    block is gathered over ``fsdp`` once (in the compute dtype, then held
    in f32 so the chunks' gradients sum in f32 as the one-card loss's do)
    and each chunk's logits are this rank's ``tp`` columns
    (:func:`~repro_torch.models.layers.vocab_parallel_xent`)."""
    x = forward(params, batch["tokens"], cfg, ctx)
    b, s, _ = x.shape
    chunk = min(cfg.xent_chunk, s)
    if s % chunk != 0:
        chunk = s
    labels = batch["labels"]
    plan = placement(cfg, ctx)
    head, tp = params["head"], ()
    if plan is not None:
        head, tp = head_block(params, cfg, ctx, plan, x.dtype)
        head = head.float()
        x = collectives.copy_to(x, tp, ctx)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        fn, extra = (_xent_chunk_tp, (ctx, tp)) if tp else (_xent_chunk, ())
        if torch.is_grad_enabled():
            total = total + checkpoint(fn, xc, lc, head, *extra, use_reentrant=False)
        else:
            total = total + fn(xc, lc, head, *extra)
    return total / float(b * s)


def cache_placement(cfg: LMConfig, ctx, batch: int, max_seq: int, seq_shard: bool = False):
    """The placement of the KV cache's ``k`` and ``v`` (each ``(n_layers,
    batch, max_seq, n_kv_heads, head_dim)``) under ``ctx``, a
    :class:`Placed`, or None when nothing is split (no context, or every
    axis of one rank): :func:`cache_logical_axes` resolved by ``ctx`` and
    fitted by ``fit_sharding``, as :func:`placement` fits the parameters.
    The batch is on ``dp`` and the sequence on ``seqm`` (or, with
    ``seq_shard``, the sequence on ``sp``); the KV heads stay whole on
    every rank, as the reference's ``None`` head axis says.  ``seqm`` and
    ``sp`` split the sequence only where the context's rules name them
    (a deployment names ``seqm`` the model axis, ``sp`` the whole mesh)."""
    if ctx is None:
        return None
    from repro_torch.dist.sharding import fit_sharding, mesh_shape

    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    lg = cache_logical_axes(seq_shard)["k"]
    out = Placed.of(fit_sharding(shape, ctx.sharding(*lg), ctx.mesh), shape, lg,
                    mesh_shape(ctx.mesh))
    return out if any(axes for _, axes in out.dims) else None


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None, ctx=None,
               seq_shard: bool = False):
    """Zeroed K and V caches, (n_layers, batch, max_seq, n_kv_heads,
    head_dim) each, in the compute dtype, on ``device`` (the card when
    None); under a ``ctx`` that splits the cache (:func:`cache_placement`)
    this rank's block of each."""
    dt = L.dtype_of(cfg.dtype)
    dev = resolve_device(device)
    plan = cache_placement(cfg, ctx, batch, max_seq, seq_shard)
    shape = plan.block if plan is not None else (
        cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def shard_cache(cache, cfg: LMConfig, ctx, seq_shard: bool = False, *, device=None):
    """This rank's block of a whole cache under :func:`cache_placement`
    (``NamedSharding.local_block`` at the rank's mesh coordinate), a
    contiguous copy on ``device`` (default: the cache's own); a copy of
    the whole where nothing is split."""
    _, batch, max_seq = cache["k"].shape[:3]
    plan = cache_placement(cfg, ctx, batch, max_seq, seq_shard)
    coord = None if plan is None else ctx.coordinate()
    out = {}
    for name, t in cache.items():
        block = t if plan is None else plan.sharding.local_block(t, coord)
        out[name] = block.to(device or t.device, copy=True).contiguous()
    return out


def gather_cache(cache, cfg: LMConfig, ctx, batch: int, max_seq: int, seq_shard: bool = False,
                 *, device="cpu"):
    """The whole cache from every rank's block (:func:`shard_cache`'s
    inverse), on every rank of the mesh together: each split dim
    all-gathered over the group of its axes, on ``device`` (the host by
    default; the blocks travel as host tensors over gloo)."""
    from repro_torch.dist.sharding import _gloo

    plan = cache_placement(cfg, ctx, batch, max_seq, seq_shard)
    out = {}
    for name, t in cache.items():
        if plan is not None and tuple(t.shape) != plan.block:
            raise ValueError(f"cache {name!r} has shape {tuple(t.shape)}, not this rank's block "
                             f"{plan.block} of {plan.shape} under {plan.sharding.spec}")
        x = t.detach()
        if plan is not None:
            if any(_gloo(ctx, axes) for _, axes in plan.dims):
                x = x.cpu()
            for i, (_, axes) in enumerate(plan.dims):
                x = collectives.all_gather_dim(x, axes, ctx, i)
        out[name] = x.to(device)
    return out


def _seq_split(ctx, seq_shard: bool) -> int:
    """The ranks the context's rules ask to split the cache's sequence
    over (``seqm``, or ``sp`` with ``seq_shard``), before any fitting."""
    from repro_torch.dist.sharding import _entry_axes, mesh_shape

    sizes = mesh_shape(ctx.mesh)
    entry = ctx.spec(*cache_logical_axes(seq_shard)["k"])[2]
    return math.prod(sizes[a] for a in _entry_axes(entry))


def decode_step(params, cache, tokens, pos: int, cfg: LMConfig, ctx=None, *,
                seq_shard: bool = False, backend: str = "kernel", max_seq: int | None = None):
    """tokens (B, 1) int; ``pos`` the one position every row writes and
    attends up to -> (logits (B, V) f32, cache).

    The reference returns a new cache; this writes each layer's K/V row at
    ``pos`` into ``cache`` in place and returns it, which saves a copy of
    the whole cache a step.  As ``lax.dynamic_update_slice`` does, the
    write position is clamped into ``[0, max_seq - 1]``; attention covers
    positions ``< pos + 1``.  ``backend`` picks the attention: the
    hand-written kernel (``"kernel"``) or the reference's plain math
    (``"ref"``).  An MoE layer's FFN is :func:`~repro_torch.models.moe.moe_ffn`
    over the ``B`` rows, plus the shared expert where ``n_shared`` is set.

    Under a ``ctx`` that places the parameters (:func:`placement`) or the
    cache (:func:`cache_placement`; ``seq_shard`` for ``long_500k``'s
    layout), ``params`` and ``cache`` are this rank's blocks, every rank
    passes the same global ``tokens`` and each gets the whole logits: the
    reference's ``decode_step`` (``transformer.py:283-334``) with its
    collectives written out as :func:`forward` writes them.  ``max_seq``
    is the whole cache's length (default: the block's times the split the
    rules ask for; give it where those axes do not divide the length).

    * Rows: this rank's rows of the batch where the cache's batch dim is
      split over ``dp`` (all rows otherwise: ``seq_shard``'s replicated
      tokens, or a batch ``dp`` does not divide).
    * Each layer's ``w*``/``b*`` blocks cast, then FSDP-gathered;
      ``wq``/``wk``/``wv`` column-parallel after ``copy_to``, ``wo``
      row-parallel (``layers.row_parallel``: partials summed in f32) and
      the FFN through ``layers.swiglu``, as in :func:`forward`; K/V
      gathered whole over
      ``tp`` (the cache holds every KV head on every rank).
    * The new K/V row goes only to the rank whose sequence block holds
      ``pos`` (clamped), at its local offset.
    * Attention on a cache whole in sequence: the kernel on this rank's
      query heads and their KV heads (:func:`_decode_heads`, a slice of
      the cache's heads).  On a cache split by sequence: q gathered over
      ``tp``, the kernel with ``return_lse`` on the local block (local
      length ``clamp(pos + 1 - offset, 0, S_loc)``), the blocks combined
      over the sequence axes (``layers.combine_softmax_shards``), then
      this rank's head slice for ``wo``'s row block.
    * An MoE layer: ``moe_ffn`` with the experts over ``ep``; on this
      rank's rows in the local view, or on all rows with
      ``replicated_tokens = B % n(dp) != 0``, as the reference's.
    * Logits: the head's ``tp`` columns, gathered over ``tp`` and the
      rows' ``dp`` axes.

    Without a context, or where it splits neither the parameters nor the
    cache, this is the one-card step."""
    pos = int(pos)
    b_all = tokens.shape[0]
    plan = placement(cfg, ctx)
    cplan = None
    if ctx is not None:
        if max_seq is None:
            max_seq = cache["k"].shape[2] * _seq_split(ctx, seq_shard)
        cplan = cache_placement(cfg, ctx, b_all, max_seq, seq_shard)
    if plan is None and cplan is None:
        ctx, max_seq = None, cache["k"].shape[2]
    else:
        if plan is not None:
            check_blocks(params, plan)
        want = cplan.block if cplan is not None else (
            cfg.n_layers, b_all, max_seq, cfg.n_kv_heads, cfg.head_dim)
        for name in ("k", "v"):
            if tuple(cache[name].shape) != tuple(want):
                raise ValueError(f"cache {name!r} has shape {tuple(cache[name].shape)}, not this "
                                 f"rank's block {tuple(want)}: a placed context runs on each "
                                 "rank's cache block (transformer.init_cache/shard_cache with ctx)")
    dt = L.dtype_of(cfg.dtype)
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dev = params["embed"].device
    rows = cplan.axes(1) if cplan is not None else ()
    seq = cplan.axes(2) if cplan is not None else ()
    if rows:
        group, i = ctx.axes_group(rows)
        b_loc = b_all // collectives.group_size(group)
        tokens = tokens[i * b_loc:(i + 1) * b_loc]
    view = ctx.local_view() if rows else ctx
    rep = ctx is not None and not rows and b_all % ctx.n("dp") != 0
    b = tokens.shape[0]
    s_loc = cache["k"].shape[2]
    offset = ctx.axes_group(seq)[1] * s_loc if seq else 0
    at = min(max(pos, 0), max_seq - 1) - offset
    n_valid = min(max(pos + 1 - offset, 0), s_loc) if seq else pos + 1
    kv_len = torch.full((b,), n_valid, dtype=torch.int32, device=dev)
    x = _embed(params, tokens[:, 0], cfg, ctx, plan)  # (b, d)
    cos, sin = L.rope_tables(1, hd, cfg.rope_theta, offset=pos, device=dev)
    lplan = None if plan is None else _layer_plan(plan)
    for li in range(cfg.n_layers):
        lp = {k: ({e: w[li] for e, w in v.items()} if k == "moe" else v[li])
              for k, v in params["layers"].items()}
        lp, att, ffn = _layer_weights(lp, dt, ctx, lplan)
        n, r = 1, 0
        if att:
            group, r = ctx.axes_group(att)
            n = collectives.group_size(group)
        own = bool(att) and hq % n == 0 and not seq  # the kernel on this rank's own heads
        h = collectives.copy_to(L.rms_norm(x, lp["ln1"]), att, ctx)
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if att and not own:
            q = collectives.all_gather_dim(q, att, ctx, 1)
        if lplan is not None:  # every KV head: the cache holds them all on every rank
            kv_axes = lplan["wk"].axes(1)
            k = collectives.all_gather_dim(k, kv_axes, ctx, 1)
            v = collectives.all_gather_dim(v, kv_axes, ctx, 1)
        q = L.apply_rope(q.reshape(b, -1, hd)[:, None], cos, sin)[:, 0]
        k = L.apply_rope(k.reshape(b, hkv, hd)[:, None], cos, sin)[:, 0]
        kc, vc = cache["k"][li], cache["v"][li]
        if 0 <= at < s_loc:
            kc[:, at] = k
            vc[:, at] = v.reshape(b, hkv, hd)
        if seq:
            o, lse = L.decode_attention(q, kc, vc, kv_len, backend=backend, return_lse=True)
            o = L.combine_softmax_shards(o, lse, seq, ctx, dt)
        elif own:
            h0, nk = _decode_heads(cfg, n, r)
            o = L.decode_attention(q, kc[:, :, h0:h0 + nk], vc[:, :, h0:h0 + nk], kv_len,
                                   backend=backend)
        else:
            o = L.decode_attention(q, kc, vc, kv_len, backend=backend)
        o = o.reshape(b, -1)
        if att and not own:  # this rank's rows of wo
            cols = hq * hd // n
            o = o[:, r * cols:(r + 1) * cols]
        x = x + L.row_parallel(o, lp["wo"], att, ctx)
        h2 = L.rms_norm(x, lp["ln2"])
        if cfg.moe:
            y = moe_ffn(h2, lp["moe"], cfg, view, replicated_tokens=rep)
            if cfg.n_shared:
                y = y + L.swiglu(h2, lp["wg"], lp["wu"], lp["wd"], ctx=ctx, axes=ffn)
        else:
            y = L.swiglu(h2, lp["wg"], lp["wu"], lp["wd"], ctx=ctx, axes=ffn)
        x = x + y
    x = L.rms_norm(x, params["ln_f"])
    head, tp = head_block(params, cfg, ctx, plan, dt)
    logits = collectives.all_gather_dim((x @ head).float(), tp, ctx, 1)
    return collectives.all_gather_dim(logits, rows, ctx, 0), cache


def _decode_heads(cfg: LMConfig, n: int, r: int) -> tuple:
    """``(h0, count)``: the KV heads that rank ``r`` of ``n`` query-head
    ranks reads (its query heads ``[r * hq / n, (r + 1) * hq / n)``), as
    ``_attention_tp`` picks them: its own KV heads, or the one KV head its
    query heads share."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    hq_loc, per = hq // n, hq // hkv
    if hq_loc % per == 0:
        return r * hq_loc // per, hq_loc // per
    if per % hq_loc:
        raise NotImplementedError(f"{hq} query heads over {n} ranks and {hkv} KV heads: a "
                                  "rank's query heads would read several KV heads unevenly")
    return r * hq_loc // per, 1
