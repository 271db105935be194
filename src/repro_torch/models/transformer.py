"""Decoder-only LM (dense GQA and MoE variants): training and serving
(counterpart of ``repro.models.transformer``).

Parameters are a plain dict that mirrors the reference's pytree: the
per-layer leaves are stacked on a leading layer axis, and every weight
keeps the reference's ``(in, out)`` layout, so ``h @ w`` is the
reference's product and :func:`params_from_numpy` carries the reference's
weights across unchanged.

Entry points:
  init(gen, cfg)                                  -> params
  forward(params, tokens, cfg)                    -> final hidden states
  loss_fn(params, batch, cfg)                     -> scalar next-token loss
  init_cache(cfg, batch, max_seq)                 -> KV cache dict
  decode_step(params, cache, tokens, pos, cfg)    -> (logits, cache)
  params_from_numpy(np_params, cfg)               -> params
  param_logical_axes(cfg) / cache_logical_axes()  -> logical placement trees

Each runs on the card unless given a CPU generator or ``device="cpu"``.
A config with ``moe=True`` routes each layer's FFN through
:func:`repro_torch.models.moe.moe_ffn` (plus the shared expert's SwiGLU
when ``n_shared`` is set).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.device import resolve_device

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


def init(gen: torch.Generator, cfg: LMConfig):
    """Random parameters drawn from ``gen`` on its device (a CUDA generator
    for the card, ``torch.Generator()`` for the CPU).  The reference's
    ``jax.random`` draws cannot be reproduced; carry its weights across
    with :func:`params_from_numpy` instead.  Each stacked tensor is drawn
    a layer at a time into its ``param_dtype`` storage, so a bf16 model
    at full width never holds an f32 copy of a whole stack."""
    pd = L.dtype_of(cfg.param_dtype)
    d, hd, n = cfg.d_model, cfg.head_dim, cfg.n_layers
    dev = gen.device
    layers = {
        "ln1": torch.ones((n, d), dtype=pd, device=dev),
        "ln2": torch.ones((n, d), dtype=pd, device=dev),
        "wq": L.dense_init(gen, (n, d, cfg.n_heads * hd), pd),
        "wk": L.dense_init(gen, (n, d, cfg.n_kv_heads * hd), pd),
        "wv": L.dense_init(gen, (n, d, cfg.n_kv_heads * hd), pd),
        "wo": L.dense_init(gen, (n, cfg.n_heads * hd, d), pd),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((n, cfg.n_heads * hd), dtype=pd, device=dev)
        layers["bk"] = torch.zeros((n, cfg.n_kv_heads * hd), dtype=pd, device=dev)
        layers["bv"] = torch.zeros((n, cfg.n_kv_heads * hd), dtype=pd, device=dev)
    if cfg.moe:
        e, ffe = cfg.n_experts, cfg.d_ff_expert
        layers["moe"] = {
            "router": L.dense_init(gen, (n, d, e), pd),
            "wg": L.dense_init(gen, (n, e, d, ffe), pd),
            "wu": L.dense_init(gen, (n, e, d, ffe), pd),
            "wd": L.dense_init(gen, (n, e, ffe, d), pd),
        }
        ff = cfg.n_shared * ffe  # the shared expert, when there is one
    else:
        ff = cfg.d_ff
    if ff:
        layers["wg"] = L.dense_init(gen, (n, d, ff), pd)
        layers["wu"] = L.dense_init(gen, (n, d, ff), pd)
        layers["wd"] = L.dense_init(gen, (n, ff, d), pd)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, d), pd),
        "layers": layers,
        "ln_f": torch.ones((d,), dtype=pd, device=dev),
        "head": L.dense_init(gen, (d, cfg.vocab), pd),
    }


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
    as the reference's: resolved by ``ShardingCtx.sharding`` they place
    the leaves; this slice keeps them whole on every rank (the launch
    slice shards no parameter over ``fsdp``/``tp``/``ep``)."""
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


def _layer_body(x, lp, cfg: LMConfig, cos, sin):
    """One layer over the whole sequence: x (B, S, d) in the compute dtype;
    ``lp`` one layer's leaves.  The reference casts the ``w*``/``b*``
    leaves to the compute dtype up front (its MoE leaves inside
    ``moe_ffn``)."""
    b, s, d = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    lp = {k: (v.to(dt) if k.startswith(("w", "b")) else v) for k, v in lp.items()}
    h = L.rms_norm(x, lp["ln1"])
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = L.apply_rope(q.reshape(b, s, hq, hd), cos, sin)
    k = L.apply_rope(k.reshape(b, s, hkv, hd), cos, sin)
    o = L.causal_attention(q, k, v.reshape(b, s, hkv, hd), q_chunk=cfg.q_chunk)
    x = x + o.reshape(b, s, hq * hd) @ lp["wo"]
    h = L.rms_norm(x, lp["ln2"])
    if cfg.moe:
        y = moe_ffn(h.reshape(b * s, d), lp["moe"], cfg).reshape(b, s, d)
        if cfg.n_shared:
            y = y + L.swiglu(h, lp["wg"], lp["wu"], lp["wd"])
    else:
        y = L.swiglu(h, lp["wg"], lp["wu"], lp["wd"])
    return x + y


def forward(params, tokens, cfg: LMConfig):
    """tokens (B, S) int -> final hidden states (B, S, d) in the compute
    dtype: the reference's full-sequence pass (embed, the layers with RoPE
    over positions ``0..S-1`` and :func:`~repro_torch.models.layers.causal_attention`
    in chunks of ``cfg.q_chunk`` query rows, ``ln_f``).  An MoE layer runs
    :func:`~repro_torch.models.moe.moe_ffn` over the ``B * S`` rows, its
    capacity set by that count, plus the shared expert.

    With ``cfg.remat`` and grad enabled each layer body is checkpointed
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint(body)``: only a layer's input is kept, the body runs
    again in the backward pass.  The stacked leaves are unbound once, so
    their gradient is one stack of the per-layer gradients."""
    dt = L.dtype_of(cfg.dtype)
    dev = params["embed"].device
    per_layer = {k: ({e: w.unbind(0) for e, w in v.items()} if k == "moe" else v.unbind(0))
                 for k, v in params["layers"].items()}
    x = params["embed"][tokens.long()].to(dt)
    cos, sin = L.rope_tables(tokens.shape[1], cfg.head_dim, cfg.rope_theta, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = {k: ({e: w[i] for e, w in v.items()} if k == "moe" else v[i])
              for k, v in per_layer.items()}
        if remat:
            x = checkpoint(_layer_body, x, lp, cfg, cos, sin, use_reentrant=False)
        else:
            x = _layer_body(x, lp, cfg, cos, sin)
    return L.rms_norm(x, params["ln_f"])


def _xent_chunk(xc, lc, head):
    """Summed ``logsumexp - gold`` of one chunk: ``(B, chunk, d) @ head``
    in the compute dtype, the logits cast to f32."""
    logits = (xc @ head.to(xc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def loss_fn(params, batch, cfg: LMConfig):
    """Next-token loss over ``batch["tokens"]``/``batch["labels"]`` (B, S),
    with the reference's sequence-chunked projection and softmax: the
    sequence is cut into chunks of ``cfg.xent_chunk`` positions (one chunk
    when that does not divide S), each chunk's ``(B, chunk, V)`` logits
    are made in the compute dtype, cast to f32 and reduced, and under grad
    the chunk is checkpointed, so its logits are made again in the
    backward pass instead of being kept.  The f32 total over the chunks,
    in order, divided by ``B * S``."""
    x = forward(params, batch["tokens"], cfg)
    b, s, _ = x.shape
    chunk = min(cfg.xent_chunk, s)
    if s % chunk != 0:
        chunk = s
    labels = batch["labels"]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_xent_chunk, xc, lc, params["head"], use_reentrant=False)
        else:
            total = total + _xent_chunk(xc, lc, params["head"])
    return total / float(b * s)


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None):
    """Zeroed K and V caches, (n_layers, batch, max_seq, n_kv_heads,
    head_dim) each, in the compute dtype, on ``device`` (the card when
    None)."""
    dt = L.dtype_of(cfg.dtype)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(params, cache, tokens, pos: int, cfg: LMConfig, *, backend: str = "kernel"):
    """tokens (B, 1) int; ``pos`` the one position every row writes and
    attends up to -> (logits (B, V) f32, cache).

    The reference returns a new cache; this writes each layer's K/V row at
    ``pos`` into ``cache`` in place and returns it, which saves a copy of
    the whole cache a step.  As ``lax.dynamic_update_slice`` does, the
    write position is clamped into ``[0, max_seq - 1]``; attention covers
    positions ``< pos + 1``.  ``backend`` picks the attention: the
    hand-written kernel (``"kernel"``) or the reference's plain math
    (``"ref"``).  An MoE layer's FFN is :func:`~repro_torch.models.moe.moe_ffn`
    over the ``B`` rows, plus the shared expert where ``n_shared`` is set."""
    pos = int(pos)
    dt = L.dtype_of(cfg.dtype)
    lay = params["layers"]
    b = tokens.shape[0]
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dev = params["embed"].device
    x = params["embed"][tokens[:, 0].long()].to(dt)  # (B, d)
    cos, sin = L.rope_tables(1, hd, cfg.rope_theta, offset=pos, device=dev)
    smax = cache["k"].shape[2]
    at = min(max(pos, 0), smax - 1)
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    for i in range(cfg.n_layers):
        h = L.rms_norm(x, lay["ln1"][i])
        q = (h @ lay["wq"][i].to(dt)).reshape(b, hq, hd)
        k = (h @ lay["wk"][i].to(dt)).reshape(b, hkv, hd)
        v = (h @ lay["wv"][i].to(dt)).reshape(b, hkv, hd)
        if cfg.qkv_bias:
            q = q + lay["bq"][i].to(dt).reshape(hq, hd)
            k = k + lay["bk"][i].to(dt).reshape(hkv, hd)
            v = v + lay["bv"][i].to(dt).reshape(hkv, hd)
        q = L.apply_rope(q[:, None], cos, sin)[:, 0]
        k = L.apply_rope(k[:, None], cos, sin)[:, 0]
        cache["k"][i, :, at] = k
        cache["v"][i, :, at] = v
        o = L.decode_attention(q, cache["k"][i], cache["v"][i], kv_len, backend=backend)
        x = x + o.reshape(b, hq * hd) @ lay["wo"][i].to(dt)
        h2 = L.rms_norm(x, lay["ln2"][i])
        if cfg.moe:
            y = moe_ffn(h2, {k: w[i] for k, w in lay["moe"].items()}, cfg)
            if cfg.n_shared:
                y = y + L.swiglu(h2, lay["wg"][i], lay["wu"][i], lay["wd"][i])
        else:
            y = L.swiglu(h2, lay["wg"][i], lay["wu"][i], lay["wd"][i])
        x = x + y
    x = L.rms_norm(x, params["ln_f"])
    logits = (x @ params["head"].to(dt)).float()
    return logits, cache
