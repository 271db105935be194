"""Shared neural layers over plain tensors (counterpart of
``repro.models.layers``): parameters are plain dicts, dtypes are explicit
everywhere, and every initialiser draws from an explicit
``torch.Generator`` on the device it is given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist import collectives
from repro_torch.kernels import decode_attention as _kernel

#: the attention backends of the serving path: the hand-written kernel
#: (its plain twin on CPU tensors), or the reference's plain math
BACKENDS = ("kernel", "ref")


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    """Normal weights of std ``1/sqrt(fan_in)`` (fan_in = ``shape[-2]``)
    drawn in f32 on ``gen``'s device.  A stack (three axes or more) is
    drawn one leading slice at a time into its ``dtype`` storage, so the
    f32 draw never holds more than one layer."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if len(shape) < 3:
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (w * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        w = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=gen.device)
        out[i] = w * std
    return out


def embed_init(gen: torch.Generator, shape, dtype, std: float = 0.02):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype)


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def rope_tables(seq_len: int, head_dim: int, theta: float, dtype=torch.float32, offset=0,
                device=None):
    """(S, hd/2) cos/sin tables; ``offset`` supports decode positions."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    ang = pos[:, None] * freqs[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def row_parallel(a, w, axes=(), ctx=None):
    """``a @ w`` for a ``w`` whose rows are split over the mesh axes
    ``axes`` of ``ctx`` (``a`` this rank's matching columns): each rank's
    partial product kept in f32, summed over the group in f32 through
    ``reduce_from`` (its gradient passed back unchanged) and rounded to
    ``a``'s dtype once, as the one-card product rounds its f32
    accumulation once.  Partials rounded to bf16 and summed in bf16 would
    round every row-parallel output twice: over 24 layers that moves a
    placed model's residual stream tens of bf16 ulps off the one-card
    model's, enough to flip an MoE router's pick.  ``a @ w`` itself
    without axes."""
    if not axes:
        return a @ w
    return collectives.reduce_from(a.float() @ w.float(), axes, ctx).to(a.dtype)


def swiglu(x, wg, wu, wd, *, ctx=None, axes=()):
    """x: (..., d) -> (..., d) through the gated FFN (weights in (in, out)).

    Tensor-parallel over the mesh axes ``axes`` of ``ctx``: ``wg``/``wu``
    hold this rank's ``d_ff`` columns and ``wd`` the same rows, so the
    input enters through ``copy_to`` and the rank's partial output leaves
    through :func:`row_parallel` (the sum over the group)."""
    x = collectives.copy_to(x, axes, ctx)
    g = x @ wg.to(x.dtype)
    u = x @ wu.to(x.dtype)
    return row_parallel(torch.nn.functional.silu(g) * u, wd.to(x.dtype), axes, ctx)


def causal_attention(q, k, v, *, q_chunk: int = 1024):
    """Causal GQA attention over a whole sequence, ``q_chunk`` query rows at
    a time, so the live logits are ``(B, Hq, q_chunk, S)``: the reference's
    plain path (``repro.models.layers.causal_attention``, outside any
    kernel).  q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd).
    Under tensor parallelism it runs on a rank's own heads (``Hq`` and
    ``Hkv`` local, query head ``i`` reading KV head ``i // (Hq / Hkv)``).

    As the reference: when ``q_chunk`` does not divide S the whole
    sequence is one chunk; logits in the working dtype scaled by
    ``1/sqrt(hd)``, masked with the dtype's lowest value, softmax in f32
    cast back, then the PV product.  Every chunk reads every key (the
    masked ones included), as the reference's does."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, s)
    if s % q_chunk != 0:
        q_chunk = s
    q5 = q.reshape(b, s // q_chunk, q_chunk, hkv, group, hd)
    kpos = torch.arange(s, device=q.device)
    lowest = torch.finfo(q.dtype).min
    out = torch.empty((b, s // q_chunk, q_chunk, hkv, group, hd), dtype=q.dtype, device=q.device)
    for ci in range(s // q_chunk):
        logits = torch.einsum("bqkgd,bskd->bkgqs", q5[:, ci], k) * scale
        qpos = ci * q_chunk + torch.arange(q_chunk, device=q.device)
        logits.masked_fill_(kpos[None, :] > qpos[:, None], lowest)
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        del logits
        out[:, ci] = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, s, hq, hd)


def decode_attention_plain(q, k_cache, v_cache, kv_len, return_lse: bool = False):
    """The reference's one-token attention (``decode_attention_xla``) in
    the working dtype: logits scaled by ``1/sqrt(hd)``, masked with the
    dtype's lowest value, softmax in f32 cast back, then the PV product.
    q: (B, Hq, hd); caches: (B, Smax, Hkv, hd); kv_len: (B,).  With
    ``return_lse``: the output in f32 and the f32 log-sum-exp of the
    masked logits (``NEG_INF`` for a row with no valid position), for the
    combine of a sequence-split cache."""
    b, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    q4 = q.reshape(b, hkv, group, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", q4, k_cache) * (1.0 / math.sqrt(hd))
    pos = torch.arange(smax, device=q.device)
    valid = (pos[None, :] < kv_len.to(torch.int64)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, torch.finfo(logits.dtype).min))
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache).reshape(b, hq, hd)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.float(), dim=-1).reshape(b, hq)
    lse = torch.where(kv_len.to(torch.int64)[:, None] > 0, lse,
                      torch.full_like(lse, _kernel.NEG_INF))
    return out.float(), lse


def decode_attention(q, k_cache, v_cache, kv_len, backend: str = "kernel", *,
                     return_lse: bool = False):
    """One-token GQA attention over a cache: q (B, Hq, hd); caches (B,
    Smax, Hkv, hd); ``kv_len`` an int or an int32 (B,) tensor of valid
    lengths.  ``backend="kernel"`` takes the hand-written kernel on CUDA
    tensors (its twin on CPU tensors); ``"ref"`` the reference's plain
    math (:func:`decode_attention_plain`).  With ``return_lse``: ``(out,
    lse)``, the output in f32 and each row's (B, Hq) log-sum-exp, which
    :func:`combine_softmax_shards` takes."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not torch.is_tensor(kv_len) or kv_len.dim() == 0:
        kv_len = torch.full((q.shape[0],), int(kv_len), dtype=torch.int32, device=q.device)
    if backend == "ref":
        extra = (True,) if return_lse else ()
        return decode_attention_plain(q, k_cache, v_cache, kv_len, *extra)
    extra = {"return_lse": True} if return_lse else {}
    return _kernel.decode_attention(q, k_cache, v_cache, kv_len.to(torch.int32), **extra)


def combine_softmax_shards(out, lse, axes, ctx, dtype=None):
    """The attention over a cache split by sequence over the mesh axes
    ``axes`` of ``ctx``, from each rank's ``(out, lse)`` on its block
    (:func:`decode_attention` with ``return_lse``): ``M`` the max of the
    ranks' ``lse``, ``w = exp(lse - M)``, then ``psum(w * out) /
    psum(w)``, cast to ``dtype`` (the compute dtype) once.  Two
    all-reduces, of (B, Hq) and of (B, Hq, D + 1) f32.  A block with no
    valid position (``lse = NEG_INF``) weighs 0; if every block is empty
    the result is 0, as the kernel gives at ``kv_len = 0``."""
    m = collectives.max_if_mapped(lse, axes, ctx)
    w = torch.exp(lse - m)[..., None]
    num = collectives.psum_if_mapped(torch.cat([w * out, w], dim=-1), axes, ctx)
    res = num[..., :-1] / num[..., -1:]
    return res if dtype is None else res.to(dtype)


def vocab_parallel_xent(logits_f32, labels, ctx, axes):
    """Each token's ``logsumexp - gold`` (f32) from this rank's block of
    vocabulary columns, ``logits_f32`` (..., V / n), the ``n`` ranks over
    the mesh axes ``axes`` holding the blocks in order: the max over the
    group (no gradient: it only steadies the exponent), the sum of the
    exponentials over the group, and the gold logit from the rank whose
    block holds the label (zero from the others, summed).  Every rank gets
    the same values; each rank's gradient reaches its own columns.  The
    counterpart of the reference's ``cross_entropy`` on vocabulary-sharded
    logits, whose sums its sharding constraint leaves to XLA."""
    cols = logits_f32.shape[-1]
    m = collectives.max_if_mapped(logits_f32.detach().amax(dim=-1), axes, ctx)
    se = collectives.reduce_from(torch.exp(logits_f32 - m[..., None]).sum(dim=-1), axes, ctx)
    ids = labels.long() - ctx.axes_group(axes)[1] * cols
    mine = (ids >= 0) & (ids < cols)
    gold = torch.gather(logits_f32, -1, torch.clamp(ids, 0, cols - 1)[..., None])[..., 0]
    gold = collectives.reduce_from(torch.where(mine, gold, torch.zeros_like(gold)), axes, ctx)
    return m + torch.log(se) - gold


def cross_entropy(logits_f32, labels):
    """Token-mean cross entropy, ``logsumexp - gold``, in f32 (over logits
    split by vocabulary across ranks: :func:`vocab_parallel_xent`)."""
    lse = torch.logsumexp(logits_f32, dim=-1)
    gold = torch.gather(logits_f32, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
