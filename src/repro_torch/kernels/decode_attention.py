"""Flash-decode GQA attention: one new token a row over its KV cache —
the attention of the LM serving path (CUDA source:
``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py:decode_attention_pallas``
(``_decode_kernel``), the TPU fast path of the function that
``repro/models/layers.py:decode_attention_xla`` computes.  On the H100 one
block owns one (row, KV head) pair and walks the cache in tiles with an
online softmax, its ``Hq / Hkv`` query heads sharing each K/V tile.

Bound on the H100: bytes — the K and V rows up to ``kv_len`` are read
once, with ``2 * group`` multiply-adds a value pair.  This first design
has no split over the sequence and no prefetch; speed is later work.
"""

from __future__ import annotations

import torch

from . import cuda_lib

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0

#: the kernel's limits: heads a block (``kMaxGroup``) and positions a tile
MAX_GROUP = 16
TILE = 256
NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _decode_body(q, k, v, kv_len):
    """The kernel's arithmetic on tensors, in f32: ``q . k / sqrt(D)``,
    positions ``>= kv_len`` at ``-1e30`` with ``p`` forced to 0, and
    ``acc / max(l, 1e-30)`` (0 for a row with ``kv_len = 0``).  The output
    has the input's dtype.  One pass over the whole cache stands in for
    the kernel's tiles: the online softmax gives the same value up to
    rounding."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    q4 = q.float().reshape(b, hkv, group, d)
    logits = torch.einsum("bkgd,bskd->bkgs", q4, k.float())
    logits = logits / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    pos = torch.arange(s, device=q.device)
    valid = (pos[None, :] < kv_len.to(torch.int64)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


def _check(q, k, v, kv_len) -> tuple:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name} must match q's dtype and device ({q.dtype}, {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, D) and k, v (B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} (Hq a multiple of Hkv)")
    cuda_lib.require(kv_len, "kv_len", torch.int32, dev, numel=b)
    return b, hq, d


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention: ``q`` (B, Hq, D) over ``k``/``v`` (B, S,
    Hkv, D), the first ``kv_len[b]`` positions of row b (int32, (B,)).
    float32 or bfloat16 in, the same dtype out, f32 inside.  CPU tensors
    take the plain twin; CUDA tensors launch the kernel."""
    b, hq, d = _check(q, k, v, kv_len)
    dev = q.device
    if dev.type == "cpu":
        return _decode_body(q, k, v, kv_len)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {dev}")
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > MAX_GROUP:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads a KV head, got {group}")
    if d < 8 or d > TILE or d & (d - 1):
        raise ValueError(f"the kernel takes a head dimension that is a power of two in [8, {TILE}], "
                         f"got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if b * hkv >= 2**31 or s >= 2**31:
        raise ValueError("decode_attention: shape too large for the kernel's int arguments")
    out = torch.empty_like(q)
    if b == 0:
        return out
    cuda_lib.launch("decode_attention_launch", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_len.data_ptr(), out.data_ptr(), b, s, hkv, d, group, _DTYPE_CODES[q.dtype])
    global LAUNCHES
    LAUNCHES += 1
    return out

