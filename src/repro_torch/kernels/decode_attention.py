"""Flash-decode GQA attention: one new token a row over its KV cache —
the attention of the LM serving path (CUDA source:
``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py:decode_attention_pallas``
(``_decode_kernel``), the TPU fast path of the function that
``repro/models/layers.py:decode_attention_xla`` computes.  On the H100 the
sequence is split over blocks (flash-decoding): block ``(b, h, sp)`` takes
the ``sp``-th tile-aligned share of row ``b``'s own ``kv_len``, walks it
with the online softmax while rings of :data:`STAGES` shared-memory
stages keep the next K/V tiles in flight (``cp.async``), and the last
block of each ``(b, h)`` to finish combines the shares' ``(m, l, acc)``
in the same launch (a per-``(b, h)`` ticket counter, kept zeroed between
launches).  bf16 at a head dim of :data:`MMA_DIMS` runs on the tensor
cores (``mma.m16n8k16``, f32 accumulators, ``p`` split into two bf16
halves); f32 and the other head dims on the CUDA cores.
:func:`split_plan` picks the tile and the split.

With ``return_lse=True`` the call also returns each row's log-sum-exp
``m + log(l)`` (scaled logits; ``NEG_INF`` where no position is valid),
written by the block that writes the row from the ``(m, l)`` it holds,
and the output in f32: a rank holding one sequence block of a cache
combines its block with the others' through these
(``models.layers.combine_softmax_shards``).  K and V may be a slice of a
cache's KV heads (a position holds ``kv_heads >= Hkv`` heads).

Bound on the H100: bytes — the K and V rows up to ``kv_len`` are read
once, with ``2 * group`` multiply-adds a value pair.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0

#: the kernels' limits and constants: query heads a KV head, positions a
#: tile at most, K/V tiles in a ring, threads a block of the CUDA-core kernel
MAX_GROUP = 16
MAX_TILE = 64
STAGES = 3
THREADS = 256
#: bytes of K (and of V) a CUDA-core ring stage holds at most:
#: ``tile * D * itemsize``
STAGE_BYTES = 8192
#: bf16 with these head dims takes the tensor-core kernel: 4 warps a
#: block, each with its own ring of 16-position tiles
MMA_DIMS = (16, 32, 64, 128)
MMA_TILE = 16
MMA_THREADS = 128
#: blocks the split aims at, per SM, and the most shares a (row, KV
#: head) is cut into: the combining block reads every share, so a larger
#: split costs more than it balances (a short serving row spends most of
#: a 132-share launch in the combine)
BLOCKS_PER_SM = 16
MAX_SPLIT = 16
NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT = {}
_COUNTERS = {}


def _lse(m, l):
    """``m + log(l)``, ``NEG_INF`` where ``l`` is 0 (no valid position)."""
    return torch.where(l > 0, m + torch.log(l), torch.full_like(m, NEG_INF))


def _decode_body(q, k, v, kv_len, *, return_lse: bool = False):
    """The kernel's arithmetic on tensors, in f32: ``q . k / sqrt(D)``,
    positions ``>= kv_len`` at ``-1e30`` with ``p`` forced to 0, and
    ``acc / max(l, 1e-30)`` (0 for a row with ``kv_len = 0``).  The output
    has the input's dtype; with ``return_lse`` it is f32, beside the
    (B, Hq) log-sum-exp.  One pass over the whole cache stands in for the
    kernel's tiles: the online softmax gives the same value up to
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
    out = (acc / torch.clamp(l, min=1e-30)).reshape(b, hq, d)
    if return_lse:
        return out, _lse(m, l).reshape(b, hq)
    return out.to(q.dtype)


def _decode_split_body(q, k, v, kv_len, n_split: int, tile: int, *, return_lse: bool = False):
    """The kernel's split-and-combine arithmetic on tensors, in f32: row
    ``b``'s ``ceil(kv_len / tile)`` tiles cut into ``n_split`` runs of
    ``ceil(n_tiles / n_split)`` tiles (empty runs allowed); each run's
    ``(m, l, acc)`` as the one-pass softmax over its positions (``m =
    -1e30``, ``l = 0``, ``acc = 0`` when empty); then ``M = max m``,
    ``out = sum e^(m - M) acc / max(sum e^(m - M) l, 1e-30)``.  The output
    has the input's dtype; with ``return_lse`` it is f32, beside ``M +
    log(sum e^(m - M) l)``."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    q4 = q.float().reshape(b, hkv, group, d)
    logits = torch.einsum("bkgd,bskd->bkgs", q4, k.float())
    logits = logits / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    n = torch.clamp(kv_len.to(torch.int64), 0, s)
    n_tiles = (n + tile - 1) // tile
    per = (n_tiles + n_split - 1) // n_split
    pos = torch.arange(s, device=q.device)
    parts = []
    for sp in range(n_split):
        t_begin = torch.minimum(sp * per, n_tiles)
        lo = t_begin * tile
        hi = torch.minimum(torch.minimum(t_begin + per, n_tiles) * tile, n)
        mine = ((pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None]))[:, None, None, :]
        lg = torch.where(mine, logits, torch.full_like(logits, NEG_INF))
        m = lg.amax(dim=-1, keepdim=True)
        p = torch.where(mine, torch.exp(lg - m), torch.zeros_like(lg))
        parts.append((m, p.sum(dim=-1, keepdim=True), torch.einsum("bkgs,bskd->bkgd", p, v.float())))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = sum(torch.exp(m - big_m) * l_ for m, l_, _ in parts)
    acc = sum(torch.exp(m - big_m) * a for m, _, a in parts)
    out = (acc / torch.clamp(l, min=1e-30)).reshape(b, hq, d)
    if return_lse:
        return out, _lse(big_m, l).reshape(b, hq)
    return out.to(q.dtype)


def split_plan(b: int, hkv: int, d: int, s: int, itemsize: int, sm_count: int) -> tuple:
    """``(tile, n_split)`` for a launch: the tensor-core kernel's 16
    positions for bf16 at a head dim of :data:`MMA_DIMS`, else a tile that
    holds ``STAGE_BYTES`` of K (a power of two of positions, at most
    ``MAX_TILE``); the split gives about ``BLOCKS_PER_SM`` blocks an SM
    over the ``b * hkv`` (row, KV head) pairs, at most ``MAX_SPLIT``
    shares and never more than a full row has tiles."""
    if itemsize == 2 and d in MMA_DIMS:
        tile = MMA_TILE
    else:
        tile = max(8, min(MAX_TILE, STAGE_BYTES // (d * itemsize)))
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(b * hkv, 1))
    return tile, max(1, min(want, math.ceil(s / tile), MAX_SPLIT))


def _sm_count(dev) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def _counter(dev, pairs: int) -> torch.Tensor:
    """The per-(b, h) ticket counters of a launch on ``dev``'s current
    stream, 0 between launches: the combining block of each (b, h) resets
    its own.  Outside graph capture they are kept per (device, stream), so
    a launch sets no memory and calls on two streams never share one;
    grown on their own stream, so a freed one is stream-ordered after its
    last launch.  Under capture every call takes fresh zeros (a memset in
    the graph), so no graph holds a cached buffer."""
    with torch.cuda.device(dev):
        if torch.cuda.is_current_stream_capturing():
            return torch.zeros(pairs, dtype=torch.int32, device=dev)
        key = (dev, torch.cuda.current_stream().cuda_stream)
        counter = _COUNTERS.get(key)
        if counter is None or counter.numel() < pairs:
            counter = torch.zeros(max(pairs, 1024), dtype=torch.int32, device=dev)
            _COUNTERS[key] = counter
    return counter


def _kv_heads(t) -> int:
    """The KV heads a position of a K/V operand (B, S, Hkv, D) holds in
    memory: ``Hkv`` for a contiguous cache, more for a slice of a cache's
    KV heads (each position's heads contiguous, positions a whole number
    of heads apart, rows ``S`` positions apart).  Raises otherwise."""
    b, s, h, d = t.shape
    st = t.stride()
    row = st[1] if s > 1 else (st[0] if b > 1 else h * d)
    if not ((d == 1 or st[3] == 1) and (h == 1 or st[2] == d) and (b == 1 or st[0] == s * row)
            and row >= h * d and row % d == 0):
        raise ValueError(f"k and v must hold each position's heads contiguous, positions at one "
                         f"stride and rows S positions apart; got strides {st}")
    return row // d


def _check(q, k, v, kv_len) -> tuple:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name} must match q's dtype and device ({q.dtype}, {dev})")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, D) and k, v (B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} (Hq a multiple of Hkv)")
    heads = _kv_heads(k)
    if _kv_heads(v) != heads:
        raise ValueError(f"k and v must have the same strides, got {k.stride()} and {v.stride()}")
    cuda_lib.require(kv_len, "kv_len", torch.int32, dev, numel=b)
    return b, hq, d, heads


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, return_lse: bool = False):
    """One-token GQA attention: ``q`` (B, Hq, D) over ``k``/``v`` (B, S,
    Hkv, D), the first ``kv_len[b]`` positions of row b (int32, (B,)).
    float32 or bfloat16 in, the same dtype out, f32 inside; ``k``/``v``
    contiguous or a slice of a cache's KV heads.  With ``return_lse``:
    ``(out, lse)``, the output in f32 and the (B, Hq) f32 log-sum-exp of
    the scaled logits (``NEG_INF`` for a row with no valid position).  CPU
    tensors take the plain twin; CUDA tensors launch the kernel (one
    launch either way), its sequence split into :func:`split_plan`'s
    shares."""
    b, hq, d, kv_heads = _check(q, k, v, kv_len)
    dev = q.device
    if dev.type == "cpu":
        return _decode_body(q, k, v, kv_len, return_lse=return_lse)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {dev}")
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > MAX_GROUP:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads a KV head, got {group}")
    if d < 8 or d > 256 or d & (d - 1):
        raise ValueError(f"the kernel takes a head dimension that is a power of two in [8, 256], "
                         f"got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v and k/v's positions must start on a 16-byte boundary")
    if b * hkv >= 2**31 or s >= 2**31 or kv_heads * d >= 2**31:
        raise ValueError("decode_attention: shape too large for the kernel's int arguments")
    if return_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=dev)
        lse = torch.empty((b, hq), dtype=torch.float32, device=dev)
    else:
        out, lse = torch.empty_like(q), None
    if b == 0:
        return (out, lse) if return_lse else out
    tile, n_split = split_plan(b, hkv, d, s, q.element_size(), _sm_count(dev))
    # the shares' acc (group, D) then their (m, l) (group, 2), in one buffer
    n_acc = b * hkv * n_split * group * d if n_split > 1 else 0
    scratch = torch.empty(n_acc + n_acc // d * 2, dtype=torch.float32, device=dev)
    counter = _counter(dev, b * hkv)
    cuda_lib.launch("decode_attention_launch", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_len.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                    scratch.data_ptr(), scratch.data_ptr() + 4 * n_acc, counter.data_ptr(), b, s,
                    hkv, d, kv_heads, group, tile, n_split, _DTYPE_CODES[q.dtype])
    global LAUNCHES
    LAUNCHES += 1
    return (out, lse) if return_lse else out
