"""RecSys architectures: DLRM (MLPerf), DIN, Wide&Deep, SASRec
(counterpart of ``repro.models.recsys``).

All four read one concatenated mega-table through
:func:`repro_torch.models.embedding.sharded_lookup`; their MLPs are plain
products (``torch.matmul``), as the reference's are plain XLA.  Parameters
are a plain dict that mirrors the reference's pytree (lists of MLP layers
and of SASRec blocks included), every weight in the reference's ``(in,
out)`` layout, so :func:`params_from_numpy` carries its weights across.

Entry points:
  init(gen, cfg, ctx=None)                    -> params
  loss_fn(params, batch, cfg, ctx=None)       -> scalar BCE loss (train_batch)
  score_fn(params, batch, cfg, ctx=None)      -> (B,) logits   (serve_* cells)
  retrieval_fn(params, batch, cfg, ctx=None)  -> (n_cand,) logits, the user
                                                 side hoisted out of the
                                                 candidates (retrieval_cand)
  params_from_numpy(np_params, device=None)   -> params

Each runs on the device of its parameters; ``init`` draws on the
generator's.  Under a :class:`~repro_torch.dist.sharding.ShardingCtx` the
``embed`` and ``wide`` leaves hold this rank's row shard
(:func:`local_params`).  On one rank the lookup is a gather in both
lookup modes; over ranks (``launch.steps.build_step`` under a context)
each rank trains on its slice of the batch and its row shard, and the
lookups' exchanges carry the gradients to the owners' rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device

from . import layers as L
from .embedding import local_rows, n_row_shards, sharded_lookup

# MLPerf DLRM (Criteo 1TB) vocabulary sizes, 26 sparse fields
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

#: candidates DIN's retrieval scores at a time: a chunk's (n, S, 4D)
#: attention input and its hidden activations stay within a few GB at
#: S = 100, D = 18 (~110 KB a candidate in f32); each candidate's score
#: depends on that candidate alone, so the chunking changes no value
DIN_RETRIEVAL_CHUNK = 1 << 15


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str  # dlrm | din | wide_deep | sasrec
    embed_dim: int
    vocab_sizes: tuple  # per sparse field (dense tables, row-sharded)
    n_dense: int = 0
    bot_mlp: tuple = ()
    top_mlp: tuple = ()
    attn_mlp: tuple = ()
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 1
    interaction: str = "dot"
    lookup_mode: str = "a2a"
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))


def _mlp_init(gen, sizes: Sequence[int], dtype):
    return [{"w": L.dense_init(gen, (sizes[i], sizes[i + 1]), dtype),
             "b": torch.zeros((sizes[i + 1],), dtype=dtype, device=gen.device)}
            for i in range(len(sizes) - 1)]


def _mlp_apply(params, x, final_act: bool = False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"].to(x.dtype) + lyr["b"].to(x.dtype)
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def init(gen: torch.Generator, cfg: RecsysConfig, ctx=None):
    """Random parameters drawn from ``gen`` on its device.  The mega-table
    holds field ``f``'s rows from ``field_offsets(cfg)[f]`` on, its row
    count rounded up to the shard count of ``ctx`` (every rank of its
    mesh).  The reference's ``jax.random`` draws cannot be reproduced;
    carry its weights across with :func:`params_from_numpy`."""
    dt = L.dtype_of(cfg.dtype)
    dev = gen.device
    d = cfg.embed_dim
    total = _round_up(cfg.total_rows, max(n_row_shards(ctx), 1))
    params = {"embed": L.embed_init(gen, (total, d), dt, std=0.05)}
    if cfg.kind == "dlrm":
        n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        params["bot"] = _mlp_init(gen, (cfg.n_dense,) + tuple(cfg.bot_mlp), dt)
        params["top"] = _mlp_init(gen, (cfg.bot_mlp[-1] + n_int,) + tuple(cfg.top_mlp), dt)
    elif cfg.kind == "din":
        params["attn"] = _mlp_init(gen, (4 * d,) + tuple(cfg.attn_mlp) + (1,), dt)
        params["mlp"] = _mlp_init(gen, (3 * d,) + tuple(cfg.top_mlp) + (1,), dt)
    elif cfg.kind == "wide_deep":
        params["deep"] = _mlp_init(gen, (cfg.n_sparse * d,) + tuple(cfg.top_mlp) + (1,), dt)
        params["wide"] = L.embed_init(gen, (total, 1), dt, std=0.01)
    elif cfg.kind == "sasrec":
        params["pos"] = L.embed_init(gen, (cfg.seq_len, d), dt)
        params["blocks"] = [
            {"ln1": torch.ones((d,), dtype=dt, device=dev),
             "ln2": torch.ones((d,), dtype=dt, device=dev),
             **{w: L.dense_init(gen, (d, d), dt) for w in ("wq", "wk", "wv", "w1", "w2")}}
            for _ in range(cfg.n_blocks)]
        params["ln_f"] = torch.ones((d,), dtype=dt, device=dev)
    else:
        raise ValueError(cfg.kind)
    return params


def params_from_numpy(np_params, device=None):
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, repro_params)``) as tensors on ``device``
    (the card when None), lists of MLP layers and blocks kept as lists."""
    return tree.tree_from_numpy(np_params, resolve_device(device))


def local_params(params, ctx):
    """``params`` with the ``embed`` (and ``wide``) leaves cut to this
    rank's row shard under ``ctx``: what :func:`score_fn` takes on a rank."""
    out = dict(params)
    for k in ("embed", "wide"):
        if k in out:
            out[k] = local_rows(out[k], ctx)
    return out


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(cfg.vocab_sizes))[:-1]]).astype(np.int64)


def _offsets(cfg, device):
    return torch.from_numpy(field_offsets(cfg)).to(device)


def _lookup(params, sparse_ids, cfg, ctx):
    """sparse_ids (B, F) local ids -> (B, F, D) via the mega-table."""
    rows = sparse_ids.long() + _offsets(cfg, sparse_ids.device)[None, :]
    return sharded_lookup(params["embed"], rows, ctx, mode=cfg.lookup_mode)


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


def _dlrm_features(params, dense, emb):
    bot = _mlp_apply(params["bot"], dense, final_act=True)  # (B, D)
    allv = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F+1, D)
    inter = torch.einsum("bfd,bgd->bfg", allv, allv)
    f = allv.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=emb.device)
    return torch.cat([bot, inter[:, iu, ju]], dim=1)


def dlrm_scores(params, batch, cfg, ctx=None):
    emb = _lookup(params, batch["sparse"], cfg, ctx)
    feats = _dlrm_features(params, batch["dense"], emb)
    return _mlp_apply(params["top"], feats)[:, 0]


# ---------------------------------------------------------------------------
# DIN — target attention over user history
# ---------------------------------------------------------------------------


def _din_interest(params, hist, target):
    # hist (B, S, D); target (B, D)
    t = target[:, None, :].expand(hist.shape)
    att_in = torch.cat([t, hist, t - hist, t * hist], dim=-1)
    w = _mlp_apply(params["attn"], att_in)[..., 0]  # (B, S) raw weights
    w = torch.where(hist.abs().sum(-1) > 0, w, torch.full_like(w, -1e9))  # mask padding
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bs,bsd->bd", w, hist)


def din_scores(params, batch, cfg, ctx=None):
    # fields: [target_item, user_profile] + history
    emb = _lookup(params, batch["sparse"], cfg, ctx)  # (B, 2, D)
    target, profile = emb[:, 0], emb[:, 1]
    hist_rows = batch["hist"].long() + int(field_offsets(cfg)[0])  # history shares the item table
    hist = sharded_lookup(params["embed"], hist_rows, ctx, mode=cfg.lookup_mode)
    interest = _din_interest(params, hist, target)
    x = torch.cat([interest, target, profile], dim=-1)
    return _mlp_apply(params["mlp"], x)[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep
# ---------------------------------------------------------------------------


def wide_deep_scores(params, batch, cfg, ctx=None):
    emb = _lookup(params, batch["sparse"], cfg, ctx)  # (B, F, D)
    b = emb.shape[0]
    deep = _mlp_apply(params["deep"], emb.reshape(b, -1))[:, 0]
    rows = batch["sparse"].long() + _offsets(cfg, emb.device)[None, :]
    wide = sharded_lookup(params["wide"], rows, ctx, mode=cfg.lookup_mode)
    return deep + wide[..., 0].sum(dim=-1)


# ---------------------------------------------------------------------------
# SASRec — self-attentive sequential recommendation
# ---------------------------------------------------------------------------


def _sasrec_encode(params, seq_rows, cfg, ctx):
    emb = sharded_lookup(params["embed"], seq_rows.long(), ctx, mode=cfg.lookup_mode)
    x = emb + params["pos"].to(emb.dtype)[None]
    b, s, d = x.shape
    hd = d // cfg.n_heads
    for blk in params["blocks"]:
        h = L.rms_norm(x, blk["ln1"])
        q = (h @ blk["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
        k = (h @ blk["wk"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
        v = (h @ blk["wv"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
        x = x + L.causal_attention(q, k, v, q_chunk=s).reshape(b, s, d)
        h = L.rms_norm(x, blk["ln2"])
        x = x + torch.relu(h @ blk["w1"].to(x.dtype)) @ blk["w2"].to(x.dtype)
    return L.rms_norm(x, params["ln_f"])


def sasrec_scores(params, batch, cfg, ctx=None):
    """Score the target item against the sequence-final user state."""
    user = _sasrec_encode(params, batch["seq"], cfg, ctx)[:, -1]  # (B, D)
    target = sharded_lookup(params["embed"], batch["target"].long()[:, None], ctx,
                            mode=cfg.lookup_mode)[:, 0]
    return (user * target).sum(dim=-1)


# ---------------------------------------------------------------------------
# Unified entry points
# ---------------------------------------------------------------------------

_SCORERS = {
    "dlrm": dlrm_scores,
    "din": din_scores,
    "wide_deep": wide_deep_scores,
    "sasrec": sasrec_scores,
}


def score_fn(params, batch, cfg: RecsysConfig, ctx=None):
    """(B,) logits of a serving batch (``sparse``, plus ``dense`` for
    DLRM and ``hist`` for DIN; ``seq`` and ``target`` for SASRec)."""
    return _SCORERS[cfg.kind](params, batch, cfg, ctx)


def loss_fn(params, batch, cfg: RecsysConfig, ctx=None):
    """Mean binary cross entropy of :func:`score_fn`'s logits against
    ``batch["label"]``, in the stable form ``max(z, 0) - z*y +
    log1p(exp(-|z|))``, in f32."""
    z = score_fn(params, batch, cfg, ctx).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    return torch.mean(loss)


def _din_retrieval(params, batch, cfg, ctx):
    """DIN's candidates in chunks of :data:`DIN_RETRIEVAL_CHUNK`.  As the
    reference does (``recsys.py:283-285``), the profile row is
    ``sparse[:, 1]`` without field 1's offset: it reads the item table
    where :func:`din_scores` reads the profile table (ROADMAP queue 3)."""
    mode = cfg.lookup_mode
    hist = sharded_lookup(params["embed"], batch["hist"].long(), ctx, mode=mode)  # (1, S, D)
    profile = sharded_lookup(params["embed"], batch["sparse"].long()[:, 1:2], ctx, mode=mode)[:, 0]
    cvecs = sharded_lookup(params["embed"], batch["candidates"].long()[None, :], ctx, mode=mode)[0]
    out = []
    for tgt in torch.split(cvecs, DIN_RETRIEVAL_CHUNK):
        n = tgt.shape[0]
        interest = _din_interest(params, hist.expand((n,) + tuple(hist.shape[1:])), tgt)
        x = torch.cat([interest, tgt, profile.expand(n, profile.shape[-1])], dim=-1)
        out.append(_mlp_apply(params["mlp"], x)[:, 0])
    return torch.cat(out)


def retrieval_fn(params, batch, cfg: RecsysConfig, ctx=None):
    """Score one user context against ``batch["candidates"]`` (N,) items,
    the user side computed once."""
    cands = batch["candidates"].long()
    if cfg.kind == "sasrec":
        user = _sasrec_encode(params, batch["seq"], cfg, ctx)[0, -1]  # (D,)
        cvecs = sharded_lookup(params["embed"], cands[None, :], ctx, mode=cfg.lookup_mode)[0]
        return cvecs @ user
    if cfg.kind == "din":
        return _din_retrieval(params, batch, cfg, ctx)
    # dlrm / wide_deep: vary one item field over the candidates
    n = cands.shape[0]
    sparse = batch["sparse"].long().expand(n, cfg.n_sparse).clone()
    sparse[:, 0] = cands
    b2 = {"sparse": sparse}
    if cfg.kind == "dlrm":
        b2["dense"] = batch["dense"].expand(n, cfg.n_dense)
    return score_fn(params, b2, cfg, ctx)


__all__ = ["CRITEO_VOCABS", "DIN_RETRIEVAL_CHUNK", "RecsysConfig", "field_offsets", "init",
           "local_params", "loss_fn", "params_from_numpy", "retrieval_fn", "score_fn"]
