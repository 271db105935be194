"""DimeNet (directional message passing, arXiv:2003.03123): counterpart of
``repro.models.dimenet``.

Messages live on directed edges and interact over (k->j->i) triplets with
a radial (RBF) and an angular (SBF) basis: an embedding block,
``n_blocks`` interaction blocks with the bilinear triplet contraction
(``n_bilinear``), and a per-block output block from edges to nodes.  As
the reference does, the angular basis is cos(l·θ) x Bessel products
instead of spherical harmonics, and non-molecular graphs take positions
from a random projection of their features (:func:`synth_positions`)
with at most ``t_max`` triplets an edge.

No kernel lies on this path in either package: the reference's message
passing is ``jnp.take``, ``segment_sum``, einsums and dense products
outside any Pallas call, and here it is ``index_select``, ``index_add``
and matrix products.  The padded layout rounds the edge vectors and the
messages to bf16 before its gathers, as the reference does on one
device as on many.  The three-operand bilinear einsum is written as two
products, so that no intermediate exceeds ``(rows, n_bilinear * d)``
(``torch.einsum`` contracts left to right, and ``a · w_bil`` first would
make a ``(rows, d, d)`` tensor: 44 GB a block at ``minibatch_lg``'s full
width).

Entry points:
  init(gen, cfg)                              -> params
  params_from_numpy(tree, cfg, device=None)   -> params
  forward(params, batch, cfg, ctx=None)       -> (n_graphs|N, n_out) or (n_graphs,)
  loss_fn(params, batch, cfg, ctx=None)       -> scalar f32 loss
  build_triplets / build_triplets_padded      -> host numpy triplet lists

Each runs on the device of its parameters.

Edge sharding (the reference's ``shard_map`` over the ``edge`` axes,
``repro/models/dimenet.py:184-297``).  Under a context whose ``edge``
axis spans ``n`` ranks, every rank is given the same whole batch (the
reference's global arrays) and works on its block of the arrays the
reference places over ``edge``: its ``E/n`` edges, rows ``[r E/n, (r + 1)
E/n)`` for the rank at index ``r``, with the padded layout's triplet rows
beside them, or the flat layout's ``T/n`` triplets ``[r T/n, (r + 1)
T/n)`` (the reference's even split of ``tri_kj``/``tri_ji``):

* one all-gather of the edge vectors for the geometry (bf16 in the
  padded layout, as the reference's; f32 in the flat one, whose
  reference gathers are f32);
* one all-gather of the messages for each block's interaction (bf16
  padded, f32 flat); the flat layout's triplet sums land on any edge, so
  each block also reduce-scatters its ``(E, d)`` aggregate to the edges'
  ranks;
* a psum over ``edge`` of each block's node aggregate.

Each all-gather's backward is a reduce-scatter in the same dtype (a
reduce-scatter's an all-gather), the psum's a psum (``dist.collectives``),
so every rank's gradient is ``n`` times the gradient of its part and the
train step sums them over ``edge`` and divides by ``n``.  Every shape is
static (the dry run runs this path on fake tensors).  An edge or triplet
count that ``n`` does not divide runs whole on every rank
(``fit_sharding``'s fallback).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.dist import collectives

from . import layers as L


@dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    n_species: int = 95  # atom-type vocabulary (molecule cells)
    d_feat: int = 0  # >0: project raw features instead of species embed
    n_out: int = 1  # 1 = energy regression; >1 = node classification
    n_graphs: int = 0  # >0: batched-small-graphs (molecule) readout
    # "flat": (T,) triplet index lists; "padded": (E, t_max) rows + mask,
    # every triplet beside its target edge, aggregated by a row sum
    triplet_layout: str = "flat"
    t_max: int = 4
    dtype: str = "float32"

    @property
    def n_sbf(self) -> int:
        return self.n_spherical * self.n_radial


def _envelope(d, cutoff, p):
    """DimeNet's polynomial envelope u(d) (a smooth cutoff)."""
    x = d / cutoff
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    env = 1.0 / torch.clamp(x, min=1e-9) + a * x ** (p - 1) + b * x**p + c * x ** (p + 1)
    return torch.where(x < 1.0, env, torch.zeros_like(env))


def rbf_basis(d, cfg: DimeNetConfig):
    """Bessel radial basis: (E,) distances -> (E, n_radial)."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32, device=d.device)
    env = _envelope(d, cfg.cutoff, cfg.envelope_p)
    return env[:, None] * torch.sin(n[None, :] * math.pi * d[:, None] / cfg.cutoff)


def sbf_basis(d_kj, angle, cfg: DimeNetConfig):
    """Angular x radial basis: (T,) distances and angles -> (T, n_spherical * n_radial)."""
    l = torch.arange(cfg.n_spherical, dtype=torch.float32, device=d_kj.device)
    radial = rbf_basis(d_kj, cfg)
    angular = torch.cos(l[None, :] * angle[:, None])  # (T, n_spherical)
    return (angular[:, :, None] * radial[:, None, :]).reshape(d_kj.shape[0], -1)


def init(gen: torch.Generator, cfg: DimeNetConfig):
    """Random parameters drawn from ``gen`` on its device, in the
    reference's layout (``blocks`` a list of dicts).  The reference's
    ``jax.random`` draws cannot be reproduced; carry its weights across
    with :func:`params_from_numpy`."""
    dt = L.dtype_of(cfg.dtype)
    d = cfg.d_hidden

    def dense(i, o):
        return L.dense_init(gen, (i, o), dt)

    params = {
        "embed_z": L.embed_init(gen, (cfg.n_species, d), dt) if cfg.d_feat == 0
        else dense(cfg.d_feat, d),
        "emb_rbf": dense(cfg.n_radial, d),
        "emb_msg": dense(3 * d, d),
        "out_final": dense(d, cfg.n_out),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        w_bil = torch.randn((cfg.n_bilinear, d, d), generator=gen, dtype=torch.float32,
                            device=gen.device) * 0.01
        params["blocks"].append({
            "w_msg": dense(d, d),
            "w_kj": dense(d, d),
            "w_sbf": dense(cfg.n_sbf, cfg.n_bilinear),
            "w_bil": w_bil.to(dt),
            "w_rbf_g": dense(cfg.n_radial, d),
            "w_up": dense(d, d),
            "w_res1": dense(d, d),
            "w_res2": dense(d, d),
            "w_out_rbf": dense(cfg.n_radial, d),
            "w_out": dense(d, d),
        })
    return params


def params_from_numpy(np_params, cfg: DimeNetConfig, device=None):
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, repro_params)``) as tensors on ``device``
    (the card when None), ``blocks`` kept as a list of ``cfg.n_blocks``."""
    if len(np_params["blocks"]) != cfg.n_blocks:
        raise ValueError(f"{len(np_params['blocks'])} blocks, the config has {cfg.n_blocks}")
    return tree.tree_from_numpy(np_params, resolve_device(device))


def synth_positions(feat_or_n, seed: int = 0):
    """Positions for non-molecular graphs: a random 3-D projection of the
    features (or random coordinates when only a node count is given)."""
    rng = np.random.default_rng(seed)
    if isinstance(feat_or_n, int):
        return rng.normal(0, 2.0, size=(feat_or_n, 3)).astype(np.float32)
    feat = np.asarray(feat_or_n)
    proj = rng.normal(0, 1.0 / np.sqrt(feat.shape[1]), size=(feat.shape[1], 3))
    return (feat @ proj).astype(np.float32)


def _incoming(src, dst, n_nodes):
    """Each edge's source node's incoming edges: ``order`` (the edges
    sorted stably by ``dst``), and for every edge ``ji`` the start
    ``lo[ji]`` and count ``deg[ji]`` of its node ``src[ji]``'s run in it."""
    order = np.argsort(dst, kind="stable")
    start = np.searchsorted(dst[order], np.arange(n_nodes + 1))
    lo = start[src]
    return order, lo, start[src + 1] - lo


def build_triplets_padded(src: np.ndarray, dst: np.ndarray, n_nodes: int, t_max: int = 4):
    """Padded (E, t_max) triplet rows: row ``ji`` holds the first ``t_max``
    incoming edges k->j of its source node j with k != i (in edge order),
    and a validity mask.  One pass a position in the incoming runs, over
    the rows still open, gives the reference's loop's arrays."""
    src, dst = np.asarray(src), np.asarray(dst)
    e = len(src)
    order, lo, deg = _incoming(src, dst, n_nodes)
    tri = np.zeros((e, t_max), dtype=np.int32)
    mask = np.zeros((e, t_max), dtype=np.float32)
    filled = np.zeros(e, dtype=np.int64)
    rows = np.nonzero(deg > 0)[0] if t_max > 0 else np.zeros(0, np.int64)
    p = 0
    while rows.size:
        kj = order[lo[rows] + p]
        ok = src[kj] != dst[rows]
        took = rows[ok]
        tri[took, filled[took]] = kj[ok]
        mask[took, filled[took]] = 1.0
        filled[took] += 1
        p += 1
        rows = rows[(filled[rows] < t_max) & (deg[rows] > p)]
    return tri, mask


def build_triplets(src: np.ndarray, dst: np.ndarray, n_nodes: int, t_max: int = 4):
    """Flat triplet index lists ``(tri_kj, tri_ji)``: for every edge ``ji``
    (in order), its source node's first ``t_max`` incoming edges k->j,
    those with k != i kept.  ``([0], [0])`` when there are none."""
    src, dst = np.asarray(src), np.asarray(dst)
    e = len(src)
    order, lo, deg = _incoming(src, dst, n_nodes)
    pos = np.arange(t_max)[None, :]
    valid = pos < np.minimum(deg, t_max)[:, None]  # (E, t_max)
    kj = order[np.where(valid, lo[:, None] + pos, 0)]
    ji = np.broadcast_to(np.arange(e)[:, None], valid.shape)
    keep = valid & (src[kj] != dst[ji])
    if not keep.any():
        return np.zeros(1, np.int32), np.zeros(1, np.int32)
    return kj[keep].astype(np.int32), ji[keep].astype(np.int32)


def _edge_split(ctx, batch):
    """``(group, index, n)`` of this rank along ``edge`` under ``ctx``, or
    None when the work is not split (no context, one rank, or ``n`` does
    not divide the edge or the flat triplet count)."""
    n = 1 if ctx is None else ctx.n("edge")
    counts = (batch["edge_src"].shape[0], batch["tri_kj"].shape[0])
    if n == 1 or any(c % n for c in counts):
        return None
    return ctx.group("edge"), ctx.index("edge"), n


def _block(x, r: int, n: int):
    rows = x.shape[0] // n
    return x[r * rows:(r + 1) * rows]


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _cos_angle(v_ji, v_kj):
    cos = torch.sum(v_ji * v_kj, dim=-1) / (_norm(v_ji) * _norm(v_kj) + 1e-9)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def _bilinear(a, w_bil, x_kj):
    """``einsum("rb,bdf,rf->rd", a, w_bil, x_kj)`` over rows ``r`` as
    ``(x_kj @ W)`` with ``W = w_bil`` laid out ``(f, b·d)``, then a batched
    ``(1, b) @ (b, d)`` a row: the largest intermediate is ``(rows, b·d)``."""
    nb, d, f = w_bil.shape
    rows = x_kj.shape[0]
    y = x_kj @ w_bil.permute(2, 0, 1).reshape(f, nb * d)  # (rows, b·d)
    return torch.bmm(a.reshape(rows, 1, nb), y.reshape(rows, nb, d)).reshape(rows, d)


def _padded_geometry(vec, vg, tri_kj, cfg: DimeNetConfig):
    """sbf of the padded layout, (E, t_max, n_sbf) for this rank's rows:
    the k->j edge vectors gathered from ``vg``, the bf16 copy of every
    edge's vector (as the reference's all-gather rounds them), the j->i
    vectors ``vec`` in f32."""
    e, t = tri_kj.shape
    v_kj = -vg.index_select(0, tri_kj.reshape(-1)).to(torch.float32).reshape(e, t, 3)
    v_ji = vec.to(torch.float32)[:, None, :]
    ang = _cos_angle(v_ji, v_kj)  # (E, t)
    d_kj = _norm(v_kj)
    return sbf_basis(d_kj.reshape(-1), ang.reshape(-1), cfg).reshape(e, t, -1)


def _padded_interaction(mg, sbf, tri_kj, blk, dt):
    """Per-edge triplet aggregation of the padded layout for this rank's
    rows: the messages gathered from ``mg``, the bf16 copy of every
    edge's message, the bilinear contraction, a row sum (the pad
    triplets are zero through ``sbf``'s mask factor)."""
    e, t = tri_kj.shape
    mg = mg.index_select(0, tri_kj.reshape(-1)).to(dt)  # (E·t, d)
    x_kj = F.silu(mg @ blk["w_kj"].to(dt))
    a = sbf.reshape(e * t, -1) @ blk["w_sbf"].to(dt)  # (E·t, n_bilinear)
    tri = _bilinear(a, blk["w_bil"].to(dt), x_kj)
    return tri.reshape(e, t, -1).sum(dim=1)


def _segment_sum(x, seg, n):
    return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device).index_add(
        0, seg, x)


def forward(params, batch, cfg: DimeNetConfig, ctx=None):
    """batch: pos (N, 3), z (N,) or feat (N, F), edge_src/edge_dst (E,),
    the triplets (flat: tri_kj/tri_ji (T,); padded: tri_kj/tri_mask (E,
    t_max) and edge_mask (E,)), node_graph (N,) -> (N, n_out), or
    (n_graphs,) energies for a molecule readout.  Under an edge-sharded
    ``ctx`` every rank returns the same output (module docstring)."""
    dt = L.dtype_of(cfg.dtype)
    pos = batch["pos"].to(dt)
    n_nodes = pos.shape[0]
    split = _edge_split(ctx, batch)
    group, r, n = split if split else (None, 0, 1)

    def mine(x):  # this rank's block of an edge-placed array
        return _block(x, r, n) if split else x

    def gather(x):  # every rank's block of ``x``, in ``x``'s dtype
        return collectives.all_gather(x, group) if split else x

    src, dst = mine(batch["edge_src"]).long(), mine(batch["edge_dst"]).long()
    if cfg.d_feat:
        h = batch["feat"].to(dt) @ params["embed_z"].to(dt)
    else:
        h = params["embed_z"].index_select(0, batch["z"].long()).to(dt)

    vec = pos.index_select(0, dst) - pos.index_select(0, src)  # (E, 3)
    dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-9)
    rbf = rbf_basis(dist, cfg).to(dt)  # (E, n_radial)

    padded = cfg.triplet_layout == "padded"
    tri_kj = mine(batch["tri_kj"]).long()
    if padded:
        sbf = _padded_geometry(vec, gather(vec.to(torch.bfloat16)), tri_kj, cfg).to(dt)
        sbf = sbf * mine(batch["tri_mask"])[..., None].to(dt)  # (E, t_max, n_sbf)
    else:
        tri_ji = mine(batch["tri_ji"]).long()
        vec_all = gather(vec)
        dist_all = torch.sqrt(torch.sum(vec_all * vec_all, dim=-1) + 1e-9) if split else dist
        # angles of the triplets k->j->i: between edge kj and edge ji
        angle = _cos_angle(vec_all.index_select(0, tri_ji), -vec_all.index_select(0, tri_kj))
        sbf = sbf_basis(dist_all.index_select(0, tri_kj), angle, cfg).to(dt)  # (T, n_sbf)

    # embedding block: directed edge messages
    emb = torch.cat([h.index_select(0, src), h.index_select(0, dst),
                     rbf @ params["emb_rbf"].to(dt)], dim=-1)
    m = F.silu(emb @ params["emb_msg"].to(dt))  # (E, d)
    if "edge_mask" in batch:  # padded layout: pad edges carry no message
        m = m * mine(batch["edge_mask"])[:, None].to(dt)

    node_out = torch.zeros((n_nodes, cfg.d_hidden), dtype=dt, device=pos.device)
    for blk in params["blocks"]:
        if padded:
            agg = _padded_interaction(gather(m.to(torch.bfloat16)), sbf, tri_kj, blk, dt)
        else:
            m_all = gather(m)
            x_kj = F.silu(m_all.index_select(0, tri_kj) @ blk["w_kj"].to(dt))
            a = sbf @ blk["w_sbf"].to(dt)  # (T, n_bilinear)
            agg = _segment_sum(_bilinear(a, blk["w_bil"].to(dt), x_kj), tri_ji, m_all.shape[0])
            if split:  # the triplet sums of every rank, for this rank's edges
                agg = collectives.reduce_scatter(agg, group)
        g = rbf @ blk["w_rbf_g"].to(dt)
        x = F.silu(m @ blk["w_msg"].to(dt)) * g + agg @ blk["w_up"].to(dt)
        x = x + F.silu(x @ blk["w_res1"].to(dt)) @ blk["w_res2"].to(dt)
        m = m + x  # residual edge-message update
        # output block: edges -> nodes, summed over the edge ranks
        contrib = (rbf @ blk["w_out_rbf"].to(dt)) * m
        nodes = _segment_sum(contrib, dst, n_nodes)
        if split:
            nodes = collectives.psum_if_mapped(nodes, ctx.mesh_axes("edge"), ctx)
        node_out = node_out + nodes @ blk["w_out"].to(dt)

    out = node_out @ params["out_final"].to(dt)  # (N, n_out)
    if cfg.n_out == 1 and cfg.n_graphs > 0:  # molecule energy readout
        return _segment_sum(out[:, 0], batch["node_graph"].long(), cfg.n_graphs)
    return out


def loss_fn(params, batch, cfg: DimeNetConfig, ctx=None):
    """Mean squared error of the energies (``n_out == 1``), else the
    masked mean cross entropy of the node logits, in f32."""
    out = forward(params, batch, cfg, ctx)
    if cfg.n_out == 1:
        err = out.to(torch.float32) - batch["target"].to(torch.float32)
        return torch.mean(err * err)
    logits = out.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[:, None])[:, 0]
    mask = batch.get("label_mask")
    mask = torch.ones_like(gold) if mask is None else mask.to(torch.float32)
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
