"""Optimizers from scratch: AdamW and Adafactor (counterpart of
``repro.train.optimizer``).

Moments are f32 whatever the parameter dtype.  The arithmetic is the
reference's, written literally: the bias corrections are f32 powers of
an f32 step, ε sits outside the square root, weight decay is added to
the update, and the f32 result is cast back to the parameter's dtype.
(``torch.optim.AdamW`` places ε and the decay otherwise and rounds its
scalars in f64, so it is not used.)  The API is the reference's
``(init, update)`` pair, so the train step stays generic; trees are
walked in ``jax.tree_util``'s order (:mod:`repro_torch.tree`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params):
    dev = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params):
    return {"step": _step0(params), "m": tree.tree_map(_zeros_f32, params),
            "v": tree.tree_map(_zeros_f32, params)}


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m_n = b1 * m + (1 - b1) * g32
        v_n = b2 * v + (1 - b2) * g32 * g32
        mh = m_n / bc1
        vh = v_n / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p_n = p.to(torch.float32) - lr * delta
        return m_n, v_n, p_n.to(p.dtype)

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree.leaves(grads), tree.leaves(state["m"]), tree.leaves(state["v"]),
        tree.leaves(params))]
    return (tree.unflatten(grads, [o[2] for o in out]),
            {"step": step, "m": tree.unflatten(grads, [o[0] for o in out]),
             "v": tree.unflatten(grads, [o[1] for o in out])})


# ---------------------------------------------------------------------------
# Adafactor (factored second moment: the memory-lean option at scale)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0


def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params):
    def one(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return {"v": _zeros_f32(p)}

    return {"step": _step0(params), "v": tree.tree_map(one, params)}


class _Whole:
    """Reductions of one placed leaf's block to the whole leaf's (the
    reference places Adafactor's ``vr``/``vc``/``v`` whole on every rank:
    their paths match no parameter's): a block's partial sums laid at its
    offsets in zeros of the whole shape and summed over the axes that split
    the leaf; the whole moments cut back to the block."""

    def __init__(self, placed, ctx):
        from repro_torch.dist.sharding import NamedSharding, PartitionSpec, split_axes

        self.ctx, self.shape = ctx, placed.shape
        self.axes = split_axes(placed.sharding)
        spec = tuple(placed.sharding.spec)
        self.coord = ctx.coordinate()

        def cut(keep):
            return NamedSharding(placed.sharding.mesh, PartitionSpec(*[spec[i] for i in keep]))

        n = len(self.shape)
        self.rows = cut(range(n - 1))  # the shape of a mean over the last dim
        self.cols = cut([i for i in range(n) if i != n - 2])  # over the one before
        self.full = placed.sharding

    def _sum(self, part, sharding, shape):
        from repro_torch.dist import collectives

        whole = torch.zeros(shape, dtype=part.dtype, device=part.device)
        sharding.local_block(whole, self.coord).copy_(part)
        return collectives.psum_if_mapped(whole, self.axes, self.ctx)

    def mean_rows(self, x):  # torch.mean(x, dim=-1) of the whole leaf
        return self._sum(x.sum(dim=-1), self.rows, self.shape[:-1]) / self.shape[-1]

    def mean_cols(self, x):  # torch.mean(x, dim=-2) of the whole leaf
        return self._sum(x.sum(dim=-2), self.cols, self.shape[:-2] + self.shape[-1:]) \
            / self.shape[-2]

    def gather(self, x):
        return self._sum(x, self.full, self.shape)

    def mean(self, x):  # torch.mean(x) of the whole leaf
        from repro_torch.dist import collectives

        return collectives.psum_if_mapped(x.sum(), self.axes, self.ctx) / math.prod(self.shape)

    def block_rows(self, w):
        return self.rows.local_block(w, self.coord)

    def block_cols(self, w):
        return self.cols.local_block(w, self.coord)

    def block(self, w):
        return self.full.local_block(w, self.coord)


@torch.no_grad()
def adafactor_update(grads, state, params, cfg: AdafactorConfig, lr_scale=1.0, *, ctx=None,
                     shardings=None):
    """One Adafactor step.  Under a placed LM (``shardings``: the nest of
    ``transformer.Placed`` of the parameters, ``ctx`` their context) the
    gradients and parameters are this rank's blocks while the second
    moments are whole, as the reference places them: a split leaf's row
    and column means, its unfactored moment and the update's RMS sum over
    the axes that split it, and its update takes the moments' block."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta = 1.0 - t ** (-cfg.decay)
    lr = cfg.lr * lr_scale

    def upd(g, v, p, pl):
        whole = None if pl is None or not any(a for _, a in pl.dims) else _Whole(pl, ctx)
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + cfg.eps
        if _factored(p.shape) and whole is None:
            vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=cfg.eps)
            u = g32 / (torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :] + cfg.eps)
            v_n = {"vr": vr, "vc": vc}
        elif _factored(p.shape):
            vr = beta * v["vr"] + (1 - beta) * whole.mean_rows(g2)
            vc = beta * v["vc"] + (1 - beta) * whole.mean_cols(g2)
            rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=cfg.eps)
            u = g32 / (torch.sqrt(whole.block_rows(rfac))[..., None]
                       * torch.sqrt(whole.block_cols(vc))[..., None, :] + cfg.eps)
            v_n = {"vr": vr, "vc": vc}
        else:
            vn = beta * v["v"] + (1 - beta) * (g2 if whole is None else whole.gather(g2))
            u = g32 / (torch.sqrt(vn if whole is None else whole.block(vn)) + cfg.eps)
            v_n = {"v": vn}
        mean_u2 = torch.mean(u * u) if whole is None else whole.mean(u * u)
        rms = torch.sqrt(mean_u2 + cfg.eps)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        return v_n, (p.to(torch.float32) - lr * u).to(p.dtype)

    # walk the v tree at the parameters' leaf positions, in their order
    placed = tree.leaves(shardings) if shardings is not None else [None] * len(tree.leaves(grads))
    out = [upd(g, v, p, pl) for g, v, p, pl in zip(
        tree.leaves(grads), tree.flatten_up_to(grads, state["v"]), tree.leaves(params), placed)]
    return (tree.unflatten(grads, [o[1] for o in out]),
            {"step": step, "v": tree.unflatten(grads, [o[0] for o in out])})


def sgd_init(params):
    return {"step": _step0(params)}


@torch.no_grad()
def sgd_update(grads, state, params, lr: float = 1e-2, lr_scale=1.0):
    ps = tree.tree_map(
        lambda p, g: (p.to(torch.float32) - lr * lr_scale * g.to(torch.float32)).to(p.dtype),
        params, grads)
    return ps, {"step": state["step"] + 1}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update, AdamWConfig),
    "adafactor": (adafactor_init, adafactor_update, AdafactorConfig),
}
