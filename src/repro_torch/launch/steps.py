"""Per-(arch x shape-cell) steps (counterpart of ``repro.launch.steps``).

For a cell this module gives:
  * ``make_inputs(spec, cell, rng)`` — the cell's batch, from the same
    numpy draws as the reference's ``concrete_inputs`` (one seed gives
    both packages identical batches), as tensors on the card unless
    ``device`` says otherwise;
  * ``build_step(spec, cell, ctx, tcfg)`` — the cell's step function and
    its config (a ``train`` or ``graph_train`` cell's also its ``init_fn``).

Kinds: ``train`` and ``graph_train`` a full optimizer step
(:func:`repro_torch.train.make_train_step` over the family's ``loss_fn``:
the LM and recsys ``train`` cells, DimeNet's ``graph_train`` cells);
``prefill`` a full-sequence forward that returns the last position's
logits; ``decode`` one token against a KV cache; ``serve`` and
``retrieval`` the recsys scorers.  The reference's sharding pytrees
(``state_shardings``, ``fit_sharding``) and its abstract inputs wait for
the launch slice (ROADMAP queue 1, item 13.6).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import dimenet, recsys, transformer
from repro_torch.train import TrainConfig, make_train_step

#: the cell kinds this module builds, by family
KINDS = {"lm": ("train", "prefill", "decode"), "gnn": ("graph_train",),
         "recsys": ("train", "serve", "retrieval")}


def _check_kind(spec, cell):
    """``ValueError((family, kind))`` for a cell whose kind its family has
    no step for, as the reference's ``build_step`` raises."""
    if cell.kind not in KINDS.get(spec.family, ()):
        raise ValueError((spec.family, cell.kind))


def _lm_inputs(cfg, cell, rng):
    b, s = cell.dims["global_batch"], cell.dims["seq_len"]
    if cell.kind == "train":
        names, shape = ("tokens", "labels"), (b, s)
    else:
        names, shape = ("tokens",), ((b, s) if cell.kind == "prefill" else (b, 1))
    return {k: rng.integers(0, cfg.vocab, size=shape).astype(np.int32) for k in names}


def _gnn_inputs(cfg, cell, rng):
    """The reference's ``_gnn_inputs`` draws, in its order: ``src``,
    ``dst``, ``pos``, then the triplets (host numpy), then the node data.
    The padded layout rounds the edge count up to a multiple of 512 before
    the draws and masks no edge; the flat layout pads its triplets with
    ``(0, 0)`` (unmasked, as the reference's are) or cuts them to
    ``n_edges * t_max``."""
    d = cell.dims
    n, e = d["n_nodes"], d["n_edges"]
    t_max = d.get("t_max", 4)
    t = e * t_max
    padded = cfg.triplet_layout == "padded"
    if padded:
        e = ((e + 511) // 512) * 512  # the reference's even edge shards
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    batch = {"pos": rng.normal(0, 2, (n, 3)).astype(np.float32),
             "edge_src": src, "edge_dst": dst}
    if padded:
        batch["tri_kj"], batch["tri_mask"] = dimenet.build_triplets_padded(src, dst, n, t_max)
        batch["edge_mask"] = np.ones((e,), np.float32)
    else:
        tri_kj, tri_ji = dimenet.build_triplets(src, dst, n, t_max)
        if len(tri_kj) < t:
            pad = np.zeros(t - len(tri_kj), np.int32)
            tri_kj, tri_ji = np.concatenate([tri_kj, pad]), np.concatenate([tri_ji, pad])
        batch["tri_kj"], batch["tri_ji"] = tri_kj[:t], tri_ji[:t]
    if d.get("energy"):
        ng = d["n_graphs"]
        batch["z"] = rng.integers(0, cfg.n_species, n).astype(np.int32)
        batch["node_graph"] = np.sort(rng.integers(0, ng, n)).astype(np.int32)
        batch["target"] = rng.normal(0, 1, ng).astype(np.float32)
    else:
        batch["feat"] = rng.normal(0, 1, (n, d["d_feat"])).astype(np.float32)
        batch["labels"] = rng.integers(0, d["n_out"], n).astype(np.int32)
        batch["label_mask"] = (rng.random(n) < 0.5).astype(np.float32)
    return batch


def _recsys_inputs(cfg, cell, rng):
    """The reference's ``_recsys_inputs`` draws, in its key order."""
    b = cell.dims["batch"]
    shp = {"sparse": ((b, cfg.n_sparse), np.int32)}
    if cfg.kind == "dlrm":
        shp["dense"] = ((b, cfg.n_dense), np.float32)
    if cfg.kind == "din":
        shp["hist"] = ((b, cfg.seq_len), np.int32)
    if cfg.kind == "sasrec":
        shp = {"seq": ((b, cfg.seq_len), np.int32), "target": ((b,), np.int32)}
    if cell.kind == "train":
        shp["label"] = ((b,), np.float32)
    if cell.kind == "retrieval":
        shp["candidates"] = ((cell.dims["n_candidates"],), np.int32)
    out = {}
    for k, (sh, dt) in shp.items():
        if dt == np.int32 and k == "sparse":
            cols = [rng.integers(0, v, size=(sh[0], 1)) for v in cfg.vocab_sizes]
            out[k] = np.concatenate(cols, 1).astype(np.int32)
        elif dt == np.int32:
            out[k] = rng.integers(0, cfg.vocab_sizes[0], size=sh).astype(np.int32)
        else:
            out[k] = rng.normal(0, 1, sh).astype(np.float32)
    if cell.kind == "train":
        # the reference draws the label as a normal first, then replaces
        # it: both draws are made, so the next batch's draws line up
        out["label"] = (rng.random(b) < 0.3).astype(np.float32)
    return out


def make_inputs(spec, cell, rng=None, *, device=None) -> dict:
    """The batch of a cell as tensors on ``device`` (default: the card),
    drawn from ``rng`` (default ``np.random.default_rng(0)``) as the
    reference draws it."""
    _check_kind(spec, cell)
    rng = rng or np.random.default_rng(0)
    dev = resolve_device(device)
    if spec.family == "lm":
        arrays = _lm_inputs(spec.config, cell, rng)
    elif spec.family == "gnn":
        arrays = _gnn_inputs(_cfg_for_cell(spec, cell), cell, rng)
    else:
        arrays = _recsys_inputs(spec.config, cell, rng)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def _cfg_for_cell(spec, cell):
    """The config a cell runs: a ``graph_train`` cell sets DimeNet's
    readout (energies of ``n_graphs`` molecules, or ``n_out`` node classes
    over ``d_feat`` features) and ``t_max`` from its dims."""
    cfg = spec.config
    if spec.family == "gnn" and cell.kind == "graph_train":
        d = cell.dims
        if d.get("energy"):
            cfg = replace(cfg, n_out=1, n_graphs=d["n_graphs"], d_feat=0, t_max=d.get("t_max", 4))
        else:
            cfg = replace(cfg, n_out=d["n_out"], d_feat=d["d_feat"], n_graphs=0,
                          t_max=d.get("t_max", 4))
    return cfg


@dataclass
class StepBundle:
    """A cell's function and config.  ``fn`` takes ``(params, batch)``; a
    ``decode`` cell's takes ``(params, cache, batch, pos)``, a ``train``
    or ``graph_train`` cell's ``(state, batch)`` and returns ``(state,
    metrics)``, and its ``init_fn(gen)`` draws the parameters (for
    ``init_train_state``)."""

    fn: object
    cfg: object
    kind: str
    init_fn: object = None


def build_step(spec, cell, ctx=None, tcfg: TrainConfig | None = None) -> StepBundle:
    """The function of ``cell`` on ``spec``'s config: ``train`` is
    ``make_train_step(tcfg)`` (default ``TrainConfig()``) over
    ``transformer.loss_fn`` or ``recsys.loss_fn`` (on one rank), and
    ``graph_train`` the same over ``dimenet.loss_fn`` on the cell's config
    (:func:`_cfg_for_cell`); ``prefill`` runs ``transformer.forward`` and
    returns ``h[:, -1] @ head`` in f32; ``decode`` is
    ``transformer.decode_step``; ``serve`` and ``retrieval`` are
    ``recsys.score_fn`` and ``recsys.retrieval_fn`` (under ``ctx``, on each
    rank's row shard).  A kind the family has no step for raises
    ``ValueError((family, kind))``."""
    _check_kind(spec, cell)
    cfg = _cfg_for_cell(spec, cell)
    if cell.kind in ("train", "graph_train"):
        if spec.family == "lm":
            def loss(params, batch):
                return transformer.loss_fn(params, batch, cfg)

            def init_fn(gen):
                return transformer.init(gen, cfg)
        elif spec.family == "recsys":
            def loss(params, batch):
                return recsys.loss_fn(params, batch, cfg, ctx)

            def init_fn(gen):
                return recsys.init(gen, cfg, ctx)
        else:
            def loss(params, batch):
                return dimenet.loss_fn(params, batch, cfg, ctx)

            def init_fn(gen):
                return dimenet.init(gen, cfg)
        return StepBundle(fn=make_train_step(loss, tcfg or TrainConfig()), cfg=cfg,
                          kind=cell.kind, init_fn=init_fn)
    if spec.family == "lm" and cell.kind == "prefill":
        def fn(params, batch):
            # the full-sequence forward; only the last position's logits
            # leave the step, the (B, S, V) logits are never made
            h = transformer.forward(params, batch["tokens"], cfg)
            return (h[:, -1] @ params["head"].to(h.dtype)).float()
    elif spec.family == "lm" and cell.kind == "decode":
        def fn(params, cache, batch, pos):
            return transformer.decode_step(params, cache, batch["tokens"], pos, cfg)
    elif spec.family == "recsys" and cell.kind == "serve":
        def fn(params, batch):
            return recsys.score_fn(params, batch, cfg, ctx)
    else:
        def fn(params, batch):
            return recsys.retrieval_fn(params, batch, cfg, ctx)
    return StepBundle(fn=fn, cfg=cfg, kind=cell.kind)
