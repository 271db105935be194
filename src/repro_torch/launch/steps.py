"""Per-(arch x shape-cell) steps (counterpart of ``repro.launch.steps``).

For a cell this module gives:
  * ``make_inputs(spec, cell, rng)`` — the cell's batch, from the same
    numpy draws as the reference's ``concrete_inputs`` (one seed gives
    both packages identical batches), as tensors on the card unless
    ``device`` says otherwise;
  * ``build_step(spec, cell, ctx, tcfg)`` — the cell's step function and
    its config (a ``train`` cell's also its ``init_fn``).

Kinds: ``train`` a full optimizer step (:func:`repro_torch.train.make_train_step`
over the family's ``loss_fn``); ``prefill`` a full-sequence forward that
returns the last position's logits; ``decode`` one token against a KV
cache; ``serve`` and ``retrieval`` the recsys scorers.  DimeNet's
``graph_train`` cells wait for the DimeNet slice (ROADMAP queue 1, item
13.5); the reference's sharding pytrees (``state_shardings``,
``fit_sharding``) and its abstract inputs wait for the launch slice
(item 13.6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import recsys, transformer
from repro_torch.train import TrainConfig, make_train_step

#: the cell kinds this module builds
KINDS = ("train", "prefill", "decode", "serve", "retrieval")


def _not_ported(spec, cell):
    return NotImplementedError(
        f"{spec.arch_id}/{cell.name}: {cell.kind!r} cells wait for the DimeNet slice "
        f"(ROADMAP queue 1, item 13.5); the port builds {KINDS}")


def _lm_inputs(cfg, cell, rng):
    b, s = cell.dims["global_batch"], cell.dims["seq_len"]
    if cell.kind == "train":
        names, shape = ("tokens", "labels"), (b, s)
    else:
        names, shape = ("tokens",), ((b, s) if cell.kind == "prefill" else (b, 1))
    return {k: rng.integers(0, cfg.vocab, size=shape).astype(np.int32) for k in names}


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
    if cell.kind not in KINDS:
        raise _not_ported(spec, cell)
    rng = rng or np.random.default_rng(0)
    dev = resolve_device(device)
    if spec.family == "lm":
        arrays = _lm_inputs(spec.config, cell, rng)
    elif spec.family == "recsys":
        arrays = _recsys_inputs(spec.config, cell, rng)
    else:
        raise _not_ported(spec, cell)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


@dataclass
class StepBundle:
    """A cell's function and config.  ``fn`` takes ``(params, batch)``; a
    ``decode`` cell's takes ``(params, cache, batch, pos)``, a ``train``
    cell's ``(state, batch)`` and returns ``(state, metrics)``, and its
    ``init_fn(gen)`` draws the parameters (for ``init_train_state``)."""

    fn: object
    cfg: object
    kind: str
    init_fn: object = None


def build_step(spec, cell, ctx=None, tcfg: TrainConfig | None = None) -> StepBundle:
    """The function of ``cell`` on ``spec``'s config: ``train`` is
    ``make_train_step(tcfg)`` (default ``TrainConfig()``) over
    ``transformer.loss_fn`` or ``recsys.loss_fn`` (on one rank);
    ``prefill`` runs ``transformer.forward`` and returns ``h[:, -1] @
    head`` in f32; ``decode`` is ``transformer.decode_step``; ``serve``
    and ``retrieval`` are ``recsys.score_fn`` and ``recsys.retrieval_fn``
    (under ``ctx``, on each rank's row shard).  ``graph_train`` raises
    ``NotImplementedError``."""
    cfg = spec.config
    if cell.kind not in KINDS:
        raise _not_ported(spec, cell)
    if cell.kind == "train":
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
            raise ValueError((spec.family, cell.kind))
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
    elif spec.family == "recsys" and cell.kind == "retrieval":
        def fn(params, batch):
            return recsys.retrieval_fn(params, batch, cfg, ctx)
    else:
        raise ValueError((spec.family, cell.kind))
    return StepBundle(fn=fn, cfg=cfg, kind=cell.kind)
