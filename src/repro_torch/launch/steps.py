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
``retrieval`` the recsys scorers.

The sharding trees, as the reference's: each family's classifier of a
parameter path (``_lm_logical``, ``_recsys_logical``, ``_gnn_logical``),
:func:`state_shardings` (moments and error buffers placed like their
parameters), :func:`fit_sharding`/:func:`fit_tree` (drop mesh axes per dim
until the dim divides) and :func:`input_shardings`, on a live or an
abstract mesh.  :func:`input_shapes` gives a cell's batch as
``(shape, dtype)`` pairs with no data (the reference's abstract inputs).
Under a context, a ``train`` or ``graph_train`` step reduces its
gradients over ranks (:func:`repro_torch.train.make_train_step`), a
recsys model's ``init_fn`` returns this rank's row shard, and an LM's
this rank's blocks of its parameters placed over ``fsdp``/``tp``/``ep``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import fit_sharding
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


# ---------------------------------------------------------------------------
# Parameter placement by path (family-specific classifiers)
# ---------------------------------------------------------------------------


def _lm_logical(path: str):
    if "moe" in path:
        if "router" in path:
            return (None, None, None)
        if "wd" in path:
            return (None, "ep", None, "fsdp")
        return (None, "ep", "fsdp", None)
    if path.endswith("embed"):
        return ("tp", "fsdp")
    if path.endswith("head"):
        return ("fsdp", "tp")
    for nm in ("wq", "wk", "wv", "wg", "wu"):
        if path.endswith(nm):
            return (None, "fsdp", "tp")
    for nm in ("wo", "wd"):
        if path.endswith(nm):
            return (None, "tp", "fsdp")
    for nm in ("bq", "bk", "bv"):
        if path.endswith(nm):
            return (None, "tp")
    return None  # norms etc: replicated


def _recsys_logical(path: str):
    if path.endswith("embed") or path.endswith("wide"):
        return ("row", None)
    return None


def _gnn_logical(path: str):
    return None  # GNN params are small: replicated


_LOGICAL = {"lm": _lm_logical, "recsys": _recsys_logical, "gnn": _gnn_logical}

#: optimizer prefixes stripped so moments shard like their params
_STATE_PREFIXES = ("opt/m/", "opt/v/", "comp_err/")


def ref_paths(t) -> list:
    """Each leaf's path as the reference's ``state_shardings`` renders it
    (dict keys bare, list positions ``[i]``, joined by ``/``), in
    flattened order."""
    paths, _ = tree.flatten_with_paths(t)
    out = []
    for p in paths:
        parts = [k[2:-2] if k.startswith("['") else k for k in p.split("/")] if p else []
        out.append("/".join(parts))
    return out


def _logical_of(path: str, ndim: int, family: str):
    for prefix in _STATE_PREFIXES:
        if path.startswith(prefix):
            path = path[len(prefix):]
    logical = _LOGICAL[family](path)
    return None if logical is None or len(logical) != ndim else logical


def param_logical(t, family: str) -> list:
    """Each leaf's logical axes (None: replicated), flattened order."""
    return [_logical_of(p, len(leaf.shape), family) for p, leaf in zip(ref_paths(t), tree.leaves(t))]


def state_shardings(state_tree, family: str, ctx):
    """A :class:`NamedSharding` tree for a train/serve state (leaves:
    tensors or anything with ``.shape``) by parameter path."""
    return tree.unflatten(state_tree, [ctx.sharding(*lg) if lg else ctx.sharding()
                                       for lg in param_logical(state_tree, family)])


def fit_tree(templates, shardings, mesh):
    """:func:`fit_sharding` leaf-wise over matching trees (template leaves:
    anything with ``.shape``, e.g. meta tensors)."""
    leaves = tree.leaves(templates)
    shard = tree.flatten_up_to(templates, shardings)
    return tree.unflatten(templates, [
        fit_sharding(tuple(t.shape), s, mesh) for t, s in zip(leaves, shard)])


def _lm_input_shardings(cell, ctx):
    if cell.kind == "train":
        return {"tokens": ctx.sharding("dp", None), "labels": ctx.sharding("dp", None)}
    if cell.kind == "prefill":
        return {"tokens": ctx.sharding("dp", None)}
    if cell.dims.get("seq_shard"):
        return {"tokens": ctx.sharding(None, None)}
    return {"tokens": ctx.sharding("dp", None)}


def _gnn_input_shardings(cell, ctx, cfg=None):
    e_shard = ctx.sharding("edge")
    rep = ctx.sharding()
    out = {"pos": rep, "edge_src": e_shard, "edge_dst": e_shard}
    if cfg is not None and getattr(cfg, "triplet_layout", "flat") == "padded":
        out["tri_kj"] = ctx.sharding("edge", None)
        out["tri_mask"] = ctx.sharding("edge", None)
        out["edge_mask"] = e_shard
    else:
        out["tri_kj"] = e_shard
        out["tri_ji"] = e_shard
    if cell.dims.get("energy"):
        out.update({"z": rep, "node_graph": rep, "target": rep})
    else:
        out.update({"feat": rep, "labels": rep, "label_mask": rep})
    return out


def _recsys_input_shardings(cfg, cell, ctx):
    rep = ctx.sharding()
    if cfg.kind == "sasrec":
        out = {"seq": ctx.sharding("dp", None), "target": ctx.sharding("dp")}
    else:
        out = {"sparse": ctx.sharding("dp", None)}
        if cfg.kind == "dlrm":
            out["dense"] = ctx.sharding("dp", None)
        if cfg.kind == "din":
            out["hist"] = ctx.sharding("dp", None)
    if cell.kind == "train":
        out["label"] = ctx.sharding("dp")
    if cell.kind == "retrieval":
        # batch=1: user side replicated, candidate list sharded on dp
        out = {k: rep for k in out}
        out["candidates"] = ctx.sharding("dp")
    return out


def input_shardings(spec, cell, ctx):
    """The :class:`NamedSharding` of each input of a cell's batch."""
    if spec.family == "lm":
        return _lm_input_shardings(cell, ctx)
    if spec.family == "gnn":
        return _gnn_input_shardings(cell, ctx, _cfg_for_cell(spec, cell))
    if spec.family == "recsys":
        return _recsys_input_shardings(spec.config, cell, ctx)
    raise ValueError(spec.family)


def input_shapes(spec, cell) -> dict:
    """A cell's batch as ``{name: (shape, torch dtype)}``, no data drawn
    (the reference's ``make_inputs(abstract=True)``)."""
    i32, f32 = torch.int32, torch.float32
    if spec.family == "lm":
        b, s = cell.dims["global_batch"], cell.dims["seq_len"]
        if cell.kind == "train":
            return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        return {"tokens": ((b, s) if cell.kind == "prefill" else (b, 1), i32)}
    if spec.family == "gnn":
        cfg, d = _cfg_for_cell(spec, cell), cell.dims
        n, e = d["n_nodes"], d["n_edges"]
        t_max = d.get("t_max", 4)
        t = e * t_max
        padded = cfg.triplet_layout == "padded"
        if padded:
            e = ((e + 511) // 512) * 512
        shp = {"pos": ((n, 3), f32), "edge_src": ((e,), i32), "edge_dst": ((e,), i32)}
        if padded:
            shp.update(tri_kj=((e, t_max), i32), tri_mask=((e, t_max), f32),
                       edge_mask=((e,), f32))
        else:
            shp.update(tri_kj=((t,), i32), tri_ji=((t,), i32))
        if d.get("energy"):
            shp.update(z=((n,), i32), node_graph=((n,), i32), target=((d["n_graphs"],), f32))
        else:
            shp.update(feat=((n, d["d_feat"]), f32), labels=((n,), i32), label_mask=((n,), f32))
        return shp
    cfg, b = spec.config, cell.dims["batch"]
    shp = {"sparse": ((b, cfg.n_sparse), i32)}
    if cfg.kind == "dlrm":
        shp["dense"] = ((b, cfg.n_dense), f32)
    if cfg.kind == "din":
        shp["hist"] = ((b, cfg.seq_len), i32)
    if cfg.kind == "sasrec":
        shp = {"seq": ((b, cfg.seq_len), i32), "target": ((b,), i32)}
    if cell.kind == "train":
        shp["label"] = ((b,), f32)
    if cell.kind == "retrieval":
        shp["candidates"] = ((cell.dims["n_candidates"],), i32)
    return shp


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
    ``init_train_state``).  A ``decode`` cell's ``cache_placement`` is the
    cache's placement under the context (``transformer.cache_placement``:
    None when nothing is split), where the reference's bundle carries
    ``cache_shardings``."""

    fn: object
    cfg: object
    kind: str
    init_fn: object = None
    cache_placement: object = None


def _placed_prefill(params, batch, cfg, ctx, plan):
    """The prefill step on this rank's blocks: the rank's ``dp`` slice of
    the batch (all of it when it does not divide) through the placed
    forward, ``h[:, -1]`` times the ``tp`` columns of the head, and the
    f32 logits gathered over ``tp`` and ``dp``: every rank returns the
    whole ``(B, V)``."""
    from repro_torch.dist import collectives
    from repro_torch.train.step import local_batch

    mine = local_batch(batch, ctx, "lm")
    view = ctx.local_view() if mine is not batch else ctx
    h = transformer.forward(params, mine["tokens"], cfg, view)
    head, tp = transformer.head_block(params, cfg, ctx, plan, h.dtype)
    logits = collectives.all_gather_dim((h[:, -1] @ head).float(), tp, ctx, 1)
    if mine is not batch:
        logits = collectives.all_gather_dim(logits, ctx.mesh_axes("dp"), ctx, 0)
    return logits


def build_step(spec, cell, ctx=None, tcfg: TrainConfig | None = None) -> StepBundle:
    """The function of ``cell`` on ``spec``'s config: ``train`` is
    ``make_train_step(tcfg)`` (default ``TrainConfig()``) over
    ``transformer.loss_fn`` or ``recsys.loss_fn``, and
    ``graph_train`` the same over ``dimenet.loss_fn`` on the cell's config
    (:func:`_cfg_for_cell`), over the ranks of ``ctx`` when given (each
    rank calls the step with the same global batch); ``prefill`` runs ``transformer.forward`` and
    returns ``h[:, -1] @ head`` in f32; ``decode`` is
    ``transformer.decode_step``; ``serve`` and ``retrieval`` are
    ``recsys.score_fn`` and ``recsys.retrieval_fn`` (under ``ctx``, on each
    rank's row shard).  A kind the family has no step for raises
    ``ValueError((family, kind))``.

    An LM under a context whose ``tp``/``fsdp``/``ep`` axes hold more than
    one rank is placed (``transformer.placement``): its ``init_fn`` returns
    this rank's blocks (each leaf drawn whole, its block kept, the rest
    freed; ``init_fn.whole`` is the whole meta template), the ``train``
    step runs on the blocks and the ``prefill`` step returns the whole
    logits on every rank (:func:`_placed_prefill`).  The ``decode`` cell
    runs ``transformer.decode_step`` under ``ctx`` on this rank's
    parameter and cache blocks (``transformer.init_cache(..., ctx=ctx,
    seq_shard=...)``), the cache placed as the reference places it:
    batch on ``dp``, sequence on ``seqm`` (``long_500k``: on ``sp``)."""
    _check_kind(spec, cell)
    cfg = _cfg_for_cell(spec, cell)
    plan = transformer.placement(cfg, ctx) if spec.family == "lm" else None
    if cell.kind in ("train", "graph_train"):
        shardings = None
        if spec.family == "lm":
            def loss(params, batch, view=None):
                return transformer.loss_fn(params, batch, cfg, view)

            def init_fn(gen):
                return transformer.init(gen, cfg, ctx)

            if plan is not None:  # each rank draws the whole leaves and keeps its blocks
                init_fn.whole = transformer.param_template(cfg)
                shardings = plan
        elif spec.family == "recsys":
            # each rank feeds its own slice of the batch to the lookups
            local = None if ctx is None else ctx.local_view()

            def loss(params, batch):
                return recsys.loss_fn(params, batch, cfg, local)

            def init_fn(gen):
                params = recsys.init(gen, cfg, ctx)
                if ctx is None or ctx.n("row") == 1:
                    return params
                mine = recsys.local_params(params, ctx)
                return {k: (v.clone() if k in ("embed", "wide") else v) for k, v in mine.items()}
        else:
            def loss(params, batch):
                return dimenet.loss_fn(params, batch, cfg, ctx)

            def init_fn(gen):
                return dimenet.init(gen, cfg)
        step = make_train_step(loss, tcfg or TrainConfig(), ctx=ctx, family=spec.family,
                               shardings=shardings)
        return StepBundle(fn=step, cfg=cfg, kind=cell.kind, init_fn=init_fn)
    if spec.family == "lm" and cell.kind == "prefill" and plan is not None:
        def fn(params, batch):
            return _placed_prefill(params, batch, cfg, ctx, plan)
    elif spec.family == "lm" and cell.kind == "prefill":
        def fn(params, batch):
            # the full-sequence forward; only the last position's logits
            # leave the step, the (B, S, V) logits are never made
            h = transformer.forward(params, batch["tokens"], cfg)
            return (h[:, -1] @ params["head"].to(h.dtype)).float()
    elif spec.family == "lm" and cell.kind == "decode":
        seq_shard = bool(cell.dims.get("seq_shard"))
        b, s = cell.dims["global_batch"], cell.dims["seq_len"]

        def fn(params, cache, batch, pos):
            return transformer.decode_step(params, cache, batch["tokens"], pos, cfg, ctx,
                                           seq_shard=seq_shard, max_seq=s)

        return StepBundle(fn=fn, cfg=cfg, kind=cell.kind, cache_placement=transformer.
                          cache_placement(cfg, ctx, b, s, seq_shard))
    elif spec.family == "recsys" and cell.kind == "serve":
        def fn(params, batch):
            return recsys.score_fn(params, batch, cfg, ctx)
    else:
        def fn(params, batch):
            return recsys.retrieval_fn(params, batch, cfg, ctx)
    return StepBundle(fn=fn, cfg=cfg, kind=cell.kind)
