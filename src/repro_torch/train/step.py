"""Generic train step: loss -> grads -> (compression) -> clip -> update
(counterpart of ``repro.train.step``).

The step is family-agnostic: a ``loss_fn(params, batch)`` closure comes
from the model zoo, the optimizer from :mod:`.optimizer`, compression
from :mod:`repro_torch.dist.collectives`.  Gradients come from
``torch.autograd.grad`` on detached leaves of the parameters (no copy).
With ``microbatches > 1`` the batch is cut as the reference's
``reshape(microbatches, -1, ...)``, the gradients accumulate in f32 and
are divided by the count, and the reported loss is the **last**
microbatch's, as the reference's ``lax.scan`` carry leaves it.

A state is a plain dict: ``{"params", "opt", "step"}`` plus
``"comp_err"`` (f32, like the parameters) under gradient compression.
It lives on the device of its parameters; the step never moves it.

Over ranks (``make_train_step(..., ctx=, family=)``), where the reference
gets its data-parallel gradient from GSPMD, the step reduces each
gradient leaf over the groups its placement implies
(``launch.steps.state_shardings``):

* the LM and recsys families split the batch over ``dp``: every rank
  takes its slice of the global batch it is given (all of it when the
  batch does not divide by ``n("dp")``, ``fit_sharding``'s fallback), and
  a replicated leaf's gradient is the mean over ``dp`` of the ranks'
  gradients;
* a ``row``-placed leaf (recsys ``embed``/``wide``) is this rank's shard:
  its gradient arrives through the lookups' exchanges (their backward
  sums every rank's contribution) and is divided by ``n("row")``, with no
  all-reduce;
* DimeNet (``gnn``) splits the work, not the batch, over ``edge``: every
  rank computes the same loss, and a replicated leaf takes the sum of
  the ranks' partial gradients over ``edge``, divided by ``n("edge")``
  (the node psum's backward hands every rank ``n`` times the
  gradient of its part).

* an LM under a context whose ``tp``, ``fsdp`` or ``ep`` axes hold more
  than one rank is placed (``transformer.placement``, given as
  ``shardings``): the state holds this rank's blocks, and the loss runs
  on them in the context's local view (its global view when the batch
  did not divide).  An ``fsdp`` leaf's gradient arrives through its
  all-gather's backward, a reduce-scatter that sums it over the ``dp``
  ranks; a leaf split only over ``tp``/``ep`` holds its own block's
  gradient (the tensor-parallel pair makes it whole for its block).  Each
  leaf is then summed over the ``dp`` axes that do not split it (a
  replicated leaf over all of them, as above) and divided by ``n("dp")``.
  A state whose leaves are not this rank's blocks raises.

The reduction comes after the microbatch accumulation and before
``apply_grad_compression``, which so compresses the global gradient as
the reference does; the global norm and the int8 scale of a ``row`` or
placed leaf take its sum of squares and max over the axes that split it
(each block counted once).  Adafactor's row and column means of a placed
leaf sum over those axes too (``optimizer.adafactor_update``).  The
reported loss is the mean over the split axis (each rank's last
microbatch's).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from repro_torch import tree
from repro_torch.dist import collectives
from repro_torch.dist.sharding import split_axes

from . import optimizer as opt
from . import schedule as sched


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "warmup_cosine"
    warmup: int = 100
    total_steps: int = 10_000
    grad_compression: str = "none"  # none | bf16 | int8
    microbatches: int = 1


@torch.no_grad()
def global_norm(t):
    """sqrt of the f32 sum, leaf by leaf in flattened order, of each
    leaf's f32 sum of squares."""
    total = 0
    for leaf in tree.leaves(t):
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(t, max_norm, norm=None):
    """``(clipped, norm)``: every leaf scaled by ``min(1, max_norm /
    max(norm, 1e-9))`` in f32, cast back to its dtype; ``norm`` the raw
    (pre-clip) global norm (:func:`global_norm` unless given)."""
    norm = global_norm(t) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.tree_map(lambda l: (l.to(torch.float32) * scale).to(l.dtype), t), norm


def init_train_state(gen: torch.Generator, init_fn, tcfg: TrainConfig):
    """``init_fn(gen)`` for the parameters (on ``gen``'s device), the
    optimizer's zeroed state, step 0 and, under compression, zeroed f32
    error buffers.  An ``init_fn`` that returns a rank's blocks of placed
    parameters carries their whole meta template as ``init_fn.whole``:
    Adafactor's second moments are made whole from it, as the reference
    places them (AdamW's moments and the error buffers are blocks like the
    parameters)."""
    params = init_fn(gen)
    init, _, _ = opt.OPTIMIZERS[tcfg.optimizer]
    dev = tree.leaves(params)[0].device
    whole = getattr(init_fn, "whole", None)
    if tcfg.optimizer == "adafactor" and whole is not None:
        moments = tree.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                                init(whole))
    else:
        moments = init(params)
    state = {"params": params, "opt": moments,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if tcfg.grad_compression != "none":
        state["comp_err"] = tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


def state_from_numpy(np_state, device=None):
    """A reference train state (``jax.tree.map(np.asarray, state)``:
    params, optimizer moments, ``comp_err``, ``step``) as tensors on
    ``device`` (the card when None), structure and dtypes kept."""
    from repro_torch.device import resolve_device

    return tree.tree_from_numpy(np_state, resolve_device(device))


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached,
    the gradients in each parameter's dtype (zeros where a leaf is
    unused), in ``params``' structure."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def _split_axis(family):
    """The logical axis a family's train step splits over, and whether it
    splits the batch (``dp``) or only the work (``edge``)."""
    return ("edge", False) if family == "gnn" else ("dp", True)


def local_batch(batch: dict, ctx, family) -> dict:
    """This rank's slice of a global ``batch`` along ``dp``: rows ``[i *
    B/n, (i + 1) * B/n)`` of every value for the rank at index ``i`` of
    ``n = ctx.n("dp")``; the whole batch when ``n`` does not divide ``B``
    (or the family splits no batch)."""
    axis, slices = _split_axis(family)
    n = 1 if ctx is None else ctx.n(axis)
    sizes = {int(v.shape[0]) for v in batch.values()}
    if not slices or n == 1 or len(sizes) != 1 or next(iter(sizes)) % n:
        return batch
    rows = next(iter(sizes)) // n
    i = ctx.index(axis)
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def placed(ctx, family) -> bool:
    """Whether an LM under ``ctx`` places its parameters: some ``tp``,
    ``fsdp`` or ``ep`` axis holds more than one rank."""
    return (ctx is not None and family == "lm"
            and any(ctx.n(a) > 1 for a in ("tp", "fsdp", "ep")))


def make_train_step(loss_fn, tcfg: TrainConfig, ctx=None, family: str | None = None,
                    shardings=None):
    """``loss_fn(params, batch) -> scalar``.  Returns ``step(state,
    batch) -> (new_state, metrics)``, metrics ``loss``, ``grad_norm``
    (before the clip) and ``lr_scale``, 0-d tensors on the state's
    device.  With ``ctx`` and ``family`` (``"lm"``, ``"recsys"``,
    ``"gnn"``) the step runs on every rank of ``ctx``'s mesh, each given
    the same global batch, and reduces the gradients over ranks as the
    module docstring says.  A placed LM (:func:`placed`) needs
    ``shardings``, a nest of ``transformer.Placed`` like the parameters'
    (``transformer.placement``), and calls ``loss_fn(params, batch,
    view)`` with the context view of the batch it runs."""
    _, update, occls = opt.OPTIMIZERS[tcfg.optimizer]
    ocfg = occls(lr=tcfg.lr)
    if tcfg.optimizer == "adamw":
        ocfg = opt.AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
    schedule = partial(sched.SCHEDULES[tcfg.schedule], warmup=tcfg.warmup,
                       total=tcfg.total_steps)
    axis, _ = _split_axis(family)
    n_split = 1 if ctx is None else ctx.n(axis)
    n_row = 1 if ctx is None else ctx.n("row")
    place = placed(ctx, family)
    if place and shardings is None:
        raise ValueError("a placed LM step needs its parameters' placement (shardings=): under "
                         "tp/fsdp/ep > 1 no rank holds a whole replica")
    # per parameter leaf: the mesh axes its blocks split over (placed LMs)
    split = [split_axes(pl.sharding) for pl in tree.leaves(shardings)] if place else None

    def grads_of(params, batch, view):
        fn = loss_fn if not place else (lambda p, b: loss_fn(p, b, view))
        if tcfg.microbatches <= 1:
            return value_and_grad(fn, params, batch)
        n = tcfg.microbatches
        mbs = {k: x.reshape(n, -1, *x.shape[1:]) for k, x in batch.items()}
        acc = None
        for i in range(n):
            loss, g = value_and_grad(fn, params, {k: x[i] for k, x in mbs.items()})
            g = [x.to(torch.float32) for x in tree.leaves(g)]
            if acc is None:
                acc = [torch.zeros_like(x) for x in g]
            for a, x in zip(acc, g):
                a.add_(x)
        return loss, tree.unflatten(params, [a / float(n) for a in acc])

    def sum_axes(rows):
        """Per leaf, the mesh axes its gradient's norm and int8 max reduce
        over: a row shard's ``row`` axes, a placed leaf's split axes."""
        if place:
            return split
        return [ctx.mesh_axes("row") if row else () for row in rows]

    def reduce_grads(grads, rows):
        """The global gradient from this rank's (see the module docstring)."""
        axes = ctx.mesh_axes(axis)
        out = []
        for i, (g, row) in enumerate(zip(tree.leaves(grads), rows)):
            if place:
                rest = tuple(a for a in axes if a not in split[i])
                out.append(collectives.psum_if_mapped(g, rest, ctx) / n_split)
            elif row:
                out.append(g / n_row)
            else:
                out.append(collectives.psum_if_mapped(g, axes, ctx) / n_split)
        return tree.unflatten(grads, out)

    def norm_of(grads, over):
        total = 0
        for g, axes in zip(tree.leaves(grads), over):
            total = total + collectives.psum_if_mapped(torch.sum(g.to(torch.float32) ** 2),
                                                       axes, ctx)
        return torch.sqrt(total)

    def step(state, batch):
        ranks = ctx is not None and (n_split > 1 or n_row > 1 or place)
        rows = row_leaves(state["params"], family, ctx) if ranks else None
        if ranks and tcfg.optimizer == "adafactor" and any(rows):
            raise NotImplementedError("Adafactor's factored moments of a row-sharded leaf need "
                                      "its column means over ranks; train it with AdamW")
        if place:
            from repro_torch.models.transformer import check_blocks

            check_blocks(state["params"], shardings)
        view = None
        if ranks:
            mine = local_batch(batch, ctx, family)
            view = ctx.local_view() if mine is not batch else ctx
            batch = mine
        loss, grads = grads_of(state["params"], batch, view)
        with torch.no_grad():
            over = sum_axes(rows) if ranks else None
            if ranks:
                grads = reduce_grads(grads, rows)
                loss = collectives.psum_if_mapped(loss, ctx.mesh_axes(axis), ctx) / n_split
            if tcfg.grad_compression != "none":
                maxes = None
                if ranks:
                    maxes = [partial(collectives.max_if_mapped, axes=a, ctx=ctx) if a else None
                             for a in over]
                grads, new_err = collectives.apply_grad_compression(
                    grads, state["comp_err"], tcfg.grad_compression, maxes)
            norm = norm_of(grads, over) if ranks else None
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm)
            lr_scale = schedule(state["step"])
            kw = {}
            if place and tcfg.optimizer == "adafactor":
                kw = {"ctx": ctx, "shardings": shardings}
            new_params, new_opt = update(grads, state["opt"], state["params"], ocfg, lr_scale,
                                         **kw)
        out = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        if tcfg.grad_compression != "none":
            out["comp_err"] = new_err
        return out, {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}

    return step


def row_leaves(params, family, ctx) -> list:
    """For each parameter leaf (flattened order), whether it is placed over
    ``row`` under ``ctx`` (``launch.steps.state_shardings``' classifier):
    this rank holds a shard of its rows."""
    from repro_torch.launch.steps import param_logical

    if ctx is None or ctx.n("row") == 1:
        return [False] * len(tree.leaves(params))
    return ["row" in (lg or ()) for lg in param_logical(params, family)]
