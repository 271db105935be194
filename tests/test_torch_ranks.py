"""Gradients over ranks, held on the CPU: the port's train step over 2 and
4 spawned gloo ranks (``test_torch_gpu.train_rank_cases``) against the
port's one-rank step on the whole batch and the reference's
single-device step, the differentiable row-sharded lookups, the
edge-sharded DimeNet and the elastic checkpoint restore.

The ranks run every case once for the module (fixture ``ranks``, four
spawned processes; a 2-rank case runs on ranks 0-1 while 2-3 wait) while
this process runs the reference's jitted steps and the port's one-rank
steps.  The reference is held where it runs: its recsys ``train`` cells
raise under ``"a2a"`` and its DimeNet under ``single_device_ctx()``
(ROADMAP queue 3), so the recsys cases meet the reference's
``"allreduce"`` step and DimeNet's the reference with its ``edge`` rule
emptied, as ``test_torch_train_models.py`` and ``test_torch_dimenet.py``
hold the one-rank port.

Tolerances (f32 compute), each measured first:

* the ranks of a case end bit-equal wherever they hold the same leaf
  (every leaf but a recsys row shard): they all apply the same reduced
  gradient;
* against the one-rank step and the reference: loss and ``grad_norm``
  within 1e-5 relative (an all-reduce, a reduce-scatter and a scatter-add
  over ranks sum in another order than one rank); AdamW's first moment
  (``0.1 *`` the clipped gradient) within ``F32_GRAD_RTOL`` (1e-5) of
  each leaf's largest magnitude, 2e-3 for DimeNet's padded layout (its
  message gather's backward is a bf16 reduce-scatter over the edge ranks
  and a bf16 scatter-add, ``test_torch_dimenet.GRAD_RTOL``), 1e-4 for its
  flat layout; the parameters within 2 lr and within 1e-2 lr on all but
  0.1% (1% padded) of a leaf's elements whose gradient exceeds the first
  moment's tolerance (AdamW moves a parameter by ~lr times the sign of its
  gradient, and a gradient within that tolerance of zero may take either
  sign: in a 32-element bias one such flip is 3% of the leaf);
* under compression, ``test_torch_train._check_rounded``: a rounding tie
  may fall the other way where the gradients differ in their last bits;
* with ``microbatches=2`` the reported loss is the ``dp`` mean of each
  rank's last microbatch, which is not the one-rank step's last
  microbatch: the loss is compared for one microbatch only;
* the lookups' outputs bit-equal to the gather, their gradients within
  1e-6 of the one-rank gather's (the sums over ranks reorder).
"""

import dataclasses
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import ShardingCtx as RShardingCtx
from repro.launch import steps as rsteps
from repro.models import dimenet as rd
from repro.models import recsys as rr
from repro.models import transformer as rt
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_train_state as rinit_state
from repro.train import make_train_step as rmake_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.dist.sharding import AbstractMesh, ShardingCtx
from repro_torch.launch import steps as tsteps
from repro_torch.train import TrainConfig, state_from_numpy
from test_torch_dimenet import CTX as DIMENET_CTX
from test_torch_gpu import run_ranks, train_rank_cases
from test_torch_train import F32_GRAD_RTOL, _check_rounded
from test_torch_train_models import CTX as RECSYS_CTX

TCFG = dict(total_steps=4, warmup=1)
LM_BATCH = 8  # sequences a step: 2 a rank on 4 ranks, 1 a microbatch at 2
ONE_AXIS = {"dp": ("model",), "fsdp": ("model",), "tp": (), "ep": (), "edge": ("model",),
            "row": ("model",)}
#: mesh and rules of a case's ranks: 2 ranks of the 4 (rules on one dim),
#: or all 4 (the family's own profile); "replicas": dp over 2, model 2
MESHES = {
    ("lm", 2): dict(mesh=[2, 1], profile="tp_fsdp"),
    ("lm", 4): dict(mesh=[4, 1], profile="tp_fsdp"),
    ("lm", "replicas"): dict(mesh=[2, 2], profile="tp_fsdp"),
    ("flat", 2): dict(mesh=[1, 2], profile="flat_dp", rules=ONE_AXIS),
    ("flat", 4): dict(mesh=[1, 4], profile="flat_dp"),
}
LM_CASES = {
    f"lm-{c}-mb{mb}-{w}": dict(world=w, tcfg=dict(TCFG, grad_compression=c, microbatches=mb))
    for w in (2, 4) for c, mb in (("none", 1), ("bf16", 1), ("int8", 1), ("none", 2), ("int8", 2))
}
LM_CASES["lm-none-mb1-replicas"] = dict(world="replicas", tcfg=dict(TCFG))
LM_CASES["lm-indivisible-4"] = dict(world=4, tcfg=dict(TCFG), batch=6)
RECSYS_CASES = {f"wide-deep-{m}-{w}": dict(world=w, mode=m)
                for m in ("a2a", "allreduce") for w in (2, 4)}
GNN_CASES = {f"dimenet-{lay}-{cell}-{w}": dict(world=w, layout=lay, cell=cell)
             for lay, cell in (("padded", "molecule"), ("flat", "full_graph_sm"))
             for w in (2, 4)}
GNN_GRAD_RTOL = {"padded": 2e-3, "flat": 1e-4}
GNN_OFF_SHARE = {"padded": 1e-2, "flat": 1e-3}
LOOKUP_CASES = {f"lookup-{m}-{v}": dict(mode=m, local=v == "local")
                for m in ("a2a", "allreduce") for v in ("local", "global")}
RESTORE_MESHES = ([1, 4], [4, 1])


def _np(t):
    return jax.tree.map(np.asarray, t)


def _lm_cfgs():
    r = dataclasses.replace(rconfigs.get("qwen2-0.5b", reduced=True).config, dtype="float32")
    t = dataclasses.replace(tconfigs.get("qwen2-0.5b", reduced=True).config, dtype="float32")
    return r, t


def _lm_batch(rows: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (rows, 64)).astype(np.int32) for k in ("tokens", "labels")}


def _key(tcfg: dict) -> tuple:
    return tuple(sorted(tcfg.items()))


@functools.lru_cache(maxsize=None)
def _ref_lm_init(key: tuple):
    cfg_r, _ = _lm_cfgs()
    rcfg = RTrainConfig(**dict(key))
    return _np(jax.jit(lambda k: rinit_state(k, lambda r: rt.init(r, cfg_r), rcfg))(
        jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _ref_lm_step(key: tuple, rows: int):
    """The reference's one jitted step from its initial state."""
    cfg_r, _ = _lm_cfgs()
    rcfg = RTrainConfig(**dict(key))
    step = jax.jit(rmake_step(lambda p, b: rt.loss_fn(p, b, cfg_r, RECSYS_CTX), rcfg))
    new, m = step(_ref_lm_init(key), {k: jnp.asarray(v) for k, v in _lm_batch(rows).items()})
    return _np(new), _np(m)


def _recsys_parts():
    spec = rconfigs.get("wide-deep", reduced=True)
    cfg_r = dataclasses.replace(spec.config, lookup_mode="allreduce")
    cell = next(c for c in spec.shapes if c.kind == "train")
    return cfg_r, rsteps.make_inputs(spec, cell, False, np.random.default_rng(5))


@functools.lru_cache(maxsize=None)
def _ref_recsys_init():
    cfg_r, _ = _recsys_parts()
    return _np(jax.jit(lambda k: rinit_state(k, lambda r: rr.init(r, cfg_r, RECSYS_CTX),
                                             RTrainConfig(**TCFG)))(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _ref_recsys_step():
    cfg_r, batch = _recsys_parts()
    step = jax.jit(rmake_step(lambda p, b: rr.loss_fn(p, b, cfg_r, RECSYS_CTX),
                              RTrainConfig(**TCFG)))
    new, m = step(_ref_recsys_init(), batch)
    return _np(new), _np(m)


def _dimenet_parts(layout: str, cell_name: str):
    spec = rconfigs.get("dimenet", reduced=True)
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config,
                                                                triplet_layout=layout))
    cell = next(c for c in spec.shapes if c.name == cell_name)
    return rsteps._cfg_for_cell(spec, cell), rsteps.make_inputs(spec, cell, False,
                                                                np.random.default_rng(3))


@functools.lru_cache(maxsize=None)
def _ref_dimenet_init(layout: str, cell_name: str):
    cfg_r, _ = _dimenet_parts(layout, cell_name)
    return _np(jax.jit(lambda k: rinit_state(k, lambda r: rd.init(r, cfg_r),
                                             RTrainConfig(**TCFG)))(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _ref_dimenet_step(layout: str, cell_name: str):
    cfg_r, batch = _dimenet_parts(layout, cell_name)
    step = jax.jit(rmake_step(lambda p, b: rd.loss_fn(p, b, cfg_r, DIMENET_CTX),
                              RTrainConfig(**TCFG)))
    new, m = step(_ref_dimenet_init(layout, cell_name), batch)
    return _np(new), _np(m)


def _pad_rows(state, rows: int):
    """The recsys state with its row leaves (and their moments) padded with
    zero rows to ``rows`` (a multiple of every rank count here)."""
    def pad(path, t):
        if path.endswith("embed") or path.endswith("wide"):
            return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])
        return t
    return tree.unflatten(state, [pad(p, t) for p, t in zip(tsteps.ref_paths(state),
                                                              tree.leaves(state))])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case once: the port on 4 spawned ranks; meanwhile, here, the
    reference's steps and the port's one-rank steps.  Returns, by case,
    ``((ref_state, ref_metrics), (one_state, one_metrics), got_by_rank)``
    (None for a rank outside a 2-rank case)."""
    work = tmp_path_factory.mktemp("train_ranks")
    cases, local = [], {}
    for name, c in LM_CASES.items():
        rows = c.get("batch", LM_BATCH)
        r0 = _ref_lm_init(_key(c["tcfg"]))
        tb = {k: torch.from_numpy(v) for k, v in _lm_batch(rows).items()}
        torch.save({"state": state_from_numpy(r0, device="cpu"), "batch": tb}, work / f"{name}.pt")
        cases.append(dict(MESHES["lm", c["world"]], name=name, kind="step", inputs=f"{name}.pt",
                          arch="qwen2-0.5b", config={"dtype": "float32"}, cell="train_4k",
                          tcfg=c["tcfg"]))
        local[name] = (functools.partial(_ref_lm_step, _key(c["tcfg"]), rows),
                       ("lm", r0, tb, c["tcfg"]))
    r0 = _ref_recsys_init()
    tspec = tconfigs.get("wide-deep", reduced=True)
    cell = next(c for c in tspec.shapes if c.kind == "train")
    tb = tsteps.make_inputs(tspec, cell, np.random.default_rng(5), device="cpu")
    rows = -(-tspec.config.total_rows // 4) * 4
    torch.save({"state": _pad_rows(state_from_numpy(r0, device="cpu"), rows), "batch": tb},
               work / "wide-deep.pt")
    for name, c in RECSYS_CASES.items():
        cases.append(dict(MESHES["flat", c["world"]], name=name, kind="step", inputs="wide-deep.pt",
                          arch="wide-deep", config={"lookup_mode": c["mode"]}, cell=cell.name,
                          tcfg=TCFG))
        local[name] = (_ref_recsys_step, ("recsys", r0, tb, c["mode"]))
    for name, c in GNN_CASES.items():
        r0 = _ref_dimenet_init(c["layout"], c["cell"])
        spec = tconfigs.get("dimenet", reduced=True)
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, triplet_layout=c["layout"]))
        gcell = next(x for x in spec.shapes if x.name == c["cell"])
        tb = tsteps.make_inputs(spec, gcell, np.random.default_rng(3), device="cpu")
        torch.save({"state": state_from_numpy(r0, device="cpu"), "batch": tb}, work / f"{name}.pt")
        cases.append(dict(MESHES["flat", c["world"]], name=name, kind="step", inputs=f"{name}.pt",
                          arch="dimenet", config={"triplet_layout": c["layout"]},
                          cell=c["cell"], tcfg=TCFG))
        local[name] = (functools.partial(_ref_dimenet_step, c["layout"], c["cell"]),
                       ("gnn", r0, tb, spec, gcell))
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(0, 1, (64, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (32, 5)))
    ids[:8] = 63  # a hot row: its repeated ids accumulate
    w = torch.from_numpy(rng.normal(0, 1, (32, 5, 6)).astype(np.float32))
    torch.save({"table": table, "ids": ids, "w": w}, work / "lookup.pt")
    for name, c in LOOKUP_CASES.items():
        cases.append(dict(MESHES["flat", 4], name=name, kind="lookup", inputs="lookup.pt", **c))
    r_restore = _ref_lm_init(_key(TCFG))
    torch.save({"state": state_from_numpy(r_restore, device="cpu")}, work / "restore.pt")
    cases.append(dict(name="restore", kind="restore", inputs="restore.pt", mesh=[2, 2],
                      profile="tp_fsdp", restore_meshes=list(RESTORE_MESHES)))
    (work / "train_cases.json").write_text(json.dumps(cases))

    err = []

    def spawn():
        try:
            run_ranks(train_rank_cases, 4, work, str(work), "cpu", timeout=900)
        except BaseException as e:  # raised in the fixture below
            err.append(e)

    th = threading.Thread(target=spawn)
    th.start()
    try:
        want = {name: (ref(), _one_rank(spec)) for name, (ref, spec) in local.items()}
    finally:
        th.join()
    if err:
        raise err[0]
    got = [torch.load(work / f"train_out{r}.pt", weights_only=False) for r in range(4)]
    out = {name: (*want[name], [g.get(name) for g in got]) for name in local}
    out["lookups"] = (table, ids, w, got)
    out["restore"] = (r_restore, [g["restore"] for g in got])
    return out


def _one_rank(spec):
    """The port's one-rank step from the same state and batch."""
    family = spec[0]
    if family == "lm":
        _, r0, tb, tcfg = spec
        tspec = tconfigs.get("qwen2-0.5b", reduced=True)
        tspec = dataclasses.replace(tspec, config=_lm_cfgs()[1])
        cell = next(c for c in tspec.shapes if c.kind == "train")
        fn = tsteps.build_step(tspec, cell, None, TrainConfig(**tcfg)).fn
    elif family == "recsys":
        _, r0, tb, mode = spec
        tspec = tconfigs.get("wide-deep", reduced=True)
        tspec = dataclasses.replace(tspec, config=dataclasses.replace(tspec.config,
                                                                      lookup_mode=mode))
        cell = next(c for c in tspec.shapes if c.kind == "train")
        fn = tsteps.build_step(tspec, cell, None, TrainConfig(**TCFG)).fn
    else:
        _, r0, tb, tspec, cell = spec
        fn = tsteps.build_step(tspec, cell, None, TrainConfig(**TCFG)).fn
    torch.use_deterministic_algorithms(True)
    try:
        return fn(state_from_numpy(r0, device="cpu"), tb)
    finally:
        torch.use_deterministic_algorithms(False)


def _ranks_agree(got, rows: bool):
    """Every rank of a case holds the same leaves and metrics (a recsys row
    shard is each rank's own: it is held against the one-rank state)."""
    states = [g["state"] for g in got if g is not None]
    for i, p in enumerate(tsteps.ref_paths(states[0])):
        if rows and p.endswith(("embed", "wide")):
            continue
        first = tree.leaves(states[0])[i]
        for s in states[1:]:
            assert torch.equal(tree.leaves(s)[i], first), p
    metrics = [g["metrics"] for g in got if g is not None]
    assert all(m == metrics[0] for m in metrics)


def _assemble_rows(got):
    """The recsys state with its row shards put back together in rank
    order."""
    states = [g["state"] for g in got if g is not None]
    out = []
    for i, p in enumerate(tsteps.ref_paths(states[0])):
        leaves = [tree.leaves(s)[i] for s in states]
        out.append(torch.cat(leaves) if p.endswith(("embed", "wide")) else leaves[0])
    return tree.unflatten(states[0], out)


def _check_step(got_state, got_m, want_state, want_m, *, loss: bool, grad_rtol: float,
                off_share: float, method: str, rows: int | None = None):
    """``got`` (tensors) against ``want`` (numpy, or tensors) within the
    module's tolerances."""
    as_np = [np.asarray(x.numpy() if torch.is_tensor(x) else x) for x in tree.leaves(want_state)]
    want = tree.unflatten(want_state, as_np) if torch.is_tensor(tree.leaves(want_state)[0]) \
        else want_state
    if rows is not None:  # cut the recsys pad rows
        got_state = tree.unflatten(got_state, [
            t[:rows] if p.endswith(("embed", "wide")) else t
            for p, t in zip(tsteps.ref_paths(got_state), tree.leaves(got_state))])
    if loss:
        assert got_m["loss"] == pytest.approx(float(want_m["loss"]), rel=1e-5)
    assert got_m["grad_norm"] == pytest.approx(float(want_m["grad_norm"]), rel=max(grad_rtol, 1e-5))
    wl = jax.tree_util.tree_leaves(want)
    w_m = jax.tree_util.tree_leaves(want["opt"]["m"])
    if method != "none":
        clip = min(1.0, 1.0 / float(want_m["grad_norm"]))
        for got_t, want_t, factor in ((got_state["opt"]["m"], want["opt"]["m"], 0.1 * clip),
                                      (got_state["comp_err"], want["comp_err"], 1.0)):
            _check_rounded(got_t, want_t, want["opt"]["m"], clip, factor, method)
    else:
        for p, g, w in zip(*tree.flatten_with_paths(got_state["opt"]["m"]), w_m):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=p,
                                       atol=max(grad_rtol * np.abs(w).max(), 1e-9))
    lr = RTrainConfig().lr
    for p, a, b, m in zip(*tree.flatten_with_paths(got_state["params"]),
                          jax.tree_util.tree_leaves(want["params"]), w_m):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff.max() <= 2 * lr, (p, diff.max())
        m = np.abs(np.asarray(m))
        real = m > grad_rtol * m.max()  # a gradient whose sign the moment check fixes
        off = (diff > lr * 1e-2) & real
        assert off.mean() <= off_share, (p, off.mean())
    assert len(wl) == len(tree.leaves(got_state))


@pytest.mark.parametrize("case", list(LM_CASES))
def test_dp_lm_step_matches_one_rank_and_reference(ranks, case):
    """One data-parallel step of the reduced qwen2-0.5b (f32) over 2 or 4
    ranks (each its slice of 8 sequences; the 6-sequence case does not
    divide, so every rank runs all 6; ``replicas``: dp 2 x model 2), its
    parameters placed over ``fsdp`` (and ``tp`` on the 2 x 2 mesh: under
    ``tp_fsdp`` no rank holds a whole replica) and the new state gathered
    == the one-rank step on the whole batch and the reference's."""
    (ref_state, ref_m), (one_state, one_m), got = ranks[case]
    _ranks_agree(got, rows=False)
    tcfg = LM_CASES[case]["tcfg"]
    mine = next(g for g in got if g is not None)
    one_m = {k: float(v) for k, v in one_m.items()}
    kw = dict(loss=tcfg.get("microbatches", 1) == 1, grad_rtol=F32_GRAD_RTOL, off_share=1e-3,
              method=tcfg.get("grad_compression", "none"))
    _check_step(mine["state"], mine["metrics"], one_state, one_m, **kw)
    _check_step(mine["state"], mine["metrics"], ref_state, ref_m, **kw)


@pytest.mark.parametrize("case", list(RECSYS_CASES))
def test_dp_recsys_step_matches_one_rank_and_reference(ranks, case):
    """One data-parallel step of the reduced wide & deep over 2 or 4 ranks
    (``flat_dp``: each rank a slice of the 64 rows and a row shard of the
    tables; ``cap_factor`` 4.0, nothing drops): the ranks' shards put back
    together == the one-rank step under the same lookup mode and the
    reference's ``"allreduce"`` step."""
    (ref_state, ref_m), (one_state, one_m), got = ranks[case]
    _ranks_agree(got, rows=True)
    mine = next(g for g in got if g is not None)
    whole = _assemble_rows(got)
    rows = tconfigs.get("wide-deep", reduced=True).config.total_rows
    one_m = {k: float(v) for k, v in one_m.items()}
    kw = dict(loss=True, grad_rtol=F32_GRAD_RTOL, off_share=1e-3, method="none", rows=rows)
    _check_step(whole, mine["metrics"], one_state, one_m, **kw)
    _check_step(whole, mine["metrics"], ref_state, ref_m, **kw)


@pytest.mark.parametrize("case", list(GNN_CASES))
def test_edge_sharded_dimenet_step_matches_one_rank_and_reference(ranks, case):
    """One step of the reduced DimeNet with its edges split over 2 or 4
    ranks (bf16 all-gathers of edge vectors and messages in the padded
    layout, f32 in the flat one, a node psum a block) == the one-rank step
    and the reference's (``edge`` rule emptied)."""
    layout = GNN_CASES[case]["layout"]
    (ref_state, ref_m), (one_state, one_m), got = ranks[case]
    _ranks_agree(got, rows=False)
    mine = next(g for g in got if g is not None)
    one_m = {k: float(v) for k, v in one_m.items()}
    kw = dict(loss=True, grad_rtol=GNN_GRAD_RTOL[layout], off_share=GNN_OFF_SHARE[layout],
              method="none")
    _check_step(mine["state"], mine["metrics"], one_state, one_m, **kw)
    _check_step(mine["state"], mine["metrics"], ref_state, ref_m, **kw)


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_sharded_lookup_carries_gradients_over_ranks(ranks, case):
    """``sharded_lookup`` over 4 ranks (16 rows a shard, one row hot) under
    ``"a2a"`` (``cap_factor`` 4.0) and ``"allreduce"``: the rows equal the
    gather bit for bit, and the gradient of ``sum(out * w)`` reaches the
    owners' rows.  ``local``: each rank its quarter of the ids and of
    ``w``, the shards' gradients put together == the one-rank gather's;
    ``global``: every rank all ids (the serving view), so every rank's
    loss counts once and the gradient is 4 times the gather's."""
    table, ids, w, got = ranks["lookups"]
    c = LOOKUP_CASES[case]
    leaf = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((leaf[ids] * w).sum(), leaf)
    outs = [g[case] for g in got]
    if c["local"]:
        assert torch.equal(torch.cat([o["out"] for o in outs]), table[ids])
    else:
        assert all(torch.equal(o["out"], table[ids]) for o in outs)
        want = 4 * want
    grad = torch.cat([o["grad"] for o in outs])
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _ref_shard_shapes(state_np, mesh_shape):
    """The reference's ``NamedSharding.shard_shape`` of each leaf of the
    LM state under ``fit_tree(state_shardings)`` on an abstract mesh."""
    from jax.sharding import AbstractMesh as RAbstractMesh

    mesh = RAbstractMesh(tuple(mesh_shape), ("data", "model"))
    ctx = RShardingCtx(mesh=mesh, profile="tp_fsdp")
    tmpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state_np)
    shard = rsteps.fit_tree(tmpl, rsteps.state_shardings(tmpl, "lm", ctx), mesh)
    return [list(s.shard_shape(t.shape)) for s, t in zip(jax.tree_util.tree_leaves(shard),
                                                         jax.tree_util.tree_leaves(tmpl))]


@pytest.mark.parametrize("mesh", RESTORE_MESHES, ids=lambda m: "x".join(map(str, m)))
def test_elastic_restore_across_layouts(ranks, mesh):
    """The reduced qwen2-0.5b train state placed over a (2, 2) mesh
    (``fit_tree(state_shardings)``, ``DTensor`` leaves), saved by its 4
    ranks, restored onto a (1, 4) and a (4, 1) mesh with
    ``restore(shardings=)``: each rank's local blocks have the reference's
    ``shard_shape`` there, and every ``full_tensor()`` is bit-equal to the
    saved leaf."""
    r0, got = ranks["restore"]
    key = "x".join(map(str, mesh))
    want = _ref_shard_shapes(r0, mesh)
    assert any(w != list(np.asarray(a).shape) for w, a in zip(
        want, jax.tree_util.tree_leaves(r0)))  # something is split
    for g in got:
        assert g["shapes"][key] == want
        assert all(g["same"][key])
    # the local shapes with ShardingCtx on the port's own abstract mesh
    ctx = ShardingCtx(mesh=AbstractMesh(tuple(mesh), ("data", "model")), profile="tp_fsdp")
    state = state_from_numpy(r0, device="cpu")
    shard = tsteps.fit_tree(state, tsteps.state_shardings(state, "lm", ctx), ctx.mesh)
    assert [list(s.shard_shape(tuple(t.shape))) for s, t in zip(
        tree.leaves(shard), tree.leaves(state))] == want
