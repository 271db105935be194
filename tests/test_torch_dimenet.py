"""The port's DimeNet (``repro_torch.models.dimenet``, its configs and the
``graph_train`` cells of ``launch.steps``) held against the JAX reference
on the CPU, at the reduced config.

The reference runs under ``single_device_ctx()`` with its ``edge`` rule
emptied: under the plain context every DimeNet cell raises
``ShardingTypeError`` at ``models/dimenet.py:315`` (ROADMAP queue 3;
``test_reference_dimenet_raises_under_single_device_ctx``), and one
device gives the same numbers under any placement.  Each (cell, layout)
case runs the reference once, jitted, in the module fixture ``ref_runs``.

Tolerances (f32, measured first):
  * ``make_inputs`` and the triplet builders: bit-equal;
  * the bases, the forward pass and the loss: 1e-5 relative (of the
    output's largest magnitude for the forward pass; measured <= 5e-7 for
    the loss);
  * gradients, of each leaf's largest magnitude: 1e-4 in the flat layout
    (f32 sums in other orders, scaled up by the envelope's ~1e5 at
    self-loop edges; measured <= 1.5e-5), 2e-3 in the padded layout,
    whose message gather reads a bf16 copy, so its backward is a
    scatter-add in bf16 in both packages and the summation order moves
    results by bf16 ulps (2^-8 of an element; measured <= 2.4e-4);
  * one train step: loss 1e-5 relative, ``grad_norm`` as the gradients,
    parameters within 2 lr and within 1e-2 lr on all but 0.1% of the
    elements (AdamW's first step moves a parameter by ~lr times the sign
    of its gradient: a sign may differ where a gradient is ~0), 1% in the
    padded layout (its bf16 gradients carry that ~0 band wider).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import ShardingCtx, single_device_ctx
from repro.launch import steps as rsteps
from repro.models import dimenet as rd
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_train_state as rinit_state
from repro.train import make_train_step as rmake_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.launch import steps as tsteps
from repro_torch.models import dimenet as td
from repro_torch.train import TrainConfig, state_from_numpy
from repro_torch.train import step as tstep

_BASE = single_device_ctx()
CTX = ShardingCtx(mesh=_BASE.mesh, profile=_BASE.profile, rules=dict(_BASE.rules, edge=()))
CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
LAYOUTS = ("padded", "flat")
GRAD_RTOL = {"flat": 1e-4, "padded": 2e-3}
PARAM_OFF_SHARE = {"flat": 1e-3, "padded": 1e-2}
TCFG = dict(total_steps=4, warmup=1)
SEED = 3


def _np(t):
    return jax.tree.map(np.asarray, t)


def _specs(layout):
    """The reduced specs of both packages in ``layout``."""
    out = []
    for mod in (rconfigs, tconfigs):
        spec = mod.get("dimenet", reduced=True)
        out.append(dataclasses.replace(
            spec, config=dataclasses.replace(spec.config, triplet_layout=layout)))
    return out


def _cell(spec, name):
    return next(c for c in spec.shapes if c.name == name)


def _case(cell_name, layout, seed=SEED):
    """Both packages' configs and batches for one cell and layout."""
    rspec, tspec = _specs(layout)
    rcell, tcell = _cell(rspec, cell_name), _cell(tspec, cell_name)
    return (rspec, rcell, rsteps._cfg_for_cell(rspec, rcell),
            rsteps.make_inputs(rspec, rcell, False, np.random.default_rng(seed)),
            tspec, tcell, tsteps._cfg_for_cell(tspec, tcell),
            tsteps.make_inputs(tspec, tcell, np.random.default_rng(seed), device="cpu"))


@pytest.fixture(scope="module")
def ref_runs():
    """Per (cell, layout): the reference's parameters (numpy), forward
    output, loss and gradients, one jitted call each.  The forward output
    is the one ``loss_fn`` computes, caught on its way (one trace of the
    forward pass a case, not two)."""
    out = {}
    forward = rd.forward
    for layout in LAYOUTS:
        for name in CELLS:
            _, _, cfg_r, rb, *_ = _case(name, layout)
            params = _np(rd.init(jax.random.key(0), cfg_r))

            def loss(p, b, cfg=cfg_r):
                seen = []

                def spy(*args):
                    seen.append(forward(*args))
                    return seen[-1]

                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(rd, "forward", spy)
                    return rd.loss_fn(p, b, cfg, CTX), seen[0]

            (l, fwd), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, rb)
            out[name, layout] = (params, np.asarray(fwd), float(l), _np(g))
    return out


def _close_by_leaf(got, want, rtol, what):
    paths, leaves = tree.flatten_with_paths(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len(wl)
    for p, g, w in zip(paths, leaves, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, p
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=f"{what} {p}",
                                   atol=max(rtol * np.abs(w).max(), 1e-30))


# -- configs -------------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_dimenet_config_matches_reference(reduced):
    r, t = rconfigs.get("dimenet", reduced=reduced), tconfigs.get("dimenet", reduced=reduced)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(r.config)
    assert t.config.n_sbf == r.config.n_sbf
    assert (t.arch_id, t.family) == (r.arch_id, r.family) == ("dimenet", "gnn")
    assert [(c.name, c.kind, c.dims) for c in t.shapes] == [(c.name, c.kind, c.dims)
                                                           for c in r.shapes]
    for c_r, c_t in zip(r.shapes, t.shapes):
        assert dataclasses.asdict(tsteps._cfg_for_cell(t, c_t)) == dataclasses.asdict(
            rsteps._cfg_for_cell(r, c_r))


def test_gnn_shapes_match_reference():
    from repro.configs.base import gnn_shapes as rshapes

    for t_max in (2, 4):
        assert [(c.name, c.kind, c.dims) for c in tconfigs.gnn_shapes(t_max)] == [
            (c.name, c.kind, c.dims) for c in rshapes(t_max)]


# -- triplets and inputs -------------------------------------------------------------------


def _graph(case):
    """Seeded graphs with self-loops, repeated edges and isolated nodes."""
    rng = np.random.default_rng(case)
    n = (5, 40, 120, 300)[case % 4]
    e = (0, 1, 17, 200, 900)[case % 5]
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if e > 4:
        src[: e // 4] = dst[: e // 4]  # self-loops
        src[e // 4: e // 2], dst[e // 4: e // 2] = src[0], dst[1]  # one heavy pair of nodes
    return src, dst, n + 3  # 3 isolated nodes at the end


@pytest.mark.parametrize("t_max", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("case", range(8))
def test_triplet_builders_match_reference(case, t_max):
    src, dst, n = _graph(case)
    want = rd.build_triplets_padded(src, dst, n, t_max=t_max)
    got = td.build_triplets_padded(src, dst, n, t_max=t_max)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    want = rd.build_triplets(src, dst, n, t_max=t_max)
    got = td.build_triplets(src, dst, n, t_max=t_max)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_synth_positions_match_reference():
    feat = np.random.default_rng(1).normal(size=(50, 12)).astype(np.float32)
    np.testing.assert_array_equal(td.synth_positions(feat, seed=2), rd.synth_positions(feat, seed=2))
    np.testing.assert_array_equal(td.synth_positions(30, seed=4), rd.synth_positions(30, seed=4))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CELLS)
def test_make_inputs_match_reference(name, layout):
    """Bit-equal batches, key for key in the reference's order, for two
    seeds (a seed's draws line up only if every draw is made in turn)."""
    for seed in (0, 7):
        *_, rb, _, tcell, _, tb = _case(name, layout, seed)
        assert list(tb) == list(rb)
        for k, w in rb.items():
            w = np.asarray(w)
            assert tb[k].device.type == "cpu" and tb[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(tb[k].numpy(), w, err_msg=k)
    if layout == "padded":
        assert tb["edge_src"].shape[0] % 512 == 0 and bool((tb["edge_mask"] == 1).all())
    else:
        assert tb["tri_kj"].shape[0] == tcell.dims["n_edges"] * tcell.dims["t_max"]


# -- the model -----------------------------------------------------------------------------


def test_bases_match_reference():
    cfg_r, cfg_t = _specs("padded")[0].config, _specs("padded")[1].config
    rng = np.random.default_rng(5)
    # beside zero (self-loops: the envelope's 1/x), inside and past the cutoff
    d = np.concatenate([[0.0, 3.16e-5, 1e-3], rng.uniform(0, 7, 200)]).astype(np.float32)
    ang = rng.uniform(0, np.pi, d.shape).astype(np.float32)
    got = td.rbf_basis(torch.from_numpy(d), cfg_t).numpy()
    want = np.asarray(rd.rbf_basis(d, cfg_r))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    got = td.sbf_basis(torch.from_numpy(d), torch.from_numpy(ang), cfg_t).numpy()
    want = np.asarray(rd.sbf_basis(d, ang, cfg_r))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_params_from_numpy_and_init_layout(ref_runs):
    """The reference's tree comes across leaf for leaf (``blocks`` a list
    of dicts, flattened in ``jax.tree_util``'s order); the port's own
    ``init`` draws the same layout."""
    _, _, cfg_r, _, _, _, cfg_t, _ = _case("molecule", "padded")
    params = ref_runs["molecule", "padded"][0]
    got = td.params_from_numpy(params, cfg_t, device="cpu")
    want_paths = [jax.tree_util.keystr(p, simple=False, separator="/")
                  for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    paths, leaves = tree.flatten_with_paths(got)
    assert isinstance(got["blocks"], list) and len(got["blocks"]) == cfg_t.n_blocks
    for p, g, w in zip(paths, leaves, jax.tree_util.tree_leaves(params)):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)
    assert paths == want_paths
    mine = td.init(torch.Generator().manual_seed(0), cfg_t)
    assert [tuple(t.shape) for t in tree.leaves(mine)] == [
        w.shape for w in jax.tree_util.tree_leaves(params)]
    with pytest.raises(ValueError, match="blocks"):
        td.params_from_numpy(params, dataclasses.replace(cfg_t, n_blocks=3), device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CELLS)
def test_forward_and_loss_match_reference(ref_runs, name, layout):
    params, want_fwd, want_loss, _ = ref_runs[name, layout]
    *_, cfg_t, tb = _case(name, layout)
    p = td.params_from_numpy(params, cfg_t, device="cpu")
    with torch.no_grad():
        fwd = td.forward(p, tb, cfg_t)
        loss = td.loss_fn(p, tb, cfg_t)
    assert tuple(fwd.shape) == want_fwd.shape and fwd.dtype == torch.float32
    np.testing.assert_allclose(fwd.numpy(), want_fwd, rtol=1e-5,
                               atol=1e-5 * np.abs(want_fwd).max())
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CELLS)
def test_gradients_match_reference(ref_runs, name, layout):
    params, _, want_loss, want_g = ref_runs[name, layout]
    *_, cfg_t, tb = _case(name, layout)
    loss, grads = tstep.value_and_grad(lambda p, b: td.loss_fn(p, b, cfg_t),
                                       td.params_from_numpy(params, cfg_t, device="cpu"), tb)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))
    _close_by_leaf(grads, want_g, GRAD_RTOL[layout], f"{name}/{layout} grad")


def test_flat_pad_triplets_are_unmasked_self_triplets_of_edge_0():
    """The reference's flat layout pads its triplets with ``(0, 0)`` and
    masks none of them (``launch/steps.py:209-214``; ROADMAP queue 3):
    each pad adds a triplet of edge 0 with itself to edge 0's aggregate.
    The port copies that math: dropping the pads changes the output of
    edge 0's target node."""
    *_, cfg_t, tb = _case("full_graph_sm", "flat")
    real = td.build_triplets(tb["edge_src"].numpy(), tb["edge_dst"].numpy(),
                             tb["pos"].shape[0], cfg_t.t_max)[0].size
    assert real < tb["tri_kj"].shape[0]
    assert not tb["tri_kj"][real:].any() and not tb["tri_ji"][real:].any()
    # edge 0 inside the cutoff (past it the envelope zeroes its triplets)
    src0, dst0 = int(tb["edge_src"][0]), int(tb["edge_dst"][0])
    assert src0 != dst0
    pos = tb["pos"].clone()
    pos[dst0] = pos[src0] + torch.tensor([0.5, 0.0, 0.0])
    tb = dict(tb, pos=pos)
    p = td.init(torch.Generator().manual_seed(1), cfg_t)
    cut = dict(tb, tri_kj=tb["tri_kj"][:real], tri_ji=tb["tri_ji"][:real])
    with torch.no_grad():
        out, out_cut = td.forward(p, tb, cfg_t), td.forward(p, cut, cfg_t)
    assert not torch.equal(out[dst0], out_cut[dst0])


def test_reference_dimenet_raises_under_single_device_ctx(ref_runs):
    """The reference's finding (ROADMAP queue 3): under the plain
    ``single_device_ctx()`` the output block's ``segment_sum`` over
    ``dst`` (``models/dimenet.py:315``) raises ``ShardingTypeError``; the
    edge-empty context (``CTX``) runs the same math."""
    rspec, rcell, cfg_r, rb, *_ = _case("molecule", "padded")
    params = ref_runs["molecule", "padded"][0]
    with pytest.raises(Exception, match="(?i)sharding") as err:
        jax.jit(lambda p, b: rd.loss_fn(p, b, cfg_r, _BASE))(params, rb)
    assert type(err.value).__name__ == "ShardingTypeError"


# -- the train step and the launcher -------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_step_matches_reference(layout):
    """One ``build_step`` step of ``full_graph_sm`` from the reference's
    initial state: loss, ``grad_norm``, ``lr_scale``, AdamW's first moment
    (``0.1 *`` the clipped gradients) and the parameters."""
    rspec, rcell, cfg_r, rb, tspec, tcell, cfg_t, tb = _case("full_graph_sm", layout)
    rcfg = RTrainConfig(**TCFG)
    rstate = jax.jit(lambda k: rinit_state(k, lambda r: rd.init(r, cfg_r), rcfg))(
        jax.random.key(0))
    rs, rm = jax.jit(rmake_step(lambda p, b: rd.loss_fn(p, b, cfg_r, CTX), rcfg))(rstate, rb)
    rs, rm = _np(rs), _np(rm)
    bundle = tsteps.build_step(tspec, tcell, tcfg=TrainConfig(**TCFG))
    assert bundle.kind == "graph_train" and bundle.cfg == cfg_t
    ts, tm = bundle.fn(state_from_numpy(_np(rstate), device="cpu"), tb)
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=GRAD_RTOL[layout])
    assert float(tm["lr_scale"]) == pytest.approx(float(rm["lr_scale"]), rel=1e-6)
    assert int(ts["step"]) == 1
    _close_by_leaf(ts["opt"]["m"], rs["opt"]["m"], GRAD_RTOL[layout], "m")
    lr = RTrainConfig().lr
    for p, a, b in zip(*tree.flatten_with_paths(ts["params"]),
                       jax.tree_util.tree_leaves(rs["params"])):
        diff = np.abs(a.numpy() - b)
        assert diff.max() <= 2 * lr, (p, diff.max())
        assert (diff > lr * 1e-2).mean() <= PARAM_OFF_SHARE[layout], (p, (diff > lr * 1e-2).sum())


def test_build_step_builds_every_graph_cell_and_refuses_other_kinds():
    tspec = tconfigs.get("dimenet", reduced=True)
    for cell in tspec.shapes:
        bundle = tsteps.build_step(tspec, cell)
        assert bundle.kind == "graph_train" and callable(bundle.fn) and callable(bundle.init_fn)
        assert bundle.cfg == tsteps._cfg_for_cell(tspec, cell)
    full = tconfigs.get("dimenet")
    assert {tsteps.build_step(full, c).cfg.t_max for c in full.shapes} == {2, 4}
    train = tconfigs.ShapeCell("train_4k", "train", {"seq_len": 8, "global_batch": 2})
    with pytest.raises(ValueError) as err:
        tsteps.build_step(tspec, train)
    assert err.value.args[0] == ("gnn", "train")
    with pytest.raises(ValueError):
        tsteps.make_inputs(tspec, train, device="cpu")


@pytest.mark.parametrize("cell", [None, "molecule"])
def test_launch_train_trains_dimenet_on_the_cpu(capsys, cell):
    from repro_torch.launch import train

    argv = ["--arch", "dimenet", "--reduced", "--steps", "3", "--device", "cpu"]
    state, report = train.main(argv + (["--cell", cell] if cell else []))
    assert report.steps_run == 3 and all(np.isfinite(report.losses))
    assert int(state["step"]) == 3
    assert "[train] done: 3 steps" in capsys.readouterr().out


def test_entry_points_default_to_the_card(monkeypatch, ref_runs):
    """``make_inputs`` and ``params_from_numpy`` run on the card unless
    asked for the CPU: with no CUDA device they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tspec = tconfigs.get("dimenet", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.make_inputs(tspec, tspec.shapes[0])
    cfg_t = tsteps._cfg_for_cell(tspec, _cell(tspec, "molecule"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.params_from_numpy(ref_runs["molecule", "padded"][0], cfg_t)
