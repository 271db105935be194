"""The port's training of the recsys archs and of the MoE decoder
(``recsys.loss_fn``, the recsys ``train`` cells of ``launch.steps``,
``transformer.loss_fn`` over ``moe_ffn``) held against the JAX reference
on the CPU.

The recsys steps run the port under each config's own
``lookup_mode="a2a"`` (one rank's lookup is a gather in both modes) and
the reference under ``"allreduce"``: under ``"a2a"`` every reference
recsys ``train`` cell raises ``ShardingTypeError`` at ``train/step.py:74``
(ROADMAP queue 3; ``test_reference_recsys_train_raises_under_a2a``).
Tolerances (f32, measured first): losses within 1e-6 relative;
gradients within 1e-5 of the leaf's largest magnitude, or 1e-9 absolute
(DIN's last attention bias has an exactly-zero gradient, the softmax
being shift-invariant: ~1e-11 of noise in both); parameters after two
AdamW steps within 1e-2 lr on all but 0.1% of the elements (a gradient
sign may differ where it is ~0) and 2 lr a step everywhere.

The reference gives an MoE loss but no MoE gradient: ``jax.grad`` of its
``loss_fn`` raises (``test_reference_moe_has_no_gradient``).  So the
port's MoE gradient is held against central finite differences of its
own f32 loss with the routing held at the base point's choice (a
gradient is the derivative of that branch): Richardson-extrapolated
from steps 4e-4 and 2e-4 along three seeded directions, within 3e-3
relative (measured at most 6.3e-4).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import single_device_ctx
from repro.launch import steps as rsteps
from repro.models import recsys as rr
from repro.models import transformer as rt
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_train_state as rinit_state
from repro.train import make_train_step as rmake_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import recsys as tr
from repro_torch.models import transformer as tt
from repro_torch.train import TrainConfig, state_from_numpy
from repro_torch.train import step as tstep
from test_torch_gpu import deterministic  # noqa: F401  (fixture)

CTX = single_device_ctx()
RECSYS_ARCHS = ("dlrm-mlperf", "din", "wide-deep", "sasrec")
TCFG = dict(total_steps=4, warmup=1)
GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-9
MOE = "moonshot-v1-16b-a3b"


def _np(t):
    return jax.tree.map(np.asarray, t)


def _close_by_leaf(got, want, what=""):
    paths, leaves = tree.flatten_with_paths(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len(wl)
    for p, g, w in zip(paths, leaves, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, p
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=f"{what} {p}",
                                   atol=max(GRAD_RTOL * np.abs(w).max(), GRAD_FLOOR))


def _specs(arch):
    return rconfigs.get(arch, reduced=True), tconfigs.get(arch, reduced=True)


def _train_cell(spec):
    return next(c for c in spec.shapes if c.kind == "train")


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    """The reference's initial train state under ``"allreduce"`` (numpy
    leaves); ``lookup_mode`` does not enter the draws."""
    cfg_r = dataclasses.replace(_specs(arch)[0].config, lookup_mode="allreduce")
    rcfg = RTrainConfig(**TCFG)
    return _np(jax.jit(lambda k: rinit_state(k, lambda r: rr.init(r, cfg_r, CTX), rcfg))(
        jax.random.key(0)))


def _batch(arch, seed):
    rspec, tspec = _specs(arch)
    rb = rsteps.make_inputs(rspec, _train_cell(rspec), False, np.random.default_rng(seed))
    tb = tsteps.make_inputs(tspec, _train_cell(tspec), np.random.default_rng(seed), device="cpu")
    return rb, tb


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_loss_and_gradients_match_reference(arch):
    rspec, tspec = _specs(arch)
    assert tspec.config.lookup_mode == "a2a"
    cfg_r = dataclasses.replace(rspec.config, lookup_mode="allreduce")
    params = _ref_state(arch)["params"]
    rb, tb = _batch(arch, 0)
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p, b: rr.loss_fn(p, b, cfg_r, CTX)))(
        params, rb)
    got_l, got_g = tstep.value_and_grad(lambda p, b: tr.loss_fn(p, b, tspec.config),
                                        state_from_numpy({"p": params}, device="cpu")["p"], tb)
    assert got_l.dtype == torch.float32
    assert float(got_l) == pytest.approx(float(want_l), rel=1e-6)
    _close_by_leaf(got_g, want_g, "grad")


@pytest.fixture(scope="module")
def recsys_steps():
    """Two steps of each arch's ``train`` cell from the reference's state
    on the batches of seeds 0 and 1: the reference's (jitted, under
    ``"allreduce"``) and the port's ``build_step`` (under ``"a2a"``)."""
    out = {}
    for arch in RECSYS_ARCHS:
        rspec, tspec = _specs(arch)
        cfg_r = dataclasses.replace(rspec.config, lookup_mode="allreduce")
        rfn = jax.jit(rmake_step(lambda p, b, c=cfg_r: rr.loss_fn(p, b, c, CTX),
                                 RTrainConfig(**TCFG)))
        tfn = tsteps.build_step(tspec, _train_cell(tspec), tcfg=TrainConfig(**TCFG)).fn
        rs = _ref_state(arch)
        ts = state_from_numpy(rs, device="cpu")
        rows = []
        for i in range(2):
            rb, tb = _batch(arch, i)
            rs, rm = rfn(rs, rb)
            ts, tm = tfn(ts, tb)
            rows.append((_np(rs), _np(rm), ts, tm))
        out[arch] = rows
    return out


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_cell_matches_reference(recsys_steps, arch):
    """Loss, ``grad_norm`` and ``lr_scale`` of both steps; AdamW's first
    moment after the first (``0.1 * g``: the clipped gradients); the
    parameters and moments after both."""
    lr = RTrainConfig().lr
    for i, (rs, rm, ts, tm) in enumerate(recsys_steps[arch]):
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-5)
        assert float(tm["lr_scale"]) == pytest.approx(float(rm["lr_scale"]), rel=1e-6)
        assert int(ts["step"]) == i + 1
        if i == 0:
            _close_by_leaf(ts["opt"]["m"], rs["opt"]["m"], "m")
        for p, a, b in zip(*tree.flatten_with_paths(ts["params"]),
                           jax.tree_util.tree_leaves(rs["params"])):
            diff = np.abs(a.numpy() - b)
            assert diff.max() <= 2 * lr * (i + 1), (p, diff.max())
            assert (diff > lr * 1e-2).mean() <= 1e-3, (p, (diff > lr * 1e-2).sum())


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_step_is_the_same_under_both_lookup_modes(arch, deterministic):
    """On one rank ``"a2a"`` and ``"allreduce"`` are the same gather: the
    port's step gives bit-equal states under either (deterministic
    kernels: the gather's backward accumulates repeated rows)."""
    _, tspec = _specs(arch)
    cell = _train_cell(tspec)
    states = []
    for mode in ("a2a", "allreduce"):
        spec = dataclasses.replace(tspec, config=dataclasses.replace(tspec.config,
                                                                     lookup_mode=mode))
        fn = tsteps.build_step(spec, cell, tcfg=TrainConfig(**TCFG)).fn
        st = state_from_numpy(_ref_state(arch), device="cpu")
        st, _ = fn(st, _batch(arch, 0)[1])
        states.append(st)
    for a, b in zip(tree.leaves(states[0]), tree.leaves(states[1])):
        assert torch.equal(a, b)


def test_reference_recsys_train_raises_under_a2a():
    """The reference's finding (ROADMAP queue 3): its recsys ``train``
    cell under the config's own ``"a2a"`` raises ``ShardingTypeError``
    inside ``jax.value_and_grad`` (``train/step.py:74``); the port trains
    there."""
    rspec, tspec = _specs("wide-deep")
    assert rspec.config.lookup_mode == "a2a"
    fn = jax.jit(rmake_step(lambda p, b: rr.loss_fn(p, b, rspec.config, CTX),
                            RTrainConfig(**TCFG)))
    with pytest.raises(Exception, match="(?i)sharding"):
        fn(_ref_state("wide-deep"), _batch("wide-deep", 0)[0])
    tfn = tsteps.build_step(tspec, _train_cell(tspec), tcfg=TrainConfig(**TCFG)).fn
    _, m = tfn(state_from_numpy(_ref_state("wide-deep"), device="cpu"),
               _batch("wide-deep", 0)[1])
    assert np.isfinite(float(m["loss"]))


# -- MoE -------------------------------------------------------------------------------------


def _moe_cfgs():
    rspec, tspec = _specs(MOE)
    return (dataclasses.replace(rspec.config, dtype="float32"),
            dataclasses.replace(tspec.config, dtype="float32"))


@functools.lru_cache(maxsize=None)
def _moe_params():
    cfg_r, _ = _moe_cfgs()
    return _np(jax.jit(lambda k: rt.init(k, cfg_r))(jax.random.key(0)))


def _moe_batch():
    rspec, tspec = _specs(MOE)
    rb = rsteps.make_inputs(rspec, _train_cell(rspec), False, np.random.default_rng(0))
    tb = tsteps.make_inputs(tspec, _train_cell(tspec), np.random.default_rng(0), device="cpu")
    return rb, tb


def test_moe_loss_matches_reference():
    """The reduced moonshot's ``train_4k`` loss (4 x 64 tokens, 8 experts
    top 2 plus a shared one, capacity 80) in f32 against the reference's
    jitted ``loss_fn``: within 1e-6 relative."""
    cfg_r, cfg_t = _moe_cfgs()
    rb, tb = _moe_batch()
    want = float(jax.jit(lambda p, b: rt.loss_fn(p, b, cfg_r, CTX))(_moe_params(), rb))
    got = tt.loss_fn(tt.params_from_numpy(_moe_params(), cfg_t, device="cpu"), tb, cfg_t)
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_reference_moe_has_no_gradient():
    """The reference's finding (ROADMAP queue 3): ``jax.grad`` of its MoE
    ``loss_fn`` raises (``ShardingTypeError`` at the ``shard_map``
    boundary), so neither its MoE train step nor a gradient can be held
    against it."""
    cfg_r, _ = _moe_cfgs()
    rb, _ = _moe_batch()
    with pytest.raises(Exception, match="(?i)sharding"):
        jax.jit(jax.grad(lambda p, b: rt.loss_fn(p, b, cfg_r, CTX)))(_moe_params(), rb)


@pytest.fixture(scope="module")
def moe_grad():
    _, cfg_t = _moe_cfgs()
    params = tt.params_from_numpy(_moe_params(), cfg_t, device="cpu")
    tb = _moe_batch()[1]
    loss, grads = tstep.value_and_grad(lambda p, b: tt.loss_fn(p, b, cfg_t), params, tb)
    return cfg_t, params, tb, loss, grads


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_moe_gradient_matches_finite_differences(moe_grad, monkeypatch, direction):
    """``<grad, d>`` against the central difference of the f32 loss along
    a seeded normal direction ``d``, the top-k choice of every layer held
    at the base point's (``moe._top_k`` recorded, then replayed with the
    probabilities gathered at the recorded experts)."""
    cfg_t, params, batch, loss0, grads = moe_grad
    picks, orig = [], tmoe._top_k

    def record(probs, k):
        vals, idx = orig(probs, k)
        picks.append(idx)
        return vals, idx

    def replay(probs, k):
        idx = picks[replay.calls % len(picks)]
        replay.calls += 1
        return torch.gather(probs, -1, idx), idx

    replay.calls = 0
    f = functools.partial(tt.loss_fn, batch=batch, cfg=cfg_t)
    with torch.no_grad():
        monkeypatch.setattr(tmoe, "_top_k", record)
        assert torch.equal(f(params), loss0)
        assert len(picks) == cfg_t.n_layers
        monkeypatch.setattr(tmoe, "_top_k", replay)
        leaves = tree.leaves(params)
        gen = torch.Generator().manual_seed(100 + direction)
        d = [torch.randn(p.shape, generator=gen) for p in leaves]

        def fd(h):
            lp = f(tree.unflatten(params, [p + h * x for p, x in zip(leaves, d)]))
            lm = f(tree.unflatten(params, [p - h * x for p, x in zip(leaves, d)]))
            return (float(lp) - float(lm)) / (2 * h)

        want = (4 * fd(2e-4) - fd(4e-4)) / 3
    got = sum(float((g.double() * x.double()).sum()) for g, x in zip(tree.leaves(grads), d))
    assert got == pytest.approx(want, rel=3e-3)


def test_moe_train_step_runs_and_lowers_the_loss():
    """The port's MoE ``train`` cell (AdamW, lr 1e-2, constant) on one
    repeated batch: finite losses that fall over five steps, every
    parameter leaf (experts and router included) moved."""
    _, tspec = _specs(MOE)
    cfg = dataclasses.replace(tspec.config, dtype="float32")
    spec = dataclasses.replace(tspec, config=cfg)
    tcfg = TrainConfig(lr=1e-2, schedule="constant")
    bundle = tsteps.build_step(spec, _train_cell(spec), tcfg=tcfg)
    state = state_from_numpy(_np(jax.jit(lambda k: rinit_state(
        k, lambda r: rt.init(r, _moe_cfgs()[0]), RTrainConfig()))(jax.random.key(0))),
        device="cpu")
    start = tree.leaves(state["params"])
    batch = _moe_batch()[1]
    losses = []
    for _ in range(5):
        state, m = bundle.fn(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses
    for p, a, b in zip(tree.flatten_with_paths(state["params"])[0], tree.leaves(state["params"]),
                       start):
        assert not torch.equal(a, b), p
