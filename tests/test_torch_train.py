"""The port's training core (``train.schedule``, ``train.optimizer``,
``train.step``, the gradient compression of ``dist.collectives``,
``layers.cross_entropy``, ``transformer.loss_fn`` with its chunked loss
and remat, and ``layers.causal_attention``'s gradient) held against the
JAX reference on the CPU.

The same numpy inputs (and the reference's initial weights and train
state, carried across with ``train.state_from_numpy``) go through both;
each reference function is jitted once a module (fixtures).
Tolerances, each measured first:
- schedules: rtol 1e-6 (f32 ``cos``/``pow`` may differ by an ulp);
- optimizers: moments and parameters within 1e-6 relative after five
  updates (f32 and bf16 leaves, factored and unfactored);
- compression: bit-equal on the same inputs;
- the reduced qwen2-0.5b in f32: loss, ``grad_norm`` and every gradient
  within 1e-5 relative (of the leaf's largest magnitude; measured
  1.8e-6: sums in another order).  The gradients are compared
  themselves (and through AdamW's first moment, ``0.1 * g``), since
  AdamW turns near-zero gradient differences into ``±lr`` steps; the
  parameters after each step within ``1e-3 lr`` on all but 0.1% of the
  elements and ``2 lr`` a step everywhere;
- the same in bf16 (the config's own compute): loss within 2e-3 and
  gradients within 0.05 of the leaf's largest magnitude (measured
  0.024: both round every product to bf16, at other places);
- under compression a rounding tie may fall the other way where the
  gradients differ in their last bits: ``comp_err`` and the first moment
  within one quantum (int8: ``G / 127``; bf16: ``2^-8 G``, ``G`` the
  leaf's largest gradient) on at most 1% of the elements, within 1e-5
  of ``G`` elsewhere.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist import collectives as rcoll
from repro.dist.sharding import single_device_ctx
from repro.models import layers as rlayers
from repro.models import transformer as rt
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_train_state as rinit_state
from repro.train import make_train_step as rmake_step
from repro.train import optimizer as ropt
from repro.train import schedule as rsched
from repro.train import step as rstep
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.dist import collectives as tcoll
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.train import TrainConfig, make_train_step, state_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import schedule as tsched
from repro_torch.train import step as tstep
from test_torch_gpu import deterministic  # noqa: F401  (fixture)

CTX = single_device_ctx()
F32_GRAD_RTOL = 1e-5
BF16_LOSS_TOL, BF16_GRAD_TOL = 2e-3, 0.05
TCFG = dict(total_steps=4, warmup=1)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close_by_leaf(got, want, rtol, what=""):
    """Each leaf of ``got`` (tensors) within ``rtol`` of the largest
    magnitude of ``want``'s matching leaf (numpy)."""
    paths, leaves = tree.flatten_with_paths(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len(wl)
    for p, g, w in zip(paths, leaves, wl):
        g, w = g.float().numpy(), np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape, p
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {p}")


# -- schedules ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("warmup_cosine", {"warmup": 100, "total": 300}),
    ("warmup_cosine", {"warmup": 1, "total": 4}),
    ("warmup_cosine", {"warmup": 0, "total": 50, "floor": 0.25}),
    ("constant", {}),
    ("inv_sqrt", {"warmup": 10}),
    ("inv_sqrt", {"warmup": 0}),
])
def test_schedules_match_reference(name, kw):
    steps = np.arange(0, 301, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: rsched.SCHEDULES[name](s, **kw)))(steps))
    fn = tsched.SCHEDULES[name]
    got = np.array([fn(torch.tensor(s, dtype=torch.int32), **kw).item() for s in steps])
    assert fn(torch.tensor(5, dtype=torch.int32), **kw).dtype == torch.float32
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=1e-6)
    # a Python int step gives the same f32 value
    assert fn(7, **kw).item() == pytest.approx(float(np.broadcast_to(want, got.shape)[7]),
                                               rel=1e-6)


# -- optimizers --------------------------------------------------------------------------


def _opt_tree(rng):
    """f32 and bf16 leaves, factored (ndim >= 2) and not, in nested dicts
    and a list, so the flattening order matters."""
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {"b": {"w": f(8, 6), "bias": f(6)}, "a": [f(3, 4, 5), f(7)],
            "c": {"bf": f(4, 5), "bv": f(9)}}


def _as_dtypes(tree_np, to_tensor):
    """bf16 for the leaves under ``"c"``, f32 elsewhere."""
    out = {}
    for k, v in tree_np.items():
        bf = k == "c"
        if isinstance(v, dict):
            out[k] = {n: to_tensor(a, bf) for n, a in v.items()}
        else:
            out[k] = [to_tensor(a, bf) for a in v]
    return out


def _jax_leaf(a, bf):
    return jnp.asarray(a).astype(jnp.bfloat16 if bf else jnp.float32)


def _torch_leaf(a, bf):
    return torch.from_numpy(a).to(torch.bfloat16 if bf else torch.float32)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_matches_reference(name):
    """Five updates with seeded gradients and a moving ``lr_scale``: the
    moments and the parameters (f32 and bf16 leaves) within 1e-6."""
    rng = np.random.default_rng(3)
    params_np = _opt_tree(rng)
    rp, tp = _as_dtypes(params_np, _jax_leaf), _as_dtypes(params_np, _torch_leaf)
    if name == "sgd":
        rinit, tinit = ropt.sgd_init, topt.sgd_init
        rupd = jax.jit(lambda g, s, p, ls: ropt.sgd_update(g, s, p, 0.05, ls))
        tupd = lambda g, s, p, ls: topt.sgd_update(g, s, p, 0.05, ls)
    else:
        rinit, rupd0, rcls = ropt.OPTIMIZERS[name]
        tinit, tupd0, tcls = topt.OPTIMIZERS[name]
        rcfg, tcfg = rcls(lr=0.05), tcls(lr=0.05)
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
        rupd = jax.jit(lambda g, s, p, ls: rupd0(g, s, p, rcfg, ls))
        tupd = lambda g, s, p, ls: tupd0(g, s, p, tcfg, ls)
    rs, ts = rinit(rp), tinit(tp)
    for i in range(5):
        g_np = _opt_tree(rng)
        ls = np.float32(0.5 + 0.1 * i)
        rp, rs = rupd(_as_dtypes(g_np, _jax_leaf), rs, rp, jnp.float32(ls))
        tp, ts = tupd(_as_dtypes(g_np, _torch_leaf), ts, tp, torch.tensor(ls))
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        for got, want in ((tp, rp), (ts, rs)):
            paths, gl = tree.flatten_with_paths(got)
            wl = jax.tree_util.tree_leaves(want)
            assert len(gl) == len(wl)
            for p, g, w in zip(paths, gl, wl):
                assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else
                                   getattr(torch, str(w.dtype))), p
                np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                           rtol=1e-6, atol=1e-7, err_msg=f"update {i} {p}")


def test_adafactor_factors_ndim_two_and_up():
    tp = {"m": torch.zeros(3, 4), "t": torch.zeros(2, 3, 4), "v": torch.zeros(5)}
    v = topt.adafactor_init(tp)["v"]
    assert {k: tuple(t.shape) for k, t in v["m"].items()} == {"vr": (3,), "vc": (4,)}
    assert {k: tuple(t.shape) for k, t in v["t"].items()} == {"vr": (2, 3), "vc": (2, 4)}
    assert list(v["v"]) == ["v"]


# -- gradient compression ------------------------------------------------------------------


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compressed_grad_leaf_is_bit_equal(method):
    """Three steps of error feedback on the same gradients (including
    halves of the int8 quantum and values that round to bf16 ties)."""
    rng = np.random.default_rng(5)
    err_r, err_t = jnp.zeros((64,), jnp.float32), torch.zeros(64)
    fn = jax.jit(lambda g, e: rcoll.compressed_grad_leaf(g, e, method))
    for i in range(3):
        g = rng.normal(0, 1, 64).astype(np.float32)
        g[:8] = (np.arange(8) + 0.5) * (np.abs(g).max() / 127)  # int8 ties
        g[8:16] = np.float32(1.0) + np.float32(2.0 ** -8) * np.arange(1, 9)  # bf16 ties and not
        hat_r, err_r = fn(jnp.asarray(g), err_r)
        hat_t, err_t = tcoll.compressed_grad_leaf(torch.from_numpy(g), err_t, method)
        assert hat_t.dtype == err_t.dtype == torch.float32
        np.testing.assert_array_equal(hat_t.numpy(), np.asarray(hat_r), err_msg=f"step {i}")
        np.testing.assert_array_equal(err_t.numpy(), np.asarray(err_r), err_msg=f"step {i}")


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_apply_grad_compression_is_bit_equal(method):
    rng = np.random.default_rng(6)
    g_np = _opt_tree(rng)
    e_np = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32), _opt_tree(rng))
    want = jax.jit(lambda g, e: rcoll.apply_grad_compression(g, e, method))(g_np, e_np)
    got = tcoll.apply_grad_compression(tree.tree_map(_t, g_np), tree.tree_map(_t, e_np), method)
    for g, w in zip(got, want):
        assert isinstance(g["a"], list)
        for a, b in zip(tree.leaves(g), jax.tree_util.tree_leaves(w)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tcoll.METHODS == rcoll.METHODS
    with pytest.raises(ValueError, match="unknown grad compression"):
        tcoll.compressed_grad_leaf(torch.zeros(3), torch.zeros(3), "fp8")


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(7)
    g_np = _opt_tree(rng)
    rg, tg = _as_dtypes(g_np, _jax_leaf), _as_dtypes(g_np, _torch_leaf)
    want = float(jax.jit(rstep.global_norm)(rg))
    assert float(tstep.global_norm(tg)) == pytest.approx(want, rel=1e-6)
    for max_norm in (0.5, 1e6):
        wc, wn = jax.jit(lambda t: rstep.clip_by_global_norm(t, max_norm))(rg)
        gc, gn = tstep.clip_by_global_norm(tg, max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        for a, b in zip(tree.leaves(gc), jax.tree_util.tree_leaves(wc)):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32)
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                       rtol=1e-6, atol=1e-7)


# -- losses ----------------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 3, (3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    want = float(rlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = tlayers.cross_entropy(_t(logits), _t(labels))
    assert got.dtype == torch.float32 and float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,q_chunk", [(48, 16), (40, 16)], ids=["chunked", "one_chunk"])
def test_causal_attention_gradient_matches_reference(dtype, s, q_chunk):
    """The gradient of ``sum(out * w)`` for q, k, v: the port writes its
    chunks in place (``masked_fill_``, ``out[:, ci] = ...``); autograd must
    still give ``jax.grad`` of the reference's.  f32: 2e-5 of the largest
    magnitude; bf16: 0.03 (rounded at other places)."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 8, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, 2, 16)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=q.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def ref(a, b, c):
        out = rlayers.causal_attention(a, b, c, q_chunk=q_chunk)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2)))(*(jnp.asarray(x).astype(jdt)
                                                       for x in (q, k, v)))
    ins = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    out = tlayers.causal_attention(*ins, q_chunk=q_chunk)
    (out.float() * torch.from_numpy(w)).sum().backward()
    tol = 2e-5 if dtype == "float32" else 0.03
    for name, t, r in zip("qkv", ins, want):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)


# -- the LM train step ---------------------------------------------------------------------


def _lm_cfgs(dtype, **kw):
    r = dataclasses.replace(rconfigs.get("qwen2-0.5b", reduced=True).config, dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.get("qwen2-0.5b", reduced=True).config, dtype=dtype, **kw)
    return r, t


@functools.lru_cache(maxsize=None)
def _ref_lm_state(tcfg_r):
    cfg_r, _ = _lm_cfgs("float32")
    return _np(jax.jit(lambda k: rinit_state(k, lambda r: rt.init(r, cfg_r), tcfg_r))(
        jax.random.key(0)))


def _lm_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (4, 64)).astype(np.int32) for k in ("tokens", "labels")}


@pytest.mark.parametrize("dtype,xent_chunk", [("float32", 512), ("float32", 16),
                                              ("float32", 24), ("bfloat16", 512)],
                         ids=["f32", "f32-xent16", "f32-xent24-one-chunk", "bf16"])
def test_lm_loss_and_gradients_match_reference(dtype, xent_chunk):
    """``transformer.loss_fn``'s value and gradients on the reduced
    qwen2-0.5b (2 x 64 tokens a row, 4 rows): the loss chunked by 16
    (four chunks), by 24 (which does not divide 64: one chunk) and by the
    config's 512 (one chunk)."""
    cfg_r, cfg_t = _lm_cfgs(dtype, xent_chunk=xent_chunk)
    params = _ref_lm_state(RTrainConfig(**TCFG))["params"]
    batch = _lm_batch()
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, b, cfg_r, CTX)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = state_from_numpy({"p": params}, device="cpu")["p"]
    got_l, got_g = tstep.value_and_grad(lambda p, b: tt.loss_fn(p, b, cfg_t), tp,
                                        {k: _t(v) for k, v in batch.items()})
    assert got_l.dtype == torch.float32 and not got_l.requires_grad
    if dtype == "float32":
        assert float(got_l) == pytest.approx(float(want_l), rel=1e-6)
        _close_by_leaf(got_g, want_g, F32_GRAD_RTOL, "grad")
    else:
        assert float(got_l) == pytest.approx(float(want_l), abs=BF16_LOSS_TOL)
        _close_by_leaf(got_g, want_g, BF16_GRAD_TOL, "grad")


def test_remat_changes_no_gradient(deterministic):
    """Remat on and off (the layer bodies and the loss chunks recomputed
    in the backward pass, or kept) give the same loss and gradients, bit
    for bit on the CPU (deterministic kernels: the embedding gather's
    backward accumulates repeated tokens)."""
    _, cfg_t = _lm_cfgs("float32", xent_chunk=16)
    params = tt.init(torch.Generator().manual_seed(1), cfg_t)
    batch = {k: _t(v) for k, v in _lm_batch(1).items()}
    outs = [tstep.value_and_grad(lambda p, b: tt.loss_fn(p, b, c), params, batch)
            for c in (cfg_t, dataclasses.replace(cfg_t, remat=False))]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree.leaves(outs[0][1]), tree.leaves(outs[1][1])):
        assert torch.equal(a, b)
    with torch.no_grad():  # serving paths: no grad, no checkpoint
        assert torch.equal(tt.loss_fn(params, batch, cfg_t), outs[0][0])


STEP_CASES = {
    "f32": ("float32", {}),
    "bf16": ("bfloat16", {}),
    "microbatches2": ("float32", {"microbatches": 2}),
    "int8": ("float32", {"grad_compression": "int8"}),
    "bf16_compression": ("float32", {"grad_compression": "bf16"}),
}


@pytest.fixture(scope="module")
def lm_steps():
    """Each case's reference step (jitted, two steps from the same state)
    and the port's, on the same batches."""
    out = {}
    for name, (dtype, kw) in STEP_CASES.items():
        cfg_r, cfg_t = _lm_cfgs(dtype)
        rcfg, tcfg = RTrainConfig(**TCFG, **kw), TrainConfig(**TCFG, **kw)
        rs = _ref_lm_state(rcfg)
        rstep_fn = jax.jit(rmake_step(lambda p, b: rt.loss_fn(p, b, cfg_r, CTX), rcfg))
        tstep_fn = make_train_step(lambda p, b: tt.loss_fn(p, b, cfg_t), tcfg)
        ts = state_from_numpy(rs, device="cpu")
        rows = []
        for i in range(2):
            batch = _lm_batch(10 + i)
            rs, rm = rstep_fn(rs, {k: jnp.asarray(v) for k, v in batch.items()})
            ts, tm = tstep_fn(ts, {k: _t(v) for k, v in batch.items()})
            rows.append((_np(rs), _np(rm), ts, tm))
        out[name] = rows
    return out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_lm_train_step_matches_reference(lm_steps, case):
    """Two steps of ``make_train_step`` (AdamW, ``warmup_cosine``, clip
    1.0) on the reduced qwen2-0.5b from the reference's initial state:
    the metrics, AdamW's moments (its first moment is ``0.1 * g`` after
    one step: the clipped gradients themselves), the parameters, and
    under compression the error buffers.  With ``microbatches=2`` the loss
    is the last microbatch's, as the reference's."""
    dtype, kw = STEP_CASES[case]
    grad_tol = F32_GRAD_RTOL if dtype == "float32" else BF16_GRAD_TOL
    for i, (rs, rm, ts, tm) in enumerate(lm_steps[case]):
        assert set(tm) == {"loss", "grad_norm", "lr_scale"}
        assert int(ts["step"]) == int(ts["opt"]["step"]) == i + 1
        loss_tol = 1e-6 if dtype == "float32" else BF16_LOSS_TOL
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=loss_tol, abs=loss_tol)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                       rel=grad_tol if i == 0 else 1e-3)
        assert float(tm["lr_scale"]) == pytest.approx(float(rm["lr_scale"]), rel=1e-6)
        if i == 0 and "grad_compression" in kw:
            clip = min(1.0, 1.0 / float(rm["grad_norm"]))
            for got, want, factor in ((ts["opt"]["m"], rs["opt"]["m"], 0.1 * clip),
                                      (ts["comp_err"], rs["comp_err"], 1.0)):
                _check_rounded(got, want, rs["opt"]["m"], clip, factor, kw["grad_compression"])
        elif i == 0:
            _close_by_leaf(ts["opt"]["m"], rs["opt"]["m"], grad_tol, "m")
        # AdamW moves each parameter by about lr a step: where a gradient is
        # ~0 its sign may differ, which moves the parameter by up to 2 lr
        lr = RTrainConfig().lr
        for p, a, b in zip(*tree.flatten_with_paths(ts["params"]),
                           jax.tree_util.tree_leaves(rs["params"])):
            diff = np.abs(a.numpy() - b)
            assert diff.max() <= 2 * lr * (i + 1), (p, diff.max())
            if dtype == "float32":
                assert (diff > lr * 1e-3).mean() <= 1e-3, (p, (diff > lr * 1e-3).sum())
    if case == "microbatches2":
        # the reported loss is the second half's (the last microbatch), not the mean
        cfg_r, _ = _lm_cfgs("float32")
        batch = _lm_batch(10)
        params = _ref_lm_state(RTrainConfig(**TCFG))["params"]
        halves = [float(jax.jit(lambda p, b: rt.loss_fn(p, b, cfg_r, CTX))(
            params, {k: jnp.asarray(v[h * 2:(h + 1) * 2]) for k, v in batch.items()}))
            for h in range(2)]
        got = float(lm_steps[case][0][3]["loss"])
        assert got == pytest.approx(halves[1], rel=1e-6)
        assert abs(got - halves[0]) > 1e-4


def _check_rounded(got, want, m_ref, clip, factor, method):
    """A tree that carries the compressed gradient times ``factor`` (AdamW's
    first moment after one step: ``0.1 * clip``; the error buffers: 1),
    leaf by leaf against the reference's.  ``G``, a leaf's largest
    gradient magnitude, comes from the reference's first moment.  Equal
    within 1e-5 of ``factor * G``, except where a rounding tie fell the
    other way because the gradients differ in their last bits: at most 1%
    of the elements, each off by at most one quantum (int8: ``G / 127``;
    bf16: ``2^-8 G``)."""
    for p, g, w, m in zip(*tree.flatten_with_paths(got), jax.tree_util.tree_leaves(want),
                          jax.tree_util.tree_leaves(m_ref)):
        g, w = g.numpy(), np.asarray(w)
        big = max(np.abs(np.asarray(m)).max() / (0.1 * clip), 1e-30)
        diff = np.abs(g - w)
        tight = F32_GRAD_RTOL * factor * big
        assert (diff > tight).mean() <= 0.01, (p, (diff > tight).mean())
        quantum = big / 127 if method == "int8" else big * 2.0 ** -8
        assert diff.max() <= tight + 1.01 * factor * quantum, (p, method, diff.max())
