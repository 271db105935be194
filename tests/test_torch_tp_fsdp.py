"""The LM family placed over ``fsdp``, ``tp`` and ``ep``, held on the CPU:
the port's ``tp_fsdp`` train step over a (2, 2) mesh of 4 spawned gloo
ranks (``test_torch_gpu.placed_rank_cases``) against the reference's
jitted step on the same mesh of 4 forced host devices, and against the
port's one-rank step.

Once for the module (fixture ``runs``), side by side: the reference in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, an
``AxisType.Auto`` mesh: its sharding constraints need auto axes), the 4
port ranks, and here the port's one-rank steps.  Every run starts from
the same seeded state (the port's ``init_train_state``, carried to the
reference leaf by leaf) and batch, in f32.

* reduced granite-3-8b ``train_4k`` (one KV head over 2 ``tp`` ranks: the
  replicated-K/V path): each placed leaf's shard shape and a rank's state
  bytes equal the reference's exactly; the loss, ``grad_norm``, the
  gradients and the new state within the tolerances below of the
  reference's jitted step and of the one-rank step;
* reduced moonshot-v1-16b-a3b (4 KV heads over 2: split; 8 experts over
  ``ep`` 2): the loss, gradient and step against the reference's jitted
  ones on the mesh (on these auto axes its MoE has a gradient: under its
  ``single_device_ctx`` it raises, ROADMAP queue 3), and against the
  port's one-rank step with 2 microbatches, each one ``dp`` shard's 2
  sequences, so each has the same per-shard capacity (``ceil(128 * 2 / 8
  * 1.25) = 40`` slots an expert);
* granite with a vocabulary of 255 (``fit_sharding`` leaves ``embed``
  and ``head`` whole over ``tp``) against the one-rank step;
* Adafactor on the placed granite (its factored moments whole, their row
  and column means summed over the split axes) against the one-rank step;
* ``shard_state``/``gather_state`` round trips and a checkpoint saved on
  (2, 2) and restored on (1, 1), (4, 1) and (1, 4), bit-equal;
* the refusal of whole replicas under a placed context.

Tolerances (f32 compute; the tensor-parallel sums, the reduce-scatters
and the vocabulary-parallel logsumexp add in other orders than one
device): loss and ``grad_norm`` within ``RTOL`` (1e-5) relative; each
gradient leaf, and AdamW's first moment (``0.1 *`` the clipped gradient),
within ``test_torch_train.F32_GRAD_RTOL`` (1e-5) of the leaf's largest
magnitude; parameters as ``test_torch_ranks._check_step`` holds them
(AdamW's ±lr steps on gradients near zero); Adafactor's parameters
within ``ADAFACTOR_ATOL`` (1e-6: lr 3e-4 times an update whose RMS is
clipped to 1, rounded in another order) and its moments (means of
squared gradients) within twice ``F32_GRAD_RTOL`` of each leaf's largest
value.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.dist.sharding import AbstractMesh, CommLedger, ShardingCtx, StatePlacement
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.train import TrainConfig, checkpoint, init_train_state, make_train_step
from repro_torch.train.step import value_and_grad
from test_torch_gpu import deterministic  # noqa: F401  (fixture)
from test_torch_gpu import placed_rank_cases, run_ranks
from test_torch_ranks import _check_step
from test_torch_train import F32_GRAD_RTOL

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = [2, 2]
TCFG = dict(total_steps=4, warmup=1)
RTOL = 1e-5
ADAFACTOR_ATOL = 1e-6
#: name -> (arch, config overrides, TrainConfig overrides, reference runs it)
CASES = {
    "granite": ("granite-3-8b", {}, {}, True),
    "moonshot": ("moonshot-v1-16b-a3b", {}, {}, True),
    "granite-v255": ("granite-3-8b", {"vocab": 255}, {}, False),
    "granite-adafactor": ("granite-3-8b", {}, {"optimizer": "adafactor"}, False),
}
RESTORE_MESHES = ([1, 1], [4, 1], [1, 4])

REF_SCRIPT = r'''
import dataclasses, json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.dist.sharding import ShardingCtx
from repro.launch import steps
from repro.models import transformer as rt
from repro.train import TrainConfig, init_train_state, make_train_step

work, job = sys.argv[1], json.loads(sys.argv[2])
mesh = jax.make_mesh(tuple(job["mesh"]), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
ctx = ShardingCtx(mesh=mesh, profile="tp_fsdp")
tcfg = TrainConfig(**job["tcfg"])
leaves = jax.tree_util.tree_leaves
out = {}
for name, arch in job["archs"].items():
    spec = configs.get(arch, reduced=True)
    cfg = dataclasses.replace(spec.config, dtype="float32")
    cell = next(c for c in spec.shapes if c.name == "train_4k")
    data = np.load(f"{work}/{name}.npz")
    tmpl = jax.eval_shape(lambda k: init_train_state(k, lambda r: rt.init(r, cfg), tcfg),
                          jax.random.key(0))
    state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tmpl), [
        jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves(tmpl)))])
    batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
    st_sh = steps.fit_tree(tmpl, steps.state_shardings(tmpl, "lm", ctx), mesh)
    b_sh = steps.fit_tree(batch, steps.input_shardings(spec, cell, ctx), mesh)
    shapes = [list(s.shard_shape(t.shape)) for s, t in zip(leaves(st_sh), leaves(tmpl))]
    rec = {"shard_shapes": shapes,
           "device_bytes": int(sum(np.prod(s) * t.dtype.itemsize
                                   for s, t in zip(shapes, leaves(tmpl))))}
    loss = lambda p, b: rt.loss_fn(p, b, cfg, ctx)
    try:
        l, g = jax.jit(jax.value_and_grad(loss), in_shardings=(st_sh["params"], b_sh))(
            state["params"], batch)
        rec["loss"], rec["grads"] = float(l), [np.asarray(x) for x in leaves(g)]
    except Exception as e:
        rec["grad_error"] = f"{type(e).__name__}: {e}"[:500]
        rec["loss"] = float(jax.jit(loss, in_shardings=(st_sh["params"], b_sh))(
            state["params"], batch))
    if "grads" in rec:
        new, m = jax.jit(make_train_step(loss, tcfg), in_shardings=(st_sh, b_sh))(state, batch)
        rec["state"] = [np.asarray(x) for x in leaves(new)]
        rec["metrics"] = {k: float(v) for k, v in m.items()}
    out[name] = rec
with open(f"{work}/ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("REF OK")
'''


def _spec(name: str):
    arch, over, _, _ = CASES[name]
    spec = tconfigs.get(arch, reduced=True)
    return dataclasses.replace(spec, config=dataclasses.replace(spec.config, dtype="float32",
                                                                **over))


def _tcfg(name: str) -> TrainConfig:
    return TrainConfig(**TCFG, **CASES[name][2])


def _inputs(name: str):
    """The case's seeded state (the port's ``init_train_state``) and global
    batch of the reduced ``train_4k`` cell (4 x 64 tokens)."""
    spec = _spec(name)
    cell = next(c for c in spec.shapes if c.kind == "train")
    init = lambda g: tt.init(g, spec.config)  # noqa: E731
    state = init_train_state(torch.Generator().manual_seed(5), init, _tcfg(name))
    batch = tsteps.make_inputs(spec, cell, np.random.default_rng(5), device="cpu")
    return state, batch


def _one_rank(name: str, microbatches: int = 1):
    """The port's one-rank step (and its loss and gradients) on the case."""
    spec = _spec(name)
    cell = next(c for c in spec.shapes if c.kind == "train")
    tcfg = dataclasses.replace(_tcfg(name), microbatches=microbatches)
    state, batch = _inputs(name)
    fn = tsteps.build_step(spec, cell, None, tcfg).fn
    torch.use_deterministic_algorithms(True)
    try:
        new, m = fn(state, batch)
        rows = batch["tokens"].shape[0] // microbatches
        halves = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                  for i in range(microbatches)]
        parts = [value_and_grad(lambda p, b: tt.loss_fn(p, b, spec.config), state["params"], h)
                 for h in halves]
    finally:
        torch.use_deterministic_algorithms(False)
    loss = sum(float(l) for l, _ in parts) / len(parts)
    grads = [sum(g) / len(parts) for g in zip(*(tree.leaves(g) for _, g in parts))]
    return new, {k: float(v) for k, v in m.items()}, loss, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4 ranks and the reference's subprocess side by side, and
    the one-rank steps here.  Returns ``(ref, got_by_rank, one)``."""
    work = tmp_path_factory.mktemp("tp_fsdp")
    cases, archs = [], {}
    for name in CASES:
        state, batch = _inputs(name)
        torch.save({"state": state, "batch": batch}, work / f"{name}.pt")
        arch, over, tc, ref = CASES[name]
        cases.append(dict(name=name, kind="step", inputs=f"{name}.pt", mesh=MESH, arch=arch,
                          config=dict(over, dtype="float32"), tcfg=dict(TCFG, **tc)))
        if ref:
            archs[name] = arch
            np.savez(work / f"{name}.npz", tokens=batch["tokens"].numpy(),
                     labels=batch["labels"].numpy(),
                     **{f"leaf_{i}": t.numpy() for i, t in enumerate(tree.leaves(state))})
    for name in ("granite", "moonshot"):
        cases.append(dict(name=f"roundtrip-{name}", kind="roundtrip", inputs=f"{name}.pt",
                          mesh=MESH, arch=CASES[name][0], config={"dtype": "float32"},
                          tcfg=TCFG))
    cases.append(dict(name="ckpt", kind="ckpt", inputs="granite.pt", mesh=MESH,
                      arch="granite-3-8b", config={"dtype": "float32"}, tcfg=TCFG,
                      restore_meshes=[list(m) for m in RESTORE_MESHES]))
    (work / "placed_cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    job = json.dumps({"mesh": MESH, "tcfg": TCFG, "archs": archs})
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work), job], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = []

    def spawn():
        try:
            run_ranks(placed_rank_cases, 4, work, str(work), "cpu", timeout=600)
        except BaseException as e:  # raised below
            err.append(e)

    th = threading.Thread(target=spawn)
    th.start()
    try:
        one = {"granite": _one_rank("granite"), "moonshot": _one_rank("moonshot", 2),
               "granite-v255": _one_rank("granite-v255"),
               "granite-adafactor": _one_rank("granite-adafactor")}
    finally:
        th.join()
        out_s, err_s = ref.communicate(timeout=600)
    if err:
        raise err[0]
    assert ref.returncode == 0 and "REF OK" in out_s, err_s[-4000:]
    with open(work / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = [torch.load(work / f"placed_out{r}.pt", weights_only=False) for r in range(4)]
    return want, got, one, work


def _close(got, want, what):
    """Each leaf within ``F32_GRAD_RTOL`` of the wanted leaf's largest
    magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w.numpy() if torch.is_tensor(w) else w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, err_msg=f"{what} leaf {i}",
                                   atol=max(F32_GRAD_RTOL * np.abs(w).max(), 1e-9))


def _same_on_ranks(got, name):
    """Every rank holds the same gathered state and metrics."""
    first = got[0][name]
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g[name]["state"]),
                                                     tree.leaves(first["state"])))
        assert g[name]["metrics"] == first["metrics"]
    return first


def test_placed_shard_shapes_and_bytes_equal_reference(runs):
    """Reduced granite and moonshot on (2, 2): each rank's blocks of every
    state leaf have the reference's ``fit_tree(state_shardings)`` shard
    shape, and a rank's state bytes equal the reference's per device."""
    want, got, _, _ = runs
    for name in ("granite", "moonshot"):
        for g in got:
            assert g[name]["shapes"] == want[name]["shard_shapes"], name
            assert g[name]["local_bytes"] == want[name]["device_bytes"], name
        state, _ = _inputs(name)
        assert any(s != list(t.shape) for s, t in zip(want[name]["shard_shapes"],
                                                      tree.leaves(state)))


def test_placed_granite_step_matches_reference_mesh_step(runs):
    """One AdamW step of the reduced granite on (2, 2) (its one KV head
    gathered whole on both ``tp`` ranks) == the reference's jitted step
    on the same mesh: loss, ``grad_norm``, the gradient of the placed loss
    and the first moment leaf by leaf, the gathered parameters."""
    want, got, _, _ = runs
    mine = _same_on_ranks(got, "granite")
    ref = want["granite"]
    assert mine["loss"] == pytest.approx(ref["loss"], rel=RTOL)
    _close([g.numpy() for g in tree.leaves(mine["grads"])], ref["grads"], "grad")
    state, _ = _inputs("granite")
    ref_state = tree.unflatten(state, [torch.from_numpy(x) for x in ref["state"]])
    _check_step(mine["state"], mine["metrics"], ref_state, ref["metrics"], loss=True,
                grad_rtol=F32_GRAD_RTOL, off_share=1e-3, method="none")


def test_placed_granite_step_matches_one_rank(runs):
    """The same placed step == the port's one-rank step on the whole batch
    (loss, ``grad_norm``, gradients, first moment, parameters)."""
    _, got, one, _ = runs
    mine = _same_on_ranks(got, "granite")
    new, m, loss, grads = one["granite"]
    assert mine["loss"] == pytest.approx(loss, rel=RTOL)
    _close([g.numpy() for g in tree.leaves(mine["grads"])], grads, "grad")
    _check_step(mine["state"], mine["metrics"], new, m, loss=True, grad_rtol=F32_GRAD_RTOL,
                off_share=1e-3, method="none")


def test_placed_moonshot_step_matches_reference_and_one_rank(runs):
    """The reduced moonshot on (2, 2), experts split over ``ep`` and
    gathered over ``fsdp``: the loss, the gradient and the step == the
    reference's jitted ones on the same mesh (each ``dp`` shard routes its
    128 tokens at its own capacity; on this ``AxisType.Auto`` mesh the
    reference's MoE has a gradient, which raises under its
    ``single_device_ctx``: ROADMAP queue 3), and == the port's one-rank
    step in 2 microbatches of one shard each (the same capacity)."""
    want, got, one, _ = runs
    mine = _same_on_ranks(got, "moonshot")
    ref = want["moonshot"]
    assert mine["loss"] == pytest.approx(ref["loss"], rel=RTOL)
    _close([g.numpy() for g in tree.leaves(mine["grads"])], ref["grads"], "grad")
    state, _ = _inputs("moonshot")
    ref_state = tree.unflatten(state, [torch.from_numpy(x) for x in ref["state"]])
    _check_step(mine["state"], mine["metrics"], ref_state, ref["metrics"], loss=True,
                grad_rtol=F32_GRAD_RTOL, off_share=1e-3, method="none")
    new, m, loss, grads = one["moonshot"]
    assert mine["loss"] == pytest.approx(loss, rel=RTOL)
    _close([g.numpy() for g in tree.leaves(mine["grads"])], grads, "grad")
    _check_step(mine["state"], mine["metrics"], new, m, loss=False, grad_rtol=F32_GRAD_RTOL,
                off_share=1e-3, method="none")


def test_placed_fallback_vocab_matches_one_rank(runs):
    """Granite with 255 tokens: ``embed`` and ``head`` stay whole over
    ``tp`` (255 is odd) and split over ``fsdp`` only; the step == the
    one-rank step."""
    _, got, one, _ = runs
    mine = _same_on_ranks(got, "granite-v255")
    new, m, loss, grads = one["granite-v255"]
    assert mine["loss"] == pytest.approx(loss, rel=RTOL)
    _close([g.numpy() for g in tree.leaves(mine["grads"])], grads, "grad")
    _check_step(mine["state"], mine["metrics"], new, m, loss=True, grad_rtol=F32_GRAD_RTOL,
                off_share=1e-3, method="none")
    spec = _spec("granite-v255")
    ctx = ShardingCtx(mesh=AbstractMesh((2, 2), ("data", "model")), profile="tp_fsdp")
    plan = tt.placement(spec.config, ctx)
    assert plan["embed"].block == (255, 32) and plan["head"].block == (32, 255)


def test_placed_adafactor_matches_one_rank(runs):
    """Adafactor on the placed granite: the split leaves' factored moments
    (whole on every rank, as the reference places them) and the new
    parameters == the one-rank step's."""
    _, got, one, _ = runs
    mine = _same_on_ranks(got, "granite-adafactor")
    new, m, _, _ = one["granite-adafactor"]
    assert mine["metrics"]["grad_norm"] == pytest.approx(m["grad_norm"], rel=RTOL)
    for p, a, b in zip(*tree.flatten_with_paths(mine["state"]["opt"]["v"]),
                       tree.leaves(new["opt"]["v"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, err_msg=p,
                                   atol=2 * F32_GRAD_RTOL * float(b.abs().max()))
    for p, a, b in zip(*tree.flatten_with_paths(mine["state"]["params"]),
                       tree.leaves(new["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ADAFACTOR_ATOL, err_msg=p)


@pytest.mark.parametrize("name", ("granite", "moonshot"))
def test_shard_and_gather_state_round_trip(runs, deterministic, name):  # noqa: F811
    """``shard_state`` then ``gather_state`` on (2, 2) gives the state
    back bit for bit on every rank; numpy leaves place as tensors do; no
    split leaf's block is the whole leaf."""
    _, got, _, _ = runs
    for g in got:
        r = g[f"roundtrip-{name}"]
        assert r["same"] and r["same_np"] and r["no_whole"] and r["n_split"] > 0


@pytest.mark.parametrize("mesh", RESTORE_MESHES, ids=lambda m: "x".join(map(str, m)))
def test_placed_checkpoint_restores_on_other_layouts(runs, deterministic, mesh):  # noqa: F811
    """A placed state checkpointed on (2, 2) (gathered whole on the host,
    rank 0 writes) restores onto ``mesh`` block by block, bit-equal to the
    saved state's blocks there; on (1, 1) the plain ``restore`` gives the
    whole state back bit for bit."""
    _, got, _, work = runs
    key = "x".join(map(str, mesh))
    assert all(g["ckpt"]["same"][key] for g in got if g["ckpt"]["same"][key] is not None)
    assert got[0]["ckpt"]["same"][key]
    if mesh == [1, 1]:
        state, _ = _inputs("granite")
        back, step = checkpoint.restore(work / "ckpt", state)
        assert step == 1 and all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                                    tree.leaves(state)))


def test_placed_context_refuses_whole_replicas():
    """Under a context with ``tp`` or ``fsdp`` over more than one rank no
    rank holds a whole placed leaf: ``init`` keeps blocks; the step needs
    the placement, and a whole state, or whole parameters in ``forward``,
    raise; on a mesh of one rank nothing is placed."""
    spec = _spec("granite")
    cell = next(c for c in spec.shapes if c.kind == "train")
    ctx = ShardingCtx(mesh=AbstractMesh((2, 2), ("data", "model"), ledger=CommLedger()),
                      profile="tp_fsdp")
    whole = tt.init(torch.Generator().manual_seed(0), spec.config)
    blocks = tt.init(torch.Generator().manual_seed(0), spec.config, ctx)
    plan = tt.placement(spec.config, ctx)
    for w, b, pl in zip(tree.leaves(whole), tree.leaves(blocks), tree.leaves(plan)):
        split = any(a for _, a in pl.dims)
        assert (tuple(b.shape) != tuple(w.shape)) == split and tuple(b.shape) == pl.block
    assert sum(any(a for _, a in pl.dims) for pl in tree.leaves(plan)) >= 9
    with pytest.raises(ValueError, match="placement"):
        make_train_step(lambda p, b: 0, TrainConfig(), ctx=ctx, family="lm")
    bundle = tsteps.build_step(spec, cell, ctx, TrainConfig())
    state = init_train_state(torch.Generator().manual_seed(0), lambda g: whole, TrainConfig())
    batch = tsteps.make_inputs(spec, cell, np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError, match="block"):
        bundle.fn(state, batch)
    with pytest.raises(ValueError, match="block"):
        tt.forward(whole, batch["tokens"], spec.config, ctx)
    one = ShardingCtx(mesh=AbstractMesh((1, 1), ("data", "model")), profile="tp_fsdp")
    assert tt.placement(spec.config, one) is None
    placement = StatePlacement(ctx, "lm", init_train_state(None, lambda _: tt.param_template(
        spec.config), TrainConfig()))
    assert len(placement.shardings()) == len(tree.leaves(state))
