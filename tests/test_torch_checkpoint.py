"""The port's checkpointing (``train.checkpoint``), fault-tolerant loop
(``train.loop``) and train launcher (``launch.train``), against the JAX
reference on the CPU where the two can meet: a checkpoint written by
either package restores into the other (f32 and int32 leaves; the
manifests are equal, crc32 included), and both loops, driven by the same
host-only fake step, give the same ``LoopReport`` (losses, checkpoints,
preemption, restore on start, an injected straggler).  Restored states
and restarted runs are compared bit for bit: no tolerance.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as rckpt
from repro.train import loop as rloop
from repro_torch import tree
from repro_torch.launch import train as tlaunch
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g),
                       "blocks": [{"h": torch.randn(2, 2, generator=g).to(torch.bfloat16)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_checkpoint_round_trip(tmp_path, async_write):
    state = _state()
    handle = tckpt.save(tmp_path, state, step=7, async_write=async_write)
    if async_write:
        handle.join(timeout=30)
        assert not handle.is_alive()
    else:
        assert handle is None
    assert tckpt.latest_step(tmp_path) == 7
    restored, step = tckpt.restore(tmp_path, tree.tree_map(torch.zeros_like, state))
    assert step == 7 and _equal(restored, state)
    assert isinstance(restored["params"]["blocks"], list)
    man = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert [(e["path"], e["file"], e["dtype"]) for e in man["leaves"]] == [
        ("['opt']/['step']", "leaf_0.npy", "int32"),
        ("['params']/['b']", "leaf_1.npy", "float32"),
        ("['params']/['blocks']/[0]/['h']", "leaf_2.npy", "bfloat16"),
        ("['params']/['w']", "leaf_3.npy", "float32"),
        ("['step']", "leaf_4.npy", "int32"),
    ]
    assert man["step"] == 7 and man["leaves"][3]["shape"] == [3, 4]


def test_checkpoint_detects_corruption_and_shape(tmp_path):
    state = _state()
    tckpt.save(tmp_path, state, step=1, async_write=False)
    leaf = tmp_path / "step_1" / "leaf_3.npy"
    arr = np.load(leaf)
    arr[0, 0] += 1.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(tmp_path, state)
    tckpt.save(tmp_path, state, step=2, async_write=False)
    bad = {**state, "params": {**state["params"], "w": torch.zeros(4, 3)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "empty", state)


def test_stale_tmp_step_does_not_move_latest(tmp_path):
    """A write that died before its rename leaves ``.tmp_step_N``: LATEST
    still names the last complete step, which restores; the next save of
    that step writes over the stale directory."""
    state = _state()
    tckpt.save(tmp_path, state, step=3, async_write=False)
    stale = tmp_path / ".tmp_step_5"
    stale.mkdir()
    (stale / "leaf_0.npy").write_bytes(b"partial")
    assert tckpt.latest_step(tmp_path) == 3
    restored, step = tckpt.restore(tmp_path, state)
    assert step == 3 and _equal(restored, state)
    newer = _state(1)
    tckpt.save(tmp_path, newer, step=5, async_write=False)
    assert tckpt.latest_step(tmp_path) == 5 and not stale.exists()
    assert _equal(tckpt.restore(tmp_path, state)[0], newer)


def _f32_pair(seed=0):
    rng = np.random.default_rng(seed)
    np_state = {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                           "layers": [{"b": rng.normal(size=5).astype(np.float32)}]},
                "opt": {"m": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                              "layers": [{"b": np.zeros(5, np.float32)}]},
                        "step": np.int32(4)},
                "step": np.int32(4)}
    return (jax.tree.map(jnp.asarray, np_state),
            tree.tree_map(lambda a: torch.from_numpy(np.array(a)), np_state))


def test_checkpoints_restore_across_packages(tmp_path):
    """An f32/int32 train state saved by the reference restores into the
    port's template and the other way round; both write the same
    manifest for the same state (paths, shapes, dtypes, crc32)."""
    rstate, tstate = _f32_pair()
    rckpt.save(tmp_path / "ref", rstate, step=4, async_write=False)
    tckpt.save(tmp_path / "port", tstate, step=4, async_write=False)
    assert ((tmp_path / "ref" / "step_4" / "manifest.json").read_text()
            == (tmp_path / "port" / "step_4" / "manifest.json").read_text())
    got, step = tckpt.restore(tmp_path / "ref", tree.tree_map(torch.zeros_like, tstate))
    assert step == 4 and _equal(got, tstate)
    want, step = rckpt.restore(tmp_path / "port", jax.tree.map(jnp.zeros_like, rstate))
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(want), tree.leaves(tstate)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _quad_loss(params, batch):
    return torch.mean((params["w"] - batch["t"]) ** 2) + torch.sum(params["v"] ** 2)


def _batch_at(step):
    return {"t": torch.full((4,), float(step % 3))}


def _fresh():
    return init_train_state(torch.Generator().manual_seed(0),
                            lambda g: {"w": torch.zeros(4), "v": torch.randn(2, 3, generator=g)},
                            TrainConfig(lr=0.05, schedule="constant", grad_compression="int8"))


def test_restart_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Stop at step 6 (checkpoints at 3 and 6), restore in a fresh state,
    run on to 12: the state (AdamW moments, compression errors, step)
    equals a run of 12 straight steps bit for bit on the CPU."""
    tcfg = TrainConfig(lr=0.05, schedule="constant", grad_compression="int8")
    step_fn = make_train_step(_quad_loss, tcfg)
    ref = _fresh()
    for s in range(12):
        ref, _ = step_fn(ref, _batch_at(s))
    ckpt = str(tmp_path / "ckpt")
    quiet = dict(log=lambda *_: None)
    st, rep = tloop.run(step_fn, _fresh(), _batch_at,
                        tloop.LoopConfig(total_steps=6, ckpt_dir=ckpt, ckpt_every=3, log_every=0),
                        **quiet)
    assert rep.final_step == 6 and tckpt.latest_step(ckpt) == 6
    st2, rep2 = tloop.run(step_fn, _fresh(), _batch_at,
                          tloop.LoopConfig(total_steps=12, ckpt_dir=ckpt, ckpt_every=100,
                                           log_every=0), **quiet)
    assert rep2.restored_from == 6 and rep2.steps_run == 6
    assert _equal(st2, ref)


class _FakeStep:
    """A host-only step: the state's ``w`` plus the batch's ``x``, the loss
    their sum; step ``slow_at`` sleeps ``slow`` seconds (a straggler), the
    others 20 ms (well above the host's noise).  ``wrap`` builds the
    package's arrays."""

    def __init__(self, wrap, slow_at=None, slow=0.3):
        self.wrap, self.slow_at, self.slow = wrap, slow_at, slow

    def __call__(self, state, batch):
        x = float(batch["x"])
        time.sleep(self.slow if x == self.slow_at else 0.02)
        w = np.asarray(state["w"]) + x
        return {"w": self.wrap(w.astype(np.float32))}, {"loss": float(w.sum())}


def _run_both(tmp_path, cfg_kw, preempt_after=None, slow_at=None, runs=1):
    reports = {}
    for name, loop_mod, wrap in (("ref", rloop, jnp.asarray), ("port", tloop, torch.from_numpy)):
        ckpt = str(tmp_path / name) if cfg_kw.get("ckpt") else None
        cfg = loop_mod.LoopConfig(ckpt_dir=ckpt, **{k: v for k, v in cfg_kw.items()
                                                    if k != "ckpt"})
        out = []
        for _ in range(runs):
            calls = {"n": 0}

            def flag():
                calls["n"] += 1
                return preempt_after is not None and calls["n"] >= preempt_after

            lines = []
            state, rep = loop_mod.run(_FakeStep(wrap, slow_at), {"w": wrap(np.zeros(2, np.float32))},
                                      lambda s: {"x": np.float32(s)}, cfg, preempt_flag=flag,
                                      log=lines.append)
            out.append((np.asarray(state["w"]), rep, lines,
                        None if ckpt is None else loop_mod.checkpoint.latest_step(ckpt)))
        reports[name] = out
    return reports


@pytest.mark.parametrize("case", ["plain", "checkpoints", "preempt", "restore_on_start",
                                  "straggler"])
def test_loop_report_matches_reference(tmp_path, case):
    kw = {"total_steps": 8, "log_every": 2, "ckpt_every": 3}
    args = {}
    if case != "plain":
        kw["ckpt"] = True
    if case == "preempt":
        args["preempt_after"] = 5
    if case == "restore_on_start":
        args["runs"] = 2
        kw["total_steps"] = 10
    if case == "straggler":
        args["slow_at"] = 6
    both = _run_both(tmp_path, kw, **args)
    for (rw, rr, rl, rlatest), (tw, tr, tl, tlatest) in zip(both["ref"], both["port"]):
        np.testing.assert_array_equal(tw, rw)
        for field in ("steps_run", "final_step", "losses", "restored_from", "preempted"):
            assert getattr(tr, field) == getattr(rr, field), field
        assert [s[0] for s in tr.straggler_steps] == [s[0] for s in rr.straggler_steps]
        assert tlatest == rlatest
        assert len(tl) == len(rl) and [l.split(":")[0][:24] for l in tl] == [
            l.split(":")[0][:24] for l in rl]
    port = both["port"][-1][1]
    if case == "preempt":
        assert port.preempted and port.final_step == 5 and both["port"][-1][3] == 5
    if case == "restore_on_start":
        assert port.restored_from == 10 and port.steps_run == 0
        assert both["port"][0][1].final_step == 10
    if case == "straggler":
        assert [s[0] for s in port.straggler_steps] == [6]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "din"])
def test_launch_train_runs_reduced_on_the_cpu(tmp_path, capsys, arch):
    """``python -m repro_torch.launch.train --arch A --reduced --steps 3
    --device cpu``, in-process: three finite losses on the CPU; with
    ``--ckpt-dir`` a second call to 5 steps restores step 3 and runs 2."""
    ckpt = tmp_path / "ckpt"
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--ckpt-dir", str(ckpt)]
    state, rep = tlaunch.main(argv + ["--steps", "3"])
    assert rep.steps_run == 3 and all(np.isfinite(rep.losses))
    assert tree.leaves(state)[0].device.type == "cpu"
    assert "[train] done: 3 steps, final loss" in capsys.readouterr().out
    _, rep2 = tlaunch.main(argv + ["--steps", "5"])
    assert rep2.restored_from == 3 and rep2.steps_run == 2 and rep2.final_step == 5
