"""Fault-tolerant training loop: checkpoint/restart, preemption hooks,
straggler detection (counterpart of ``repro.train.loop``).

The loop is host-side and simple: ``step_fn`` does all device work; the
loop adds

  * periodic async checkpoints and restore-on-start (a restart replays
    the data order exactly because the batcher is a pure function of the
    step);
  * a preemption flag (SIGTERM on a fleet; injectable in tests) that
    forces a final synchronous checkpoint and a clean exit;
  * straggler detection: an EWMA of each step's wall time; a step slower
    than ``straggler_factor`` x the EWMA is logged and counted.

Each step's loss is read back with ``float()``, which waits for the
device, so a step's wall time covers its device work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.obs.timing import stopwatch

from . import checkpoint


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0


@dataclass
class LoopReport:
    steps_run: int
    final_step: int
    losses: list = field(default_factory=list)
    straggler_steps: list = field(default_factory=list)
    restored_from: Optional[int] = None
    preempted: bool = False


def run(
    step_fn,
    state,
    batch_at: Callable[[int], dict],
    cfg: LoopConfig,
    preempt_flag: Optional[Callable[[], bool]] = None,
    log=print,
    placement=None,
) -> tuple:
    """Run the loop; returns ``(state, LoopReport)``.  A checkpoint under
    ``cfg.ckpt_dir`` is restored into ``state``'s structure and devices
    before the first step.  A placed state (each rank its blocks) passes
    its ``placement`` (``dist.sharding.StatePlacement``): checkpoints are
    then gathered whole and restored block by block (``checkpoint``)."""
    report = LoopReport(steps_run=0, final_step=0)
    start_step = 0

    if cfg.ckpt_dir is not None:
        latest = checkpoint.latest_step(cfg.ckpt_dir)
        if latest is not None:
            state, start_step = checkpoint.restore(cfg.ckpt_dir, state, placement=placement)
            report.restored_from = start_step
            log(f"[loop] restored checkpoint at step {start_step}")

    ewma = None
    pending = None
    for step in range(start_step, cfg.total_steps):
        sw = stopwatch()
        batch = batch_at(step)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = sw.elapsed

        report.steps_run += 1
        report.losses.append(loss)
        if ewma is None:
            ewma = dt
        else:
            if dt > cfg.straggler_factor * ewma:
                report.straggler_steps.append((step, dt, ewma))
                log(f"[loop] straggler step {step}: {dt:.3f}s vs EWMA {ewma:.3f}s")
            ewma = 0.9 * ewma + 0.1 * dt

        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            log(f"[loop] step {step + 1} loss {loss:.4f} ({dt * 1e3:.1f} ms)")

        next_step = step + 1
        if cfg.ckpt_dir and cfg.ckpt_every and next_step % cfg.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = checkpoint.save(cfg.ckpt_dir, state, next_step, placement=placement)

        if preempt_flag is not None and preempt_flag():
            log(f"[loop] preemption at step {next_step}: checkpoint + exit")
            if pending is not None:
                pending.join()
            if cfg.ckpt_dir:
                checkpoint.save(cfg.ckpt_dir, state, next_step, async_write=False,
                                placement=placement)
            report.preempted = True
            report.final_step = next_step
            return state, report

    if pending is not None:
        pending.join()
    if cfg.ckpt_dir:
        checkpoint.save(cfg.ckpt_dir, state, cfg.total_steps, async_write=False,
                        placement=placement)
    report.final_step = cfg.total_steps
    return state, report
