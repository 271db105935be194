"""Train launcher (counterpart of ``repro.launch.train``)::

    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced --steps 3 --device cpu

Wires a registered architecture's ``train`` or ``graph_train`` cell
(``launch.steps``; ``--arch dimenet`` trains a graph cell), its
seeded batches and the fault-tolerant loop (``train.loop``) on one
device: the card unless ``--device`` names another.  Batch ``step`` is
``make_inputs(..., rng=np.random.default_rng(step))``, as the reference
draws it, so a restart from ``--ckpt-dir`` replays the same data.  The
weights are drawn from a generator seeded with 0 on that device.  The
full configs need more than one card for most archs; ``--reduced``
takes the CPU-size variant.  The reference's ``--print-xla-flags`` waits
for the launch slice (ROADMAP queue 1, item 13.6).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", default=None,
                    help="shape cell (default: the first train or graph_train cell)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state, loop

    dev = resolve_device(args.device)
    spec = configs.get(args.arch, reduced=args.reduced)
    cells = [c for c in spec.shapes if c.kind in ("train", "graph_train")]
    cell = next((c for c in cells if c.name == args.cell), cells[0])
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       grad_compression=args.grad_compression,
                       microbatches=args.microbatches)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)

    def batch_at(step):
        return steps.make_inputs(spec, cell, rng=np.random.default_rng(step), device=dev)

    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    state, report = loop.run(
        bundle.fn, state, batch_at,
        loop.LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50))
    last = f", final loss {report.losses[-1]:.4f}" if report.losses else ""
    print(f"[train] done: {report.steps_run} steps{last}")
    return state, report


if __name__ == "__main__":
    main()
