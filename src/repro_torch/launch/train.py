"""Train launcher (counterpart of ``repro.launch.train``)::

    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced --steps 3 --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --steps 3 --backend gloo

Wires a registered architecture's ``train`` or ``graph_train`` cell
(``launch.steps``; ``--arch dimenet`` trains a graph cell), its
seeded batches and the fault-tolerant loop (``train.loop``): the card
unless ``--device`` names another.  Batch ``step`` is
``make_inputs(..., rng=np.random.default_rng(step))``, as the reference
draws it, so a restart from ``--ckpt-dir`` replays the same data.  The
weights are drawn from a generator seeded with 0 on that device.  The
full configs need more than one card for most archs; ``--reduced``
takes the CPU-size variant.

Under ``torchrun`` with more than one rank it builds the reference's
mesh, ``d = isqrt(n)``, ``(n // d, d)`` over ``("data", "model")``, with
the arch's sharding profile (``dryrun.profile_for``), and trains with the
step over ranks (``train.make_train_step`` under that context): every
rank draws the same global batch and takes its slice.  An LM's
parameters are placed over ``fsdp``/``tp``/``ep`` (``data`` and
``model``): each rank draws every leaf and keeps its block
(``transformer.init`` under the context, the blocks
``dist.sharding.shard_state`` cuts from the same draws).  The process
group's backend is the one ``--backend`` names (none is picked); with
``nccl`` each rank takes the card ``LOCAL_RANK``, with ``gloo`` every rank
the one ``--device`` names.  Checkpoints of a placed state are gathered
whole on the host and written by rank 0; a restart restores each rank's
blocks from them, on this mesh or any other (``train.checkpoint``).

``--print-xla-flags`` prints nothing on stdout: the port sets no XLA or
NCCL flags (the reference's ``OVERLAP_XLA_FLAGS`` are TPU flags), and a
line on stderr says so.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

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
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend over several ranks (required there)")
    ap.add_argument("--print-xla-flags", action="store_true")
    args = ap.parse_args(argv)

    if args.print_xla_flags:
        print("the port sets no XLA or NCCL flags (the reference's OVERLAP_XLA_FLAGS are TPU "
              "flags)", file=sys.stderr)
        return None

    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state, loop

    spec = configs.get(args.arch, reduced=args.reduced)
    cells = [c for c in spec.shapes if c.kind in ("train", "graph_train")]
    cell = next((c for c in cells if c.name == args.cell), cells[0])
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       grad_compression=args.grad_compression,
                       microbatches=args.microbatches)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    ctx, rank = None, 0
    if world > 1:
        ctx, dev = _rank_context(spec, args, world)
        rank = torch.distributed.get_rank()
    else:
        dev = resolve_device(args.device)
    bundle = steps.build_step(spec, cell, ctx, tcfg)

    def batch_at(step):
        return steps.make_inputs(spec, cell, rng=np.random.default_rng(step), device=dev)

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    placement = None
    if getattr(bundle.init_fn, "whole", None) is not None:  # an LM placed over the mesh
        from repro_torch.dist.sharding import StatePlacement

        whole = init_train_state(None, lambda _: bundle.init_fn.whole, tcfg)
        placement = StatePlacement(ctx, spec.family, whole)
    elif world > 1 and args.ckpt_dir is not None:
        raise SystemExit(f"--ckpt-dir over several ranks is for a placed LM; {args.arch} would "
                         "have each rank write its own files")
    try:
        state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn,
                                 tcfg)
        state, report = loop.run(
            bundle.fn, state, batch_at,
            loop.LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50),
            log=log, placement=placement)
        last = f", final loss {report.losses[-1]:.4f}" if report.losses else ""
        log(f"[train] done: {report.steps_run} steps{last}")
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()
    return state, report


def _rank_context(spec, args, world: int):
    """The process group (``--backend``), this rank's device and the
    reference's ``(n // d, d)`` ``("data", "model")`` mesh's context."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    from repro_torch.dist import ShardingCtx
    from repro_torch.launch.dryrun import profile_for

    if args.backend is None:
        raise SystemExit(f"{world} ranks: name the process-group backend with --backend")
    if args.backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(args.backend)
    d = math.isqrt(world)
    mesh = init_device_mesh(dev.type, (world // d, d), mesh_dim_names=("data", "model"))
    return ShardingCtx(mesh=mesh, profile=profile_for(spec)), dev


if __name__ == "__main__":
    main()
