#!/usr/bin/env python3
"""Where one training step of ``chip_smoke.py`` phase 9a or 9e spends the
card.

By default builds qwen2-0.5b's ``train_4k`` cell at published widths as
phase 9a does (f32 master weights, bf16 compute, remat, ``xent_chunk``
512; 8 sequences of 4,096 tokens from ``TokenBatcher`` in 2
microbatches, AdamW).  ``--arch dimenet --cell minibatch_lg`` builds a
DimeNet ``graph_train`` cell at published widths as phase 9e does (f32,
TF32 off, AdamW at ``chip_smoke.GNN_LR``, the cell's batch of seed 0).
Runs two steps to warm up, then one step under ``torch.profiler`` (CPU
and CUDA activity) and prints the step's wall time, the card's busy
share (the sum of its kernels' device time over the wall time) and that
device time by kind of kernel: matrix products, gathers and
scatter-adds, dtype copies and casts, softmax, the causal mask, other
elementwise passes, reductions.  Imports no JAX.  Run on a machine with
one CUDA card::

    python3 train_profile.py [--arch dimenet --cell minibatch_lg] [--out chiprun_out/p.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

#: kernel-name fragments by kind, tried in order (the first match wins)
KINDS = (
    ("matmul", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("gather/scatter", ("indexSelect", "indexFunc", "index_elementwise", "scatter", "gather")),
    ("copy/cast", ("copy",)),
    ("softmax", ("SoftMax",)),
    ("mask", ("masked_fill", "where")),
    ("memcpy", ("Memcpy", "Memset")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise",)),
)


def kind_of(name: str) -> str:
    for kind, parts in KINDS:
        if any(p in name for p in parts):
            return kind
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=["qwen2-0.5b", "dimenet"])
    ap.add_argument("--cell", default=None, help="the dimenet cell (default: minibatch_lg)")
    ap.add_argument("--out", type=Path, default=None, help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data import TokenBatcher, synth_corpus
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    spec = configs.get(args.arch)
    if args.arch == "dimenet":
        import numpy as np

        sys.path.insert(0, str(ROOT))
        from chip_smoke import GNN_LR

        torch.backends.cuda.matmul.allow_tf32 = False
        cell = next(c for c in spec.shapes if c.name == (args.cell or "minibatch_lg"))
        tcfg = TrainConfig(lr=GNN_LR, warmup=1, total_steps=6)
        batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
        label = f"dimenet {cell.name} at its widths, {batch['tri_kj'].shape[0]:,} edges"

        def batch_at(step):
            return batch
    else:
        cell = next(c for c in spec.shapes if c.kind == "train")
        tcfg = TrainConfig(total_steps=6, warmup=2, microbatches=2)
        corpus = synth_corpus(vocab_size=spec.config.vocab, n_docs=2000, mean_len=512, seed=0,
                              device=dev)
        batch_at = TokenBatcher(corpus, 8, cell.dims["seq_len"], seed=0).batch_at
        label = "qwen2-0.5b train_4k at its widths, 8 x 4,096 tokens in 2 microbatches"
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    for step in range(2):
        state, m = bundle.fn(state, batch_at(step))
        float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = bundle.fn(state, batch_at(2))
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        kernels[e.key] = {"count": e.count, "device_us": e.self_device_time_total}
    device_s = sum(k["device_us"] for k in kernels.values()) / 1e6
    by_kind = {}
    for name, k in kernels.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + k["device_us"] / 1e3
    print(f"[profile] {smi}; {label}: step 3 took {wall * 1e3:.1f} ms (host clock around a "
          f"sync), kernels {device_s * 1e3:.1f} ms of device time: busy share "
          f"{device_s / wall:.4f}")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {kind:12s} {ms:9.1f} ms  {ms / 1e3 / device_s:.4f}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_us"])[:15]
    for name, k in top:
        print(f"[profile]   {k['device_us'] / 1e3:9.1f} ms {k['count']:6d}x  {name[:100]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "case": label, "wall_s": wall,
                                        "device_s": device_s,
                                        "by_kind_ms": by_kind, "kernels": kernels,
                                        "loss": float(m["loss"])}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
