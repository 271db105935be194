"""Per-cell dry run of the port (counterpart of ``repro.launch.dryrun``; a
new design)::

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --cell train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun

The reference compiles every (arch x cell x mesh) with XLA on 256 or 512
host devices and reads ``memory_analysis``, ``cost_analysis`` and the
collective bytes of the partitioned HLO (``hlo_analysis.py``).  Eager
PyTorch has no HLO, so ``hlo_analysis.py`` has no counterpart here.
Instead the dry run builds the cell's step as the port runs it
(``launch.steps.build_step`` under a
:class:`~repro_torch.dist.sharding.ShardingCtx` on an
:class:`~repro_torch.dist.sharding.AbstractMesh` of the production
mesh's axes, carrying a :class:`~repro_torch.dist.sharding.CommLedger`)
and calls it once under ``FakeTensorMode``: nothing is allocated and no
kernel runs, at the shapes of the mesh's first rank, whose collective
helpers return tensors of the right shape and count the bytes the rank
would move (the reference's ring accounting, ``dryrun.py:62-70``).  It
records per card:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  call (matrix products and attention; the backward and remat's
  recomputation included; elementwise work is not counted);
* ``memory``: the peak of live tensor bytes during the call, counted by
  :class:`PeakBytes` (a ``TorchDispatchMode`` of the port's own that
  follows each storage's lifetime: ``MemTracker`` is not used), beside
  the state's bytes by part from the rank's shard shapes (``params``,
  ``opt``, ``comp_err``: the blocks ``init_fn`` keeps), the gradients'
  and the batch's; ``activation_bytes`` is the rest of the peak;
* ``traffic``: the bytes each operator reads and writes (every operand
  and result once: the unfused eager traffic, an upper bound);
* ``collectives``: bytes and counts by kind from the ledger, counted by
  the same helpers the step calls (an LM's FSDP all-gathers of each
  layer's blocks and their reduce-scatters in the backward, the
  tensor-parallel all-reduces, the gradient all-reduces over ``dp``);
* ``model_flops`` and ``model_flops_ratio`` as the reference's
  (``dryrun.py:120-133``; the ratio over the flops of every card);
* a roofline on the H100 SXM data sheet (:data:`H100`).

What it sizes is what the port runs: an LM's parameters placed over
``fsdp``/``tp``/``ep`` as the reference places them (each rank its
blocks; ``launch.steps.build_step``), the recsys tables by row, DimeNet's
edges, the rest replicated.  A cell whose per-card bytes pass the card's
80 GB says so (``fits``); it does not fail.  An LM ``decode`` cell is
sized on the rank's parameter blocks and its cache block
(``transformer.init_cache(..., ctx=ctx, seq_shard=...)``: batch on
``dp``, sequence on ``seqm``/``sp`` where the rules name them), as the
reference sizes it (``dryrun.py:191-197``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the H100 SXM5 80GB data sheet at 700 W: dense tensor-core bf16 and f32
#: (CUDA cores) peaks, HBM3 bandwidth, NVLink 4 bandwidth one way
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 450e9, "hbm_bytes": 80e9, "power_w": 700}

LM_FLOP_FACTORS = {"train": 6, "prefill": 2, "decode": 2}

# gradient-accumulation depth per (arch, cell), the reference's
MICROBATCHES = {
    ("granite-3-8b", "train_4k"): 8,
    ("minitron-8b", "train_4k"): 8,
    ("moonshot-v1-16b-a3b", "train_4k"): 8,
    ("qwen3-moe-235b-a22b", "train_4k"): 16,
    ("qwen2-0.5b", "train_4k"): 4,
}


def profile_for(spec) -> str:
    """The sharding profile of an arch: its config's own, else ``flat_dp``
    for recsys and GNN and ``tp_fsdp`` for LMs."""
    explicit = getattr(spec.config, "sharding_profile", None)
    if explicit:
        return explicit
    return "flat_dp" if spec.family in ("recsys", "gnn") else "tp_fsdp"


def model_flops(spec, cell) -> float:
    """Useful-math FLOPs of the cell (6ND train / 2ND inference; the
    active parameters of an MoE)."""
    if spec.family == "lm":
        cfg = spec.config
        n = cfg.active_params_count if cfg.moe else cfg.params_count
        if cell.kind in ("train", "prefill"):
            toks = cell.dims["global_batch"] * cell.dims["seq_len"]
            return float(LM_FLOP_FACTORS[cell.kind]) * n * toks
        return 2.0 * n * cell.dims["global_batch"]  # one token a sequence
    return float("nan")  # gnn / recsys: the counted flops only


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class PeakBytes(TorchDispatchMode):
    """Live tensor bytes during a call: every storage an operator creates
    is counted until it is freed (a finalizer on the storage), plus the
    storages registered with :meth:`hold`; ``peak`` is the most at once.
    ``traffic`` sums, over operators that are not views, the bytes of
    every tensor operand and result."""

    def __init__(self):
        super().__init__()
        self.live, self.cur, self.peak, self.traffic = {}, 0, 0, 0

    def hold(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.cur += self.live[key]
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat_in = torch.utils._pytree.tree_leaves((args, kwargs))
        flat_out = torch.utils._pytree.tree_leaves(out)
        if not func.is_view:  # a view moves no byte
            self.traffic += sum(_nbytes(t) for t in flat_in + flat_out
                                if isinstance(t, torch.Tensor))
        for t in flat_out:
            if isinstance(t, torch.Tensor):
                self.hold(t)
        return out


def _abstract_ctx(spec, mesh_shape, axes, rules=None):
    from repro_torch.dist.sharding import AbstractMesh, CommLedger, ShardingCtx

    mesh = AbstractMesh(tuple(mesh_shape), tuple(axes), ledger=CommLedger())
    return ShardingCtx(mesh=mesh, profile=profile_for(spec), rules=dict(rules or {}))


def _peak_flops(spec) -> float:
    dtype = getattr(spec.config, "dtype", "float32")
    return H100["bf16_flops"] if dtype == "bfloat16" else H100["f32_flops"]


def run_cell(spec, cell, mesh_shape=(16, 16), axes=("data", "model"), *, tcfg=None,
             verbose: bool = True, rules=None) -> dict:
    """One (arch x cell x mesh) entry: the cell's step called once on fake
    tensors at rank 0's shapes (a ``train``/``graph_train`` cell's full
    optimizer step; the others' forward).  ``tcfg`` defaults to the
    reference's ``MICROBATCHES``; ``rules`` override the profile's logical
    axes (e.g. data parallelism alone: ``fsdp``/``tp``/``ep`` on no axis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.train import TrainConfig, init_train_state

    t0 = time.perf_counter()
    ctx = _abstract_ctx(spec, mesh_shape, axes, rules)
    ledger = ctx.mesh.ledger
    n_cards = ctx.mesh.size
    tcfg = tcfg or TrainConfig(microbatches=MICROBATCHES.get((spec.arch_id, cell.name), 1))
    bundle = steps.build_step(spec, cell, ctx, tcfg)
    shapes = steps.input_shapes(spec, cell)
    with FakeTensorMode(allow_non_fake_inputs=True):
        gen = torch.Generator().manual_seed(0)
        batch = {k: torch.zeros(sh, dtype=dt) for k, (sh, dt) in shapes.items()}
        if cell.kind in ("train", "graph_train"):
            state = init_train_state(gen, bundle.init_fn, tcfg)
            parts = {k: state[k] for k in ("params", "opt", "comp_err", "step") if k in state}
            call = (bundle.fn, (state, batch))
        else:
            from repro_torch.models import recsys

            if spec.family == "lm":
                params = transformer.init(gen, bundle.cfg, ctx)
            else:
                params = recsys.local_params(recsys.init(gen, bundle.cfg, ctx), ctx)
            parts = {"params": params}
            args = (params, batch)
            if cell.kind == "decode":
                cache = transformer.init_cache(bundle.cfg, cell.dims["global_batch"],
                                               cell.dims["seq_len"], device="cpu", ctx=ctx,
                                               seq_shard=bool(cell.dims.get("seq_shard")))
                parts["cache"] = cache
                args = (params, cache, batch, 0)
            call = (torch.no_grad()(bundle.fn), args)
        part_bytes = {k: sum(_nbytes(t) for t in tree.leaves(v)) for k, v in parts.items()}
        batch_bytes = sum(_nbytes(t) for t in batch.values())
        mem = PeakBytes()
        for t in tree.leaves(parts) + list(batch.values()):
            mem.hold(t)
        held = mem.cur
        with FlopCounterMode(display=False) as fc, mem:
            call[0](*call[1])
        flops = float(fc.get_total_flops())
    run_s = time.perf_counter() - t0
    grads = part_bytes["params"] if cell.kind in ("train", "graph_train") else 0
    argument = sum(part_bytes.values()) + batch_bytes
    memory = {
        "argument_bytes": argument,
        "peak_bytes": mem.peak,
        "temp_bytes": mem.peak - held,
        "params_bytes": part_bytes["params"],
        "opt_bytes": part_bytes.get("opt", 0) + part_bytes.get("comp_err", 0)
        + part_bytes.get("step", 0),
        "cache_bytes": part_bytes.get("cache", 0),
        "grads_bytes": grads,
        "batch_bytes": batch_bytes,
        "activation_bytes": max(mem.peak - argument - grads, 0),
    }
    entry = {
        "arch": spec.arch_id,
        "cell": cell.name,
        "kind": cell.kind,
        "mesh": "x".join(str(s) for s in mesh_shape),
        "n_chips": n_cards,
        "profile": profile_for(spec),
        "microbatches": tcfg.microbatches,
        "run_s": run_s,
        "memory": memory,
        "fits": mem.peak <= H100["hbm_bytes"],
        "flops": flops,
        "traffic_bytes": mem.traffic,
        "collectives": ledger.summary(),
    }
    entry["roofline"] = roofline(entry, _peak_flops(spec))
    mf = model_flops(spec, cell)
    if not math.isnan(mf):
        entry["model_flops"] = mf
        entry["model_flops_ratio"] = mf / max(flops * n_cards, 1.0)
    if verbose:
        print(f"  flops/card {flops:.4g}, peak {mem.peak / 1e9:.3f} GB/card "
              f"(state {argument / 1e9:.3f} GB), collectives "
              f"{entry['collectives']['total'] / 1e9:.4f} GB/card", flush=True)
    return entry


def roofline(entry: dict, peak_flops: float) -> dict:
    """Lower bounds on the step's time on one H100 SXM: flops over the
    cell's compute peak (bf16 tensor cores for a bf16 model, else the f32
    peak), the bytes the step must touch (its state and batch read, its
    new state written: ``ideal``) or does touch unfused (``upper``) over
    HBM bandwidth, the collective bytes over one NVLink direction."""
    m = entry["memory"]
    ideal = m["argument_bytes"] + m["params_bytes"] + m["opt_bytes"]
    t_compute = entry["flops"] / peak_flops
    t_memory = ideal / H100["hbm_bytes_per_s"]
    t_coll = entry["collectives"]["total"] / H100["nvlink_bytes_per_s"]
    dom = max(("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
              key=lambda kv: kv[1])[0]
    return {
        "peak_flops": peak_flops,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_upper_s": entry["traffic_bytes"] / H100["hbm_bytes_per_s"],
        "t_collective_s": t_coll,
        "dominant": dom,
        "step_time_bound_s": max(t_compute, t_memory, t_coll),
    }


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (e.g. triplet_layout=flat)")
    args = ap.parse_args(argv)

    from repro_torch import configs

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = configs.list_archs() if (args.all or args.arch is None) else [args.arch]
    tags = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]
    failures = []
    for tag in tags:
        shape, axes = MESHES[tag]
        for arch in archs:
            spec = configs.get(arch)
            if args.override:
                ov = {}
                for kv in args.override:
                    k, v = kv.split("=", 1)
                    cur = getattr(spec.config, k)
                    ov[k] = type(cur)(v) if not isinstance(cur, bool) else v == "True"
                spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, **ov))
            for cell in spec.shapes:
                if args.cell and cell.name != args.cell:
                    continue
                path = out_dir / f"{arch}__{cell.name}__{tag}.json"
                if args.skip_existing and path.exists():
                    print(f"[skip] {path}")
                    continue
                print(f"[dryrun] {arch} x {cell.name} on the {tag} mesh ...", flush=True)
                try:
                    entry = run_cell(spec, cell, shape, axes)
                    path.write_text(json.dumps(entry, indent=1))
                    r = entry["roofline"]
                    print(f"  OK in {entry['run_s']:.1f}s | dominant={r['dominant']} "
                          f"bound={r['step_time_bound_s']:.4f}s | fits 80 GB: {entry['fits']}",
                          flush=True)
                except Exception as e:  # a cell the port cannot build is listed, not fatal
                    failures.append((arch, cell.name, tag))
                    print(f"  FAIL: {e}\n{traceback.format_exc()[-2000:]}", flush=True)
    print(f"\n[dryrun] done; failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
