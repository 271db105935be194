"""Render the dry run's tables from its JSON entries (counterpart of
``repro.launch.roofline_report``)::

    PYTHONPATH=src python -m repro_torch.launch.roofline_report build/dryrun

The reference's tables, column for column: the dry-run table (the time
to build and trace the step where the reference reports its compile,
``temp/chip`` the peak beyond the step's arguments, ``args/chip`` the
state and batch, the collective counts by kind), the roofline table and
the roofline fraction, read from :mod:`repro_torch.launch.dryrun`'s
entries.  :data:`MOVE_HINTS` name the port's levers.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

MOVE_HINTS = {
    ("lm", "compute"): ("raise the per-card batch; a fused attention kernel in place of the"
                        " plain causal_attention"),
    ("lm", "memory"): "fused attention and softmax-cross-entropy: no materialised logit chunks",
    ("lm", "collective"): ("bucket the dp gradient all-reduce and overlap it with the backward;"
                           " bf16/int8 grad compression"),
    ("gnn", "collective"): ("node-shard the segment sums: exchange sorted edge partials instead"
                            " of all-gathering messages"),
    ("gnn", "memory"): "cache the RBF/SBF bases across blocks; fuse the gather and the product",
    ("recsys", "collective"): "the a2a owner exchange instead of the masked gather + psum",
    ("recsys", "memory"): "fuse the embedding gather with the interaction (csrc/embedding_bag.cu)",
    ("recsys", "compute"): "batch the candidate MLP; hoist the user-side features",
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def load(dirpath: str, mesh: str):
    return [json.loads(f.read_text()) for f in sorted(Path(dirpath).glob(f"*__{mesh}.json"))]


def family_of(arch: str) -> str:
    if arch in ("dimenet",):
        return "gnn"
    if arch in ("dlrm-mlperf", "din", "wide-deep", "sasrec"):
        return "recsys"
    return "lm"


def dryrun_table(rows):
    out = [
        "| arch | cell | mesh | compile | temp/chip | args/chip | collectives (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|",
    ]
    for e in rows:
        m, c = e.get("memory", {}), e.get("collectives", {})
        counts = "/".join(str(c.get(f"n_{k}", "-")) for k in COLLECTIVES)
        out.append(
            f"| {e['arch']} | {e['cell']} | {e['mesh']} | {e['run_s']:.1f}s "
            f"| {m.get('temp_bytes', 0) / 1e9:.2f} GB "
            f"| {m.get('argument_bytes', 0) / 1e9:.2f} GB "
            f"| {counts} |"
        )
    return "\n".join(out)


def roofline_table(rows):
    out = [
        "| arch | cell | t_compute | t_memory (ideal..upper) | t_collective | dominant"
        " | bound | MODEL/counted flops | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for e in rows:
        r = e.get("roofline", {})
        hint = MOVE_HINTS.get((family_of(e["arch"]), r.get("dominant", "")), "")
        mfr = e.get("model_flops_ratio")
        mfr_s = f"{mfr:.2f}" if isinstance(mfr, float) and not math.isnan(mfr) else "n/a"
        out.append(
            f"| {e['arch']} | {e['cell']} | {r.get('t_compute_s', 0):.3f}s "
            f"| {r.get('t_memory_s', 0):.3f}..{r.get('t_memory_upper_s', 0):.3f}s "
            f"| {r.get('t_collective_s', 0):.3f}s | {r.get('dominant', '?')} "
            f"| {r.get('step_time_bound_s', 0):.3f}s | {mfr_s} | {hint} |"
        )
    return "\n".join(out)


def mfu_summary(rows):
    out = ["| arch | cell | roofline fraction (t_compute / bound) |", "|---|---|---|"]
    for e in rows:
        r = e.get("roofline", {})
        b = r.get("step_time_bound_s", 0)
        frac = r.get("t_compute_s", 0) / b if b else 0.0
        out.append(f"| {e['arch']} | {e['cell']} | {frac * 100:.1f}% |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "build/dryrun"
    for mesh in ("single", "multi"):
        rows = load(d, mesh)
        print(f"\n### Dry-run — {mesh} mesh ({'256' if mesh == 'single' else '512'} ranks,"
              " H100 SXM)\n")
        print(dryrun_table(rows))
        if mesh == "single":
            print(f"\n### Roofline — {mesh} mesh\n")
            print(roofline_table(rows))
            print("\n### Roofline fraction\n")
            print(mfu_summary(rows))


if __name__ == "__main__":
    main()
