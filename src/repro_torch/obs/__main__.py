"""``python -m repro_torch.obs`` — dump / diff JSONL metric snapshots
(counterpart of ``python -m repro.obs``; same output on the same files).

::

    python -m repro_torch.obs dump snapshot.jsonl             # pretty-print one export
    python -m repro_torch.obs diff before.jsonl after.jsonl   # delta (after - before)

Snapshots come from ``repro_torch.obs.to_jsonl(repro_torch.obs.snapshot())``
(or the reference's, whose schema is the same).  Histograms print count
/ sum plus p50/p90/p99 estimates.
"""

from __future__ import annotations

import argparse
import sys

from .registry import diff, from_jsonl, hist_quantile


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _print_snapshot(snap: dict, *, skip_zero: bool = False) -> None:
    for name in sorted(snap):
        entry = snap[name]
        for s in entry.get("samples", []):
            label = f"{name}{_fmt_labels(s['labels'])}"
            if entry["type"] == "histogram":
                if skip_zero and s["count"] == 0:
                    continue
                sample = {**s, "edges": entry["edges"]}
                qs = " ".join(
                    f"p{int(q * 100)}={hist_quantile(sample, q):.3g}"
                    for q in (0.5, 0.9, 0.99)
                )
                print(f"{label} count={s['count']} sum={s['sum']:.6g} {qs}")
            else:
                if skip_zero and s["value"] == 0:
                    continue
                print(f"{label} = {s['value']:.6g}")


def _load(path: str) -> dict:
    with open(path) as f:
        return from_jsonl(f.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="pretty-print one JSONL snapshot")
    d.add_argument("snapshot")
    dd = sub.add_parser("diff", help="print the delta between two snapshots")
    dd.add_argument("before")
    dd.add_argument("after")
    args = ap.parse_args(argv)

    if args.cmd == "dump":
        _print_snapshot(_load(args.snapshot))
    else:
        _print_snapshot(diff(_load(args.before), _load(args.after)), skip_zero=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
