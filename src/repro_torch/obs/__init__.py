"""repro_torch.obs — metrics, spans and timed lookups (counterpart of
``repro.obs``; docs/observability.md lists the catalogue).

One labeled registry (:mod:`repro_torch.obs.registry`) backs every
telemetry surface of the port; :mod:`repro_torch.obs.timing` adds spans,
stopwatches and the device-latency ``timed_lookup`` wrapper; ``python -m
repro_torch.obs`` dumps/diffs JSONL snapshot exports.

Import discipline: this package imports nothing from ``repro_torch.*``,
so any layer may depend on it, and the telemetry-off lookup paths never
import it at call time.

The reference registers one collector here, which mirrors its jitted
lookup trace counts into the ``index_traces`` gauge at every snapshot.
The port has no traces (its kernels count launches instead), so it
registers no collector: the catalogue keeps the ``index_traces`` row and
the gauge stays empty.
"""

from __future__ import annotations

from .registry import (
    CATALOGUE,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    diff,
    exp_edges,
    find_sample,
    from_jsonl,
    hist_quantile,
    metric,
    metric_catalogue,
    register_collector,
    reset,
    sample_value,
    snapshot,
    to_jsonl,
)
from .timing import Stopwatch, span, stopwatch, timed_lookup

__all__ = [
    "CATALOGUE",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Stopwatch",
    "default_registry",
    "diff",
    "exp_edges",
    "find_sample",
    "from_jsonl",
    "hist_quantile",
    "metric",
    "metric_catalogue",
    "register_collector",
    "reset",
    "sample_value",
    "snapshot",
    "span",
    "stopwatch",
    "timed_lookup",
    "to_jsonl",
]
