"""Labeled metrics registry: Counter / Gauge / Histogram + snapshots
(counterpart of ``repro.obs.registry``).

One process-wide :class:`Registry` (``default_registry()``) is the
single sink every telemetry surface renders from: the sharded tier's
routing counters, :class:`~repro_torch.tune.rebuild.TunedTier` lifecycle
counters, mutation-report aggregation, the fast fit's fallbacks, and the
lookup-latency histograms of :mod:`repro_torch.obs.timing`.  The
per-surface accessors (``dist.sharded_index.tier_metrics()``,
``TunedTier.metrics()``) are thin views over snapshots of this registry.

The catalogue (:data:`CATALOGUE`) is the reference's, row for row,
including the rows whose writers the port does not have yet
(``serve_*``, ``hotcache_*``) and ``index_traces``, which stays empty:
the port has no jitted traces to mirror.

Device discipline
-----------------
:meth:`Histogram.observe_groups` buckets any number of (labels, values)
groups with one ``torch.searchsorted`` plus one ``torch.bincount`` over
CPU tensors: the latencies are host floats, so it launches nothing on
the card.  Like the reference's jitted update it buckets and sums in
float32, so a value within a float32 ulp of an edge lands where the
reference puts it.  Scalar :meth:`Histogram.observe` (spans) is host
numpy in float64.  Counter/Gauge updates are plain host floats.

Nothing in this module imports ``repro_torch.*``: the index and tier
code can depend on ``repro_torch.obs`` without cycles, and the
telemetry-off lookup paths never pull it in at call time.

Export schema (stable, the reference's)
---------------------------------------
``to_jsonl(snapshot)`` emits one JSON object per sample line::

    {"name": ..., "type": "counter"|"gauge", "labels": {...}, "value": f}
    {"name": ..., "type": "histogram", "labels": {...}, "count": n,
     "sum": f, "edges": [...], "counts": [...]}   # len(counts) == len(edges)+1

``from_jsonl`` reconstructs the snapshot dict; ``python -m
repro_torch.obs`` dumps/diffs these files.
"""

from __future__ import annotations

import json
import threading
import numpy as np
import torch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "diff",
    "exp_edges",
    "from_jsonl",
    "hist_quantile",
    "metric",
    "metric_catalogue",
    "register_collector",
    "reset",
    "sample_value",
    "snapshot",
    "to_jsonl",
]

#: default exponential bucket edges for latency histograms, microseconds:
#: 1us .. 10s, ~1.33x per bucket (57 edges -> 58 buckets incl. overflow).
DEFAULT_LATENCY_EDGES = tuple(float(x) for x in np.geomspace(1.0, 1e7, 57))


def exp_edges(lo: float, hi: float, n: int) -> tuple:
    """``n`` exponentially spaced bucket edges covering ``[lo, hi]``."""
    if not (0 < lo < hi) or n < 2:
        raise ValueError(f"need 0 < lo < hi and n >= 2, got ({lo}, {hi}, {n})")
    return tuple(float(x) for x in np.geomspace(lo, hi, n))


# ---------------------------------------------------------------------------
# Metric catalogue: the declared project-wide metric names.  docs_check
# verifies docs/observability.md against this table; metric() creates
# registry entries from it so every surface agrees on labels and help.
# ---------------------------------------------------------------------------

#: (name, type, label names, description)
CATALOGUE: tuple = (
    ("index_traces", "gauge", ("kind", "backend"),
     "jitted lookup traces per (kind, backend) — mirror of repro.index.trace_counts()"),
    ("route_lookups", "counter", ("tier",),
     "telemetry-enabled sharded_lookup calls"),
    ("route_queries", "counter", ("tier",),
     "queries routed through the tier"),
    ("route_dropped", "counter", ("tier",),
     "queries dropped by the capacity-factored exchange"),
    ("route_max", "counter", ("tier",),
     "busiest shard's queries, summed over lookups"),
    ("route_even", "counter", ("tier",),
     "perfectly even per-shard load, summed over lookups"),
    ("route_imbalance_last", "gauge", ("tier",),
     "last lookup's max-shard load over the even load"),
    ("route_imbalance_peak", "gauge", ("tier",),
     "peak routing imbalance since reset"),
    ("tier_lookups", "counter", ("tier",),
     "TunedTier.lookup calls"),
    ("tier_ingested", "counter", ("tier",),
     "keys ingested via TunedTier.insert_batch"),
    ("tier_absorbed", "counter", ("tier",),
     "keys merged into gapped leaves in place"),
    ("tier_overflowed", "counter", ("tier",),
     "keys diverted to a shard's delta buffer"),
    ("tier_duplicates", "counter", ("tier",),
     "ingested keys already present"),
    ("tier_shard_compactions", "counter", ("tier",),
     "delta -> leaves folds (device-side)"),
    ("tier_shard_refreshes", "counter", ("tier",),
     "single-shard rebuild + donated hot swap"),
    ("tier_retunes", "counter", ("tier",),
     "full bi-criteria re-tune + restack"),
    ("tier_forced_restacks", "counter", ("tier",),
     "refresh_shard rejected (capacity/static) -> full restack"),
    ("tier_pending", "gauge", ("tier",),
     "host-buffered keys (static-kind fallback arm)"),
    ("route_shard_queries", "counter", ("tier", "shard"),
     "queries routed to each owner shard (labeled tiers only — feeds rebalancing)"),
    ("rebalance_total", "counter", ("tier",),
     "fence rebalances triggered by sustained query-skew drift"),
    ("rebalance_moved_keys", "counter", ("tier",),
     "keys whose owner shard changed across rebalances"),
    ("rebalance_last_imbalance", "gauge", ("tier",),
     "windowed routing imbalance that triggered the last rebalance"),
    ("hotcache_hits", "counter", ("tier",),
     "queries answered by the hot-key cache in one gather"),
    ("hotcache_misses", "counter", ("tier",),
     "queries that fell through the hot-key cache to the tier"),
    ("hotcache_stale", "counter", ("tier",),
     "lookups that found the cache epoch behind the tier (invalidated)"),
    ("hotcache_rebuilds", "counter", ("tier",),
     "hot-key cache rebuilds from the decayed frequency sketch"),
    ("hotcache_entries", "gauge", ("tier",),
     "resident hot keys in the cache"),
    ("hotcache_space_bytes", "gauge", ("tier",),
     "hot-key cache residency: device arrays + host sketch bytes"),
    ("mutation_requested", "counter", ("kind",),
     "keys requested via repro.index.mutation.insert_batch"),
    ("mutation_absorbed", "counter", ("kind",),
     "keys absorbed into gapped leaves"),
    ("mutation_overflowed", "counter", ("kind",),
     "keys diverted to the delta buffer"),
    ("mutation_duplicates", "counter", ("kind",),
     "keys rejected as duplicates"),
    ("mutation_compactions", "counter", ("kind",),
     "compact() calls (explicit + auto)"),
    ("fit_fast_fallbacks", "counter", ("kind",),
     "fit='fast' verified-eps failures that fell back to the exact scan fit"),
    ("device_refreshes", "counter", ("kind", "outcome"),
     "single-program device shard refreshes (outcome=ok | fallback)"),
    ("serve_ticks", "counter", ("engine",),
     "DecodeEngine continuous-batching ticks"),
    ("serve_tokens_decoded", "counter", ("engine",),
     "tokens decoded across all slots"),
    ("serve_requests_finished", "counter", ("engine",),
     "requests retired from the batch"),
    ("serve_queued", "gauge", ("engine",),
     "requests waiting for a batch slot"),
    ("serve_live_slots", "gauge", ("engine",),
     "occupied batch slots"),
    ("lookup_latency_us", "histogram", ("kind", "backend", "tier", "phase"),
     "timed_lookup latency: phase=host (dispatch returned) / device (block_until_ready)"),
    ("span_us", "histogram", ("name",),
     "host wall-time of span(name) blocks"),
)


def metric_catalogue() -> tuple:
    """The declared metric table: (name, type, label names, description).
    ``tools/docs_check.py`` asserts docs/observability.md matches this."""
    return CATALOGUE


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


class _Metric:
    """Base: samples keyed by label-value tuples in declared order."""

    kind = "abstract"

    def __init__(self, name: str, label_names=(), help: str = ""):
        self.name = name
        self.label_names = tuple(label_names)
        self.help = help
        self._samples: dict = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.label_names)}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()

    def labelsets(self) -> list:
        return [dict(zip(self.label_names, k)) for k in sorted(self._samples)]


class Counter(_Metric):
    """Monotone by convention; ``set_value`` exists so proxy views
    (``TunedTier.counters``) can implement ``+=``/``-=`` semantics."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._samples[k] = self._samples.get(k, 0.0) + float(amount)

    def set_value(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._samples.get(self._key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[self._key(labels)] = float(value)

    # alias so Counter/Gauge share the proxy-write surface
    set_value = set

    def max(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._samples[k] = max(self._samples.get(k, float("-inf")), float(value))

    def value(self, **labels) -> float:
        return float(self._samples.get(self._key(labels), 0.0))


def _hist_update(edges, values, segs, n_segs: int):
    """Bucket counts ``(n_segs, len(edges) + 1)`` and per-group sums of
    float32 ``values``: the reference's jitted update on CPU tensors (one
    ``searchsorted``, one ``bincount`` of the bucket ids and one of the
    values, all float32)."""
    nb = edges.shape[0] + 1
    b = torch.searchsorted(edges, values, right=True)
    counts = torch.bincount(segs * nb + b, minlength=n_segs * nb).reshape(n_segs, nb)
    sums = torch.bincount(segs, weights=values, minlength=n_segs)
    return counts, sums


class Histogram(_Metric):
    """Exponential-bucket histogram: per-labelset bucket counts + sum.

    ``observe()`` is host-side numpy in float64 (spans).
    ``observe_groups()`` batches any number of (labels, values) groups
    through one float32 ``searchsorted`` + ``bincount`` on the host.
    """

    kind = "histogram"

    def __init__(self, name, label_names=(), help="", edges=None):
        super().__init__(name, label_names, help)
        self.edges = np.asarray(
            DEFAULT_LATENCY_EDGES if edges is None else edges, dtype=np.float64
        )
        if self.edges.ndim != 1 or len(self.edges) < 2 or (np.diff(self.edges) <= 0).any():
            raise ValueError(f"{name}: edges must be a strictly increasing 1-D array")
        self._edges_f32 = None

    def _row(self, key: tuple) -> dict:
        row = self._samples.get(key)
        if row is None:
            row = self._samples[key] = {
                "counts": np.zeros(len(self.edges) + 1, dtype=np.int64),
                "sum": 0.0,
            }
        return row

    def observe(self, value: float, **labels) -> None:
        """Host-side scalar observation: numpy only, float64."""
        key = self._key(labels)
        i = int(np.searchsorted(self.edges, value, side="right"))
        with self._lock:
            row = self._row(key)
            row["counts"][i] += 1
            row["sum"] += float(value)

    def observe_batch(self, values, **labels) -> None:
        self.observe_groups([(labels, values)])

    def observe_groups(self, groups) -> None:
        """Accumulate several (labels, values) groups in one float32
        update on CPU tensors (the path ``timed_lookup`` uses; nothing
        runs on the card)."""
        groups = list(groups)
        if not groups:
            return
        if self._edges_f32 is None:
            self._edges_f32 = torch.from_numpy(self.edges.astype(np.float32))
        vals, segs = [], []
        for i, (_, values) in enumerate(groups):
            v = np.asarray(values, dtype=np.float32).reshape(-1)
            vals.append(v)
            segs.append(np.full(v.shape, i, dtype=np.int64))
        counts, sums = _hist_update(
            self._edges_f32,
            torch.from_numpy(np.concatenate(vals)),
            torch.from_numpy(np.concatenate(segs)),
            len(groups),
        )
        counts = counts.numpy().astype(np.int64)
        sums = sums.numpy().astype(np.float64)
        with self._lock:
            for i, (labels, _) in enumerate(groups):
                row = self._row(self._key(labels))
                row["counts"] += counts[i]
                row["sum"] += float(sums[i])


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class Registry:
    def __init__(self):
        self._metrics: dict = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    # -- declaration -------------------------------------------------------
    def _get_or_make(self, cls, name, label_names, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != cls.kind or m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already declared as {m.kind}{m.label_names}"
                    )
                return m
            m = self._metrics[name] = cls(name, label_names, help, **kw)
            return m

    def counter(self, name, labels=(), help: str = "") -> Counter:
        return self._get_or_make(Counter, name, labels, help)

    def gauge(self, name, labels=(), help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, labels, help)

    def histogram(self, name, labels=(), help: str = "", edges=None) -> Histogram:
        return self._get_or_make(Histogram, name, labels, help, edges=edges)

    def metric(self, name: str):
        """Get-or-create a metric declared in :data:`CATALOGUE`."""
        m = self._metrics.get(name)
        if m is not None:
            return m
        for cname, kind, labels, help in CATALOGUE:
            if cname == name:
                ctor = {"counter": self.counter, "gauge": self.gauge,
                        "histogram": self.histogram}[kind]
                return ctor(name, labels=labels, help=help)
        raise KeyError(
            f"metric {name!r} is not in the repro_torch.obs catalogue; declare custom "
            "metrics explicitly via counter()/gauge()/histogram()"
        )

    def register_collector(self, fn) -> None:
        """``fn(registry)`` runs at every snapshot (pull-style gauges)."""
        if fn not in self._collectors:
            self._collectors.append(fn)

    # -- render ------------------------------------------------------------
    def snapshot(self, prefix: str | None = None) -> dict:
        """Point-in-time render: ``{name: {type, labels, help[, edges],
        samples: [...]}}``.  Runs registered collectors first."""
        for fn in list(self._collectors):
            fn(self)
        out: dict = {}
        for name in sorted(self._metrics):
            if prefix is not None and not name.startswith(prefix):
                continue
            m = self._metrics[name]
            entry: dict = {"type": m.kind, "labels": list(m.label_names), "help": m.help}
            if m.kind == "histogram":
                entry["edges"] = [float(e) for e in m.edges]
            samples = []
            with m._lock:
                for key in sorted(m._samples):
                    s: dict = {"labels": dict(zip(m.label_names, key))}
                    if m.kind == "histogram":
                        row = m._samples[key]
                        s["count"] = int(row["counts"].sum())
                        s["sum"] = float(row["sum"])
                        s["counts"] = [int(c) for c in row["counts"]]
                    else:
                        s["value"] = float(m._samples[key])
                    samples.append(s)
            entry["samples"] = samples
            out[name] = entry
        return out

    def reset(self, prefix: str | None = None) -> None:
        """Clear samples (metric declarations survive)."""
        with self._lock:
            for name, m in self._metrics.items():
                if prefix is None or name.startswith(prefix):
                    m.clear()


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def metric(name: str):
    """Catalogue-backed metric on the default registry."""
    return _DEFAULT.metric(name)


def snapshot(prefix: str | None = None) -> dict:
    return _DEFAULT.snapshot(prefix)


def reset(prefix: str | None = None) -> None:
    _DEFAULT.reset(prefix)


def register_collector(fn) -> None:
    _DEFAULT.register_collector(fn)


# ---------------------------------------------------------------------------
# Snapshot utilities
# ---------------------------------------------------------------------------


def sample_value(snap: dict, name: str, /, default: float = 0.0, **labels) -> float:
    """Counter/gauge value for a labelset in a snapshot (0.0 if absent)."""
    want = {k: str(v) for k, v in labels.items()}
    for s in snap.get(name, {}).get("samples", []):
        if s["labels"] == want:
            return float(s["value"])
    return default


def find_sample(snap: dict, name: str, /, **labels) -> dict | None:
    """Full sample dict (histograms included) for a labelset, or None."""
    want = {k: str(v) for k, v in labels.items()}
    entry = snap.get(name, {})
    for s in entry.get("samples", []):
        if s["labels"] == want:
            out = dict(s)
            if "edges" in entry:
                out["edges"] = entry["edges"]
            return out
    return None


def hist_quantile(sample: dict, q: float) -> float:
    """Quantile estimate from a histogram sample (``counts`` + ``edges``):
    linear interpolation inside the winning bucket, edge-saturated at the
    extremes.  Returns 0.0 for an empty histogram."""
    counts = np.asarray(sample["counts"], dtype=np.float64)
    edges = np.asarray(sample["edges"], dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    target = q * total
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, target, side="left"))
    i = min(i, len(counts) - 1)
    lo = 0.0 if i == 0 else edges[i - 1]
    hi = edges[min(i, len(edges) - 1)]
    if i >= len(edges):  # overflow bucket: saturate at the top edge
        return float(edges[-1])
    prev = cum[i - 1] if i > 0 else 0.0
    frac = (target - prev) / counts[i] if counts[i] > 0 else 0.0
    return float(lo + frac * (hi - lo))


def diff(a: dict, b: dict) -> dict:
    """Snapshot delta ``b - a``: counters and histogram counts/sums
    subtract; gauges take ``b``'s value.  Samples only in ``b`` count
    from zero; samples only in ``a`` are dropped."""
    out: dict = {}
    for name, eb in b.items():
        ea = a.get(name, {})
        asamp = {tuple(sorted(s["labels"].items())): s for s in ea.get("samples", [])}
        entry = {k: v for k, v in eb.items() if k != "samples"}
        samples = []
        for s in eb.get("samples", []):
            key = tuple(sorted(s["labels"].items()))
            prev = asamp.get(key)
            d = {"labels": dict(s["labels"])}
            if eb["type"] == "histogram":
                pc = np.asarray(prev["counts"]) if prev else 0
                d["counts"] = [int(c) for c in (np.asarray(s["counts"]) - pc)]
                d["count"] = int(sum(d["counts"]))
                d["sum"] = float(s["sum"] - (prev["sum"] if prev else 0.0))
            elif eb["type"] == "counter":
                d["value"] = float(s["value"] - (prev["value"] if prev else 0.0))
            else:  # gauge: last-write-wins
                d["value"] = float(s["value"])
            samples.append(d)
        entry["samples"] = samples
        out[name] = entry
    return out


# ---------------------------------------------------------------------------
# JSONL export
# ---------------------------------------------------------------------------


def to_jsonl(snap: dict) -> str:
    """One JSON object per sample line (schema in the module docstring)."""
    lines = []
    for name, entry in snap.items():
        for s in entry.get("samples", []):
            rec: dict = {"name": name, "type": entry["type"], "labels": s["labels"]}
            if entry["type"] == "histogram":
                rec.update(
                    count=s["count"], sum=s["sum"],
                    edges=entry["edges"], counts=s["counts"],
                )
            else:
                rec["value"] = s["value"]
            lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def from_jsonl(text: str) -> dict:
    """Inverse of :func:`to_jsonl` (help strings are not round-tripped)."""
    snap: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        entry = snap.setdefault(
            rec["name"],
            {"type": rec["type"], "labels": sorted(rec["labels"]), "help": "", "samples": []},
        )
        s: dict = {"labels": rec["labels"]}
        if rec["type"] == "histogram":
            entry.setdefault("edges", rec["edges"])
            s.update(count=rec["count"], sum=rec["sum"], counts=rec["counts"])
        else:
            s["value"] = rec["value"]
        entry["samples"].append(s)
    return snap
