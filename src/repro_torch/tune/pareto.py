"""Bi-criteria Pareto auto-tuner: which index, for this table, within
this space budget? (counterpart of ``repro.tune.pareto``)

The paper's central result is that *space*, not accuracy, is the key to
learned-index efficiency: its bi-criteria PGM searches ε-space for the
best model under a byte budget, and the SY-RMI mining procedure searches
architecture-space the same way.  This module runs that search over
every registered kind:

* :func:`candidate_grid` — the registry-derived spec grid (each
  :class:`~repro_torch.index.specs.IndexSpec` subclass exposes
  ``default_grid(n_keys)``; a registered kind enrols itself).
* :func:`sweep` — build the grid through the batched builder
  (:func:`repro_torch.tune.batched.build_grid`) and measure the two
  criteria per candidate: ``space_bytes`` (model bytes, the paper's
  accounting) and the best-of-``reps`` wall time of ``Index.lookup`` on
  the timed backend (``"kernel"`` by default: the hand-written search
  kernels on the card).
* :func:`pareto_frontier` — the non-dominated (space, time) set.
* :func:`best_spec_for_budget` — the paper's bi-criteria selection for
  all kinds at once: the fastest candidate whose model fits the budget.

Candidates and frontiers serialize to plain-dict JSON
(:func:`frontier_report` / :func:`report_specs`) in the reference's
format, so either package reads the other's reports.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import keys as keymod
from repro_torch.device import wait_for
from repro_torch.index import impls, registry
from repro_torch.index.index import resolve_device
from repro_torch.index.specs import IndexSpec
from repro_torch.obs.timing import stopwatch

from .batched import build_grid


@dataclass
class Candidate:
    """One measured point on the time-space plane."""

    spec: IndexSpec
    space_bytes: int
    ns_per_query: float
    build_s: float
    exact: bool
    index: object = None  # the built Index (not serialized)

    @property
    def kind(self) -> str:
        return self.spec.kind

    def space_pct_of(self, n_keys: int) -> float:
        return 100.0 * self.space_bytes / (n_keys * 8)

    def to_dict(self) -> dict:
        return {
            "kind": self.spec.kind,
            "params": self.spec.params(),
            "space_bytes": int(self.space_bytes),
            "ns_per_query": float(self.ns_per_query),
            "build_s": float(self.build_s),
            "exact": bool(self.exact),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        spec = registry.entry(d["kind"]).spec_from_params(**d.get("params", {}))
        return cls(
            spec=spec,
            space_bytes=int(d["space_bytes"]),
            ns_per_query=float(d["ns_per_query"]),
            build_s=float(d["build_s"]),
            exact=bool(d.get("exact", True)),
        )


def candidate_grid(n_keys: int, kinds=None) -> list:
    """Registry-derived default sweep grid, in the paper's kind order.

    ``kinds`` restricts the sweep; spec classes shared by several kinds
    (L/Q/C share :class:`AtomicSpec`) contribute their grid once.
    """
    specs: list[IndexSpec] = []
    seen: set = set()
    for kind in kinds or registry.kinds():
        cls = registry.entry(kind).spec_cls
        if cls in seen:
            continue
        seen.add(cls)
        for spec in cls.default_grid(n_keys):
            if kinds is None or spec.kind in kinds:
                specs.append(spec)
    return specs


def _time_lookup(idx, table_t, queries_t, backend: str, reps: int) -> float:
    """Best-of-reps wall seconds of ``idx.lookup``, each call followed by a
    wait for the card (one warm-up call first)."""
    wait_for(idx.lookup(table_t, queries_t, backend=backend))
    best = np.inf
    for _ in range(reps):
        sw = stopwatch()
        wait_for(idx.lookup(table_t, queries_t, backend=backend))
        best = min(best, sw.elapsed)
    return best


def sweep(
    table_np,
    specs=None,
    *,
    kinds=None,
    queries=None,
    n_queries: int = 4096,
    backend: str = "kernel",
    reps: int = 3,
    seed: int = 0,
    fit: str = "auto",
    check_exact: bool = False,
    device=None,
) -> list:
    """Measure every candidate spec on one table: (space, latency) per
    candidate, built by :func:`build_grid` on ``device`` (default: the
    card) and timed on ``backend``.

    ``queries`` defaults to ``n_queries`` keys sampled from the table with
    ``np.random.default_rng(seed)`` (the paper's simulation-query
    protocol; the reference samples the same keys).  A spec whose kind
    does not claim ``backend`` drops out (GAPPED on ``"kernel"``).
    ``check_exact=True`` also holds every candidate's ranks to
    ``np.searchsorted``.  At the default 4,096 queries a call on the card
    takes about one launch's host time: pass more queries to time the
    search itself.
    """
    table_np = np.asarray(table_np, dtype=np.uint64)
    dev = resolve_device(device)
    if specs is None:
        specs = candidate_grid(len(table_np), kinds)
    # honest per-kind backend claims: a kind that does not implement the
    # timed backend (GAPPED has no kernel) cannot compete
    specs = [s for s in specs if backend in impls.query_impl(s.kind).backends]
    if queries is None:
        rng = np.random.default_rng(seed)
        queries = rng.choice(table_np, size=min(n_queries, max(16, len(table_np))))
    queries = np.asarray(queries, dtype=np.uint64)
    table_t, queries_t = keymod.encode(table_np, dev), keymod.encode(queries, dev)
    want = None
    if check_exact:
        want = np.searchsorted(table_np, queries, side="right") - 1

    sw = stopwatch()
    indexes = build_grid(specs, table_np, fit=fit, device=dev)
    build_s_total = sw.elapsed

    out = []
    for spec, idx in zip(specs, indexes):
        dt = _time_lookup(idx, table_t, queries_t, backend, reps)
        exact = True
        if want is not None:
            got = idx.lookup(table_t, queries_t, backend=backend).cpu().numpy()
            exact = bool(np.array_equal(got, want))
        out.append(
            Candidate(
                spec=spec,
                space_bytes=int(idx.space_bytes()),
                ns_per_query=dt / len(queries) * 1e9,
                build_s=float(idx.info.get("build_time", build_s_total / len(specs))),
                exact=exact,
                index=idx,
            )
        )
    return out


def pareto_frontier(candidates) -> list:
    """Non-dominated candidates, sorted by ascending space.

    A candidate is dominated if another is no larger *and* no slower
    (strictly better in at least one criterion).  Along the returned
    frontier space strictly increases and latency strictly decreases:
    the bi-criteria curve the paper plots.
    """
    ordered = sorted(candidates, key=lambda c: (c.space_bytes, c.ns_per_query))
    front: list[Candidate] = []
    best_t = np.inf
    for c in ordered:
        # the sort puts the fastest candidate of each space first, so a
        # strict time improvement implies a strictly larger space too
        if c.ns_per_query < best_t:
            front.append(c)
            best_t = c.ns_per_query
    return front


def best_candidate_for_budget(candidates, n_keys: int, space_budget_pct: float):
    """Fastest candidate whose model space fits the budget (% of the
    table's key bytes), or ``None`` when nothing fits."""
    budget = space_budget_pct / 100.0 * n_keys * 8
    fits = [c for c in candidates if c.space_bytes <= budget]
    return min(fits, key=lambda c: c.ns_per_query) if fits else None


def best_spec_for_budget(table_np, space_budget_pct: float, **sweep_kw) -> IndexSpec:
    """The paper's bi-criteria selection over every registered kind: sweep
    the grid, keep the candidates within ``space_budget_pct`` % of the
    table bytes, return the fastest one's spec.

    Raises ``ValueError`` if no candidate fits (the default grid's atomic
    models are ~56 bytes, so realistic budgets always have one).  Extra
    keyword arguments flow to :func:`sweep` (``kinds=``, ``backend=``,
    ``reps``/``n_queries``, ``device=``).  Example::

        spec = best_spec_for_budget(table, 2.0, n_queries=1 << 20)
        idx = repro_torch.index.build(spec, table)
        assert idx.space_bytes() <= 0.02 * table.nbytes
        ranks = idx.lookup(table, queries)
    """
    table_np = np.asarray(table_np, dtype=np.uint64)
    cands = sweep(table_np, **sweep_kw)
    best = best_candidate_for_budget(cands, len(table_np), space_budget_pct)
    if best is None:
        floor = min(c.space_bytes for c in cands)
        raise ValueError(
            f"no candidate fits {space_budget_pct}% of {len(table_np)} keys "
            f"({space_budget_pct / 100.0 * len(table_np) * 8:.0f} bytes); "
            f"smallest candidate is {floor} bytes"
        )
    return best.spec


DEFAULT_BUDGET_PCTS = (0.05, 0.7, 2.0, 10.0)


def frontier_report(
    table_np, candidates, frontier=None, *, budget_pcts=DEFAULT_BUDGET_PCTS, extra=None
) -> dict:
    """JSON-ready report: every candidate, the frontier, budget picks."""
    table_np = np.asarray(table_np)
    n = len(table_np)
    frontier = pareto_frontier(candidates) if frontier is None else frontier
    picks = {}
    for pct in budget_pcts:
        best = best_candidate_for_budget(candidates, n, pct)
        if best is not None:
            picks[str(pct)] = best.to_dict()
    report = {
        "n_keys": int(n),
        "table_bytes": int(n * 8),
        "candidates": [c.to_dict() for c in candidates],
        "frontier": [c.to_dict() for c in frontier],
        "budget_picks": picks,
    }
    report.update(extra or {})
    return report


def report_specs(report: dict, section: str = "frontier") -> list:
    """Rebuild the :class:`IndexSpec`s from a report section (the round
    trip a serving-side tuner takes to load a mined report)."""
    return [Candidate.from_dict(d).spec for d in report[section]]
