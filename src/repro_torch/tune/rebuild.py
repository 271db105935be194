"""Serving-side re-tuning: drift absorption and in-place shard swaps
(counterpart of ``repro.tune.rebuild``).

A production tier is not static: keys are ingested, distributions drift,
and the spec that won the time-space trade-off at build time stops being
the winner.  :class:`TunedTier` closes the loop between the Pareto tuner
and the serving path with one mutation lifecycle (shared with
:mod:`repro_torch.index.mutation`)::

    absorb -> overflow -> compact -> retune

* **absorb** — when the tier's spec is an *updatable* kind (``GAPPED``),
  :meth:`TunedTier.insert_batch` routes each key to its owner shard by
  the tier's fences and absorbs it through the shard's gapped leaves
  (:func:`repro_torch.dist.sharded_index.insert_into_shard`, in place,
  no host buffering, no rebuild).
* **overflow** — keys whose leaf is full divert to the shard's sorted
  delta buffer, inside the same insert.
* **compact** — :meth:`TunedTier.maybe_compact` folds any delta past
  :data:`repro_torch.index.mutation.COMPACT_FILL` back into rebalanced
  leaves (:func:`~repro_torch.dist.sharded_index.compact_shard`); only
  *capacity exhaustion* (:class:`~repro_torch.index.mutation.NeedsRebuild`)
  escalates to a shard rebuild through ``refresh_shard``.
* **retune** — when total ingest since the last restack crosses
  :attr:`RebuildPolicy.retune_frac`, the whole tier is re-*tuned*:
  :func:`repro_torch.tune.pareto.best_spec_for_budget` re-runs the
  bi-criteria selection on the merged live table at the policy's space
  budget (timed on the policy's backend) and the tier is restacked under
  the winning spec.

Static kinds take the fallback arm of the same lifecycle: ingested keys
are buffered host-side per owner shard, and a shard whose pending
fraction crosses :attr:`RebuildPolicy.shard_refresh_frac` is rebuilt with
the tier's current spec and installed in place (``refresh_shard``), or,
with ``RebuildPolicy(device_refresh=True)`` on a PGM or RS tier, first
through the one-program :func:`~repro_torch.tune.device_fit.device_refresh`.

The reference donates the old tier to its jitted installs and reassigns
``self.sidx`` from the result; the port's ``refresh_shard``,
``compact_shard``, ``insert_into_shard`` and ``rebalance_shards`` write
in place (after every check) and return the same tier, and the
reassignments are kept.

``ingest`` / ``maybe_rebuild`` are deprecated aliases for
:meth:`~TunedTier.insert_batch` / :meth:`~TunedTier.maybe_compact`
(they emit ``DeprecationWarning``).

Every decision is a counter of the :mod:`repro_torch.obs` registry,
rendered by :meth:`TunedTier.metrics`.
"""

from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.core import keys as keymod
from repro_torch.core.cdf import sorted_unique
from repro_torch.dist.sharded_index import (
    ShardedIndex,
    _tier_counters_from_obs,
    compact_shard,
    derived_tier_metrics,
    insert_into_shard,
    rebalance_shards,
    refresh_shard,
    route_owners,
    shard_build_table,
    shard_query_weights,
    sharded_lookup,
    weighted_quantile_bounds,
)
from repro_torch.index import mutation, registry
from repro_torch.index.index import Index, check_backend, resolve_device
from repro_torch.index.mutation import NeedsRebuild
from repro_torch.index.specs import IndexSpec

from .pareto import best_spec_for_budget


@dataclass(frozen=True)
class RebuildPolicy:
    """When to refresh a shard, when to re-tune the whole tier — and,
    when enabled, when sustained query-skew drift rebalances the fences
    (``rebalance_imbalance > 0``; see :meth:`TunedTier.maybe_rebalance`)."""

    space_budget_pct: float = 2.0  # bi-criteria budget for re-tuning
    shard_refresh_frac: float = 0.05  # pending/resident keys that triggers a shard refresh
    retune_frac: float = 0.25  # total ingested fraction that triggers a full re-tune
    kinds: tuple | None = None  # restrict the re-tune grid (None = every registered kind)
    n_queries: int = 2048  # simulation-query batch for the re-tune sweep
    #: the lookup and re-tune sweep backend (the port's default path, the
    #: search kernels); a GAPPED tier names "xla", "bbs" or "ref"
    backend: str = "kernel"
    #: windowed mean routing imbalance (busiest / even shard load) that
    #: triggers a fence rebalance; 0.0 (the default) disables rebalancing
    rebalance_imbalance: float = 0.0
    #: windowed drop rate (capacity-factored exchange) that also triggers it
    rebalance_drop_rate: float = 0.002
    #: lookups a drift window must span before it counts as *sustained*
    rebalance_min_lookups: int = 8
    #: run shard refreshes as ONE device program (fit → leaf assembly →
    #: install, :func:`repro_torch.tune.device_fit.device_refresh`)
    #: for the kinds that support it; a failed device build (verified-ε
    #: miss, capacity, fences) falls back to the classic host path and
    #: counts in the ``device_refreshes`` obs metric
    device_refresh: bool = False
    #: fit mode of the device refresh program: ``"fast"`` (O(log n)
    #: depth, verified-ε) or ``"scan"`` (exact, O(n / chunk) depth)
    device_fit: str = "fast"


#: lifecycle counter fields, in the order metrics() reports them.  Each
#: backs a ``tier_<field>`` metric in the repro_torch.obs registry, labeled by
#: the tier's unique name; ``pending`` is a gauge (it decreases).
_COUNTER_FIELDS = (
    "lookups",
    "ingested",
    "absorbed",  # merged into gapped leaves in place (updatable kinds)
    "overflowed",  # diverted to a shard's delta buffer
    "duplicates",  # ingested keys already present
    "shard_compactions",  # delta -> leaves folds (device-side)
    "shard_refreshes",
    "retunes",
    "forced_restacks",  # refresh_shard rejected (capacity/static) -> full restack
    "pending",  # host-buffered keys (static-kind fallback arm)
)

_TIER_IDS = itertools.count()


class _Counters:
    """Attribute view over the tier's ``tier_*`` registry metrics.

    Reads and writes (``tier.counters.absorbed += n``) go straight to
    the repro_torch.obs registry under this tier's label, and
    ``metrics()`` renders from registry snapshots.
    """

    __slots__ = ("_tier",)

    def __init__(self, tier: str):
        object.__setattr__(self, "_tier", tier)

    def _metric(self, field: str):
        from repro_torch import obs

        return obs.metric(f"tier_{field}")

    def __getattr__(self, field: str) -> int:
        if field not in _COUNTER_FIELDS:
            raise AttributeError(field)
        return int(self._metric(field).value(tier=self._tier))

    def __setattr__(self, field: str, value) -> None:
        if field not in _COUNTER_FIELDS:
            raise AttributeError(f"unknown tier counter {field!r}")
        self._metric(field).set_value(float(value), tier=self._tier)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in _COUNTER_FIELDS}


class TunedTier:
    """A served, self-re-tuning sharded index tier.

    Build with a spec to pin the architecture, or without one to let the
    bi-criteria tuner pick it for the policy's space budget.  Updatable
    specs (``GAPPED``) absorb ingest in their leaves; static specs buffer
    and refresh — same lifecycle, see the module docstring.  The tier
    lives on ``device`` (default: the card).

    A pinned spec whose kind does not claim the policy's backend is
    refused at once with ``check_backend``'s ``ValueError`` (not at the
    first lookup): GAPPED has no kernel, so a GAPPED tier takes
    ``RebuildPolicy(backend="xla")`` (or ``"bbs"``, ``"ref"``).  Pass
    ``name=`` where labels must not depend on how many tiers the process
    made before (the default is ``tier<N>`` from a module counter).
    """

    def __init__(self, table_np, n_shards: int, policy: RebuildPolicy | None = None, *,
                 spec: IndexSpec | None = None, ctx=None, name: str | None = None,
                 device=None):
        self.policy = policy or RebuildPolicy()
        self.ctx = ctx
        self.device = resolve_device(device)
        table_np = np.asarray(table_np, dtype=np.uint64)
        if spec is None:
            spec = self._tune(table_np)
        check_backend(spec.kind, self.policy.backend)
        self.spec = spec
        self.sidx = ShardedIndex.build(spec, table_np, n_shards=n_shards, device=self.device)
        self._pending: list[list] = [[] for _ in range(n_shards)]
        self._since_retune = 0  # keys ingested since the last restack
        #: registry label: unique per tier so several tiers in one
        #: process keep separate tier_*/route_* counter labelsets
        self.name = name or f"tier{next(_TIER_IDS)}"
        self.counters = _Counters(self.name)
        #: staleness epoch: bumped on every state change that can alter
        #: served answers (insert/compact/refresh/restack/rebalance).
        #: Derived read structures (the reference's hot-key cache)
        #: compare their build epoch against this to detect staleness.
        self.epoch = 0
        # (counters, per-shard weights) snapshot opening the current
        # drift-detection window; None until the first maybe_rebalance
        self._rb_window: tuple | None = None

    def _updatable(self) -> bool:
        return self.spec.kind in mutation.updatable_kinds()

    def _bump_epoch(self) -> None:
        """Mark every derived read structure (hot-key caches) stale."""
        self.epoch += 1

    def _owners(self, keys: np.ndarray) -> np.ndarray:
        """Owner shard of each uint64 key by the tier's fences (host numpy)."""
        return route_owners(self.sidx.fences, keymod.encode(keys, self.device)).cpu().numpy()

    def _build_shard(self, build_table: np.ndarray) -> Index:
        """A replacement shard index with the tier's spec, on the host (the
        installs read its leaves as numpy)."""
        entry = registry.entry(self.spec.kind)
        return Index.from_numpy(self.spec.kind, *entry.build(self.spec, build_table),
                                device="cpu")

    # -- serving path ------------------------------------------------------
    def lookup(self, queries, **kw):
        """Tier lookup with telemetry on (imbalance/drop counters in the
        registry, labelled with the tier's ``name``; :meth:`metrics` reads
        them back).
        When the policy enables rebalancing, each lookup also feeds the
        drift window (:meth:`maybe_rebalance`) — answers are computed
        against the pre-rebalance fences, so the batch that trips the
        threshold is still served exactly."""
        self.counters.lookups += 1
        kw.setdefault("telemetry", True)
        kw.setdefault("telemetry_label", self.name)
        kw.setdefault("backend", self.policy.backend)
        out = sharded_lookup(self.sidx, queries, self.ctx, **kw)
        if self.policy.rebalance_imbalance > 0:
            self.maybe_rebalance()
        return out

    # -- drift: absorb -> overflow ----------------------------------------
    def insert_batch(self, new_keys) -> None:
        """Route new keys to their owner shards (fence routing) and
        absorb them: device-side through the gapped leaves + delta for
        updatable specs, host-buffered for static specs; then apply the
        compact/refresh/retune policy (:meth:`maybe_compact`)."""
        new_keys = sorted_unique(np.asarray(new_keys, dtype=np.uint64))
        if len(new_keys) == 0:
            return
        self.counters.ingested += len(new_keys)
        self._since_retune += len(new_keys)
        self._bump_epoch()
        if self._updatable():
            todo = new_keys
            while len(todo):
                todo = self._absorb(todo)
        else:
            owners = self._owners(new_keys)
            for s in range(self.sidx.n_shards):
                mine = new_keys[owners == s]
                if len(mine):
                    self._pending[s].append(mine)
            self.counters.pending += len(new_keys)
        self.maybe_compact()

    def _absorb(self, keys: np.ndarray) -> np.ndarray:
        """One fence-routing pass of the absorb arm.  Returns the tail of
        keys that must be *re-routed* because a forced restack moved the
        fences mid-pass (empty when the pass completed)."""
        owners = self._owners(keys)
        for s in range(self.sidx.n_shards):
            mine = keys[owners == s]
            if not len(mine):
                continue
            try:
                self.sidx, report = insert_into_shard(self.sidx, s, mine)
            except NeedsRebuild:
                # leaves + delta exhausted: rebuild just this shard with
                # the tier's spec (the lifecycle's escalation arm)
                self._pending[s].append(mine)
                self.counters.pending += len(mine)
                before = self.counters.forced_restacks
                self.refresh(s)
                if self.counters.forced_restacks > before:
                    # the restack consumed every buffered key but moved
                    # the fences: the unprocessed tail needs re-routing
                    return keys[owners > s]
                continue
            self.counters.absorbed += report.absorbed
            self.counters.overflowed += report.overflowed
            self.counters.duplicates += report.duplicates
            if report.compacted:
                self.counters.shard_compactions += 1
        return keys[:0]

    def _shard_keys(self, s: int) -> np.ndarray:
        if self._updatable():
            from repro_torch.index import updatable

            # the stacked tables are a stale build-time snapshot for
            # self-contained kinds: read the live merged key set instead
            return updatable.live_keys(self.sidx.shard(s))
        cnt = int(self.sidx.counts[s])
        return keymod.decode(self.sidx.tables[s][:cnt])

    def _merged_table(self) -> np.ndarray:
        parts = [self._shard_keys(s) for s in range(self.sidx.n_shards)]
        parts += [k for p in self._pending for k in p]
        return sorted_unique(np.concatenate(parts))

    def _pending_count(self, s: int) -> int:
        return sum(len(k) for k in self._pending[s])

    # -- compact -> retune -------------------------------------------------
    def maybe_compact(self) -> str | None:
        """Apply the policy: ``"retune"``, ``"compact"``, ``"refresh"``
        or ``None``.  Updatable specs compact any shard whose delta fill
        crossed :data:`~repro_torch.index.mutation.COMPACT_FILL`; static specs
        refresh any shard whose host-pending fraction crossed
        :attr:`RebuildPolicy.shard_refresh_frac`."""
        total = int(self.sidx.counts.sum())
        drift = self._since_retune if self._updatable() else self.counters.pending
        if drift >= max(1, int(self.policy.retune_frac * total)):
            self.retune()
            return "retune"
        did = None
        if self._updatable():
            dc = self.sidx.index.arrays["delta_count"].cpu().numpy()
            dcap = int(self.sidx.index.arrays["delta"].shape[1])
            for s in range(self.sidx.n_shards):
                if int(dc[s]) / max(dcap, 1) < mutation.COMPACT_FILL:
                    continue
                try:
                    self.sidx = compact_shard(self.sidx, s)
                except NeedsRebuild:
                    self.refresh(s)
                    did = "refresh"
                    continue
                self.counters.shard_compactions += 1
                self._bump_epoch()
                did = "compact"
            return did
        for s in range(self.sidx.n_shards):
            resident = int(self.sidx.counts[s])
            if self._pending_count(s) >= max(1, int(self.policy.shard_refresh_frac * resident)):
                self.refresh(s)
                did = "refresh"
        return did

    def refresh(self, s: int) -> None:
        """Rebuild shard ``s`` with the tier's spec and install it in place
        (``refresh_shard``); fall back to a full restack when the rebuilt
        shard no longer fits the stacked structure.

        With ``policy.device_refresh`` enabled (and a PGM or RS tier), the
        rebuild first tries the one-program device pipeline — fit, leaf
        assembly and an ``ok``-gated install
        (:func:`repro_torch.tune.device_fit.device_refresh`); a build the
        device program rejects (verified-ε miss, capacity, fences,
        trip-count budgets) leaves the tier untouched and falls through
        to the host path below."""
        merged = sorted_unique(np.concatenate([self._shard_keys(s)] + self._pending[s]))
        if self._try_device_refresh(s, merged):
            return
        try:
            # static kinds must be FITTED on the padded resident row
            # (shard_build_table), or the installed model mispredicts
            # against the stacked capacity-m table
            build_tab = shard_build_table(
                self.spec.kind, merged, int(self.sidx.tables.shape[1])
            )
            new_index = self._build_shard(build_tab)
            self.sidx = refresh_shard(self.sidx, s, new_index, merged)
        except ValueError:
            # outgrew the tier's table capacity / leaf shapes / statics
            self.counters.forced_restacks += 1
            self._restack(self._merged_table(), self.spec)
            return
        self.counters.shard_refreshes += 1
        self.counters.pending -= self._pending_count(s)
        self._pending[s] = []
        self._bump_epoch()

    def _try_device_refresh(self, s: int, merged: np.ndarray) -> bool:
        """The device-program arm of :meth:`refresh`.  Returns True when
        the one-program pipeline installed the shard; False routes the
        caller to the host path (a build the device program *rejected*
        also counts a ``fallback`` outcome in the ``device_refreshes``
        obs metric; the tier is untouched then, so the host path starts
        clean)."""
        p = self.policy
        if not p.device_refresh:
            return False
        from repro_torch import obs

        from .device_fit import DEVICE_REFRESH_KINDS, device_refresh

        kind = self.spec.kind
        m = int(self.sidx.tables.shape[1])
        if kind not in DEVICE_REFRESH_KINDS or m < 2 or not 0 < len(merged) <= m:
            return False
        self.sidx, ok = device_refresh(self.sidx, s, merged, self.spec.eps, fit=p.device_fit)
        if not bool(ok):  # lazy host sync, off the serve path
            obs.metric("device_refreshes").inc(kind=kind, outcome="fallback")
            return False
        obs.metric("device_refreshes").inc(kind=kind, outcome="ok")
        self.counters.shard_refreshes += 1
        self.counters.pending -= self._pending_count(s)
        self._pending[s] = []
        self._bump_epoch()
        return True

    def retune(self) -> None:
        """Re-run the bi-criteria selection on the merged table and
        restack the tier under the winning spec."""
        merged = self._merged_table()
        self._restack(merged, self._tune(merged))
        self.counters.retunes += 1

    def _tune(self, table_np: np.ndarray) -> IndexSpec:
        p = self.policy
        return best_spec_for_budget(
            table_np, p.space_budget_pct, kinds=p.kinds, n_queries=p.n_queries,
            backend=p.backend, device=self.device,
        )

    def _restack(self, table_np: np.ndarray, spec: IndexSpec, *, bounds=None) -> None:
        self.spec = spec
        self.sidx = ShardedIndex.build(
            spec, table_np, n_shards=self.sidx.n_shards, bounds=bounds, device=self.device
        )
        self._pending = [[] for _ in range(self.sidx.n_shards)]
        self._since_retune = 0
        self.counters.pending = 0
        self._rb_window = None  # fences moved: the drift window restarts
        self._bump_epoch()

    # -- skew-aware rebalancing (query-driven, zero retunes) ---------------
    def maybe_rebalance(self) -> str | None:
        """Rebalance the fences when routing drift is *sustained*.

        Reads the tier's ``route_*`` / ``route_shard_queries`` registry
        counters, windows them against the snapshot taken at the last
        check, and triggers :meth:`rebalance` when the window spans at
        least :attr:`RebuildPolicy.rebalance_min_lookups` lookups AND its
        mean imbalance crosses :attr:`RebuildPolicy.rebalance_imbalance`
        (or its drop rate crosses :attr:`RebuildPolicy.rebalance_drop_rate`).
        Disabled (returns ``None`` immediately) while
        ``rebalance_imbalance <= 0`` — the default, so plain tiers pay
        zero snapshot cost per lookup."""
        p = self.policy
        if p.rebalance_imbalance <= 0:
            return None
        cur = _tier_counters_from_obs(self.name)
        shw = shard_query_weights(self.name, self.sidx.n_shards)
        if self._rb_window is None:
            self._rb_window = (cur, shw)
            return None
        prev, shw0 = self._rb_window
        if cur["lookups"] - prev["lookups"] < p.rebalance_min_lookups:
            return None
        d_even = cur["routed_even"] - prev["routed_even"]
        d_q = cur["queries"] - prev["queries"]
        imb = (cur["routed_max"] - prev["routed_max"]) / d_even if d_even > 0 else 0.0
        drop = (cur["dropped"] - prev["dropped"]) / d_q if d_q > 0 else 0.0
        self._rb_window = (cur, shw)
        if imb < p.rebalance_imbalance and drop <= p.rebalance_drop_rate:
            return None
        self.rebalance(weights=np.maximum(shw - shw0, 0.0), imbalance=imb)
        return "rebalance"

    def rebalance(self, weights=None, *, imbalance: float | None = None) -> None:
        """Recompute the router fences from the observed per-shard owner
        histogram (weighted-quantile split) and re-shard through the
        in-place ``refresh_shard`` path — the tier's pinned spec is reused
        as-is (zero full retunes), pending/delta keys merge into the new
        partition, and answers stay bit-exact before and after.  Falls
        back to a full restack *at the same skew-aware bounds* when a
        rebuilt shard no longer fits the stacked structure."""
        from repro_torch import obs

        merged = self._merged_table()
        if weights is None:
            weights = shard_query_weights(self.name, self.sidx.n_shards)
        old_fences = keymod.decode(self.sidx.fences)
        bounds = weighted_quantile_bounds(merged, old_fences, weights)
        S = self.sidx.n_shards
        old_own = np.clip(np.searchsorted(old_fences, merged, side="right") - 1, 0, S - 1)
        new_own = np.repeat(np.arange(S), np.diff(bounds))
        moved = int((old_own != new_own).sum())
        try:
            self.sidx = rebalance_shards(self.sidx, merged, bounds, self._build_shard)
        except ValueError:
            self.counters.forced_restacks += 1
            self._restack(merged, self.spec, bounds=bounds)
        else:
            self._pending = [[] for _ in range(S)]
            self._since_retune = 0
            self.counters.pending = 0
            self._rb_window = None
            self._bump_epoch()
        obs.metric("rebalance_total").inc(tier=self.name)
        obs.metric("rebalance_moved_keys").inc(moved, tier=self.name)
        if imbalance is not None:
            obs.metric("rebalance_last_imbalance").set(imbalance, tier=self.name)

    # -- deprecated aliases (one release) ----------------------------------
    def ingest(self, new_keys) -> None:
        """Deprecated alias for :meth:`insert_batch`."""
        warnings.warn(
            "TunedTier.ingest() is deprecated; use insert_batch()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.insert_batch(new_keys)

    def maybe_rebuild(self) -> str | None:
        """Deprecated alias for :meth:`maybe_compact`."""
        warnings.warn(
            "TunedTier.maybe_rebuild() is deprecated; use maybe_compact()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.maybe_compact()

    # -- telemetry ---------------------------------------------------------
    def metrics(self) -> dict:
        """Rebuild counters + this tier's own routing/drop counters,
        rendered from a ``repro_torch.obs`` registry snapshot (the
        ``tier_*`` and ``route_*`` metrics under this tier's label)."""
        from repro_torch import obs

        snap = obs.snapshot(prefix="tier_")
        counters = {
            f: int(obs.sample_value(snap, f"tier_{f}", tier=self.name))
            for f in _COUNTER_FIELDS
        }
        rb = obs.snapshot(prefix="rebalance_")
        return {
            "spec": self.spec.display_name(),
            "n_shards": self.sidx.n_shards,
            "n_keys": int(self.sidx.counts.sum()),
            "space_bytes": int(self.sidx.space_bytes()),
            **counters,
            "rebalances": int(obs.sample_value(rb, "rebalance_total", tier=self.name)),
            "rebalance_moved_keys": int(
                obs.sample_value(rb, "rebalance_moved_keys", tier=self.name)
            ),
            "routing": derived_tier_metrics(_tier_counters_from_obs(self.name)),
        }
