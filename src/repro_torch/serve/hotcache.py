"""Learned hot-key cache: a model-fronted read cache for Zipf traffic
(counterpart of ``repro.serve.hotcache``).

A few thousand entries of serving state in front of a
:class:`repro_torch.tune.TunedTier` answer the hot head of a skewed read
mix in one gather instead of a full sharded lookup: the learned-Bloom
filter idea specialised to exact membership over a mined hot set.

* **Sketch** — :class:`KeySketch`, a bounded host-side key-frequency
  sketch fed by every lookup batch and decayed at each rebuild.
* **Mined hot set** — :meth:`HotKeyCache.rebuild` takes the sketch's
  top-``capacity`` keys, sorts them, and resolves their predecessor
  ranks once through the tier's drop-free ``ref`` path (on the card, the
  batched kernel of the tier's kind).
* **Model front** — the monotone linear root model GAPPED routes with:
  normalise the query's uint64 value in f64, predict its slot, and
  search the measured ±eps window with
  :func:`repro_torch.core.search.bounded_upper_bound` (a step count fixed
  by the capacity).  A mispredict can only miss, never return a wrong
  rank.
* **Hits** — exact key matches answer from the resident rank array in one
  gather; a batch of all hits skips the tier.
* **Misses** — fall through to ``tier.lookup`` in a batch-shaped buffer,
  then merge back by a gather and a ``where`` over batch-shaped operands.
* **Invalidation** — the tier bumps :attr:`TunedTier.epoch` on every state
  change that can alter answers; a cache whose ``built_epoch`` lags is
  stale and is rebuilt (or bypassed) before it serves.  The
  ``hotcache_stale`` counter makes a skipped invalidation auditable.

The resident keys are sign-flipped int64 (:mod:`repro_torch.core.keys`)
on the tier's device; the pad sentinel is the largest uint64 key, which
encodes to the int64 maximum (``core.search.KEY_FILL``).  Every
hit/miss/stale/rebuild decision is a ``hotcache_*`` metric of
:mod:`repro_torch.obs`, labelled by the tier's name, and
``hotcache_space_bytes`` reports the residency: device arrays, model
scalars and the host sketch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core import search
from repro_torch.core.cdf import sorted_unique
from repro_torch.index.impls import _MAXKEY, _bucket_steps, _pow2ceil

__all__ = ["KeySketch", "HotKeyCache"]

#: the sketch's weight decay at every rebuild (the reference's default)
DECAY = 0.5
#: sketch slots per resident cache entry (the reference's default)
SKETCH_SLOTS_PER_ENTRY = 4


class KeySketch:
    """Bounded, decayed key-frequency sketch (host-side numpy).

    Tracks approximate per-key hit weights in at most ``capacity`` slots.
    ``update`` folds a query batch in exactly (unique keys and counts,
    then a scatter-add); when the slot budget overflows, the lightest
    keys are evicted.  ``age`` multiplies every weight by :data:`DECAY` and
    prunes dust, so sustained traffic dominates stale bursts.
    """

    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError("sketch capacity must be >= 1")
        self.capacity = int(capacity)
        self.keys = np.empty(0, dtype=np.uint64)  # sorted unique
        self.weights = np.empty(0, dtype=np.float64)

    def update(self, queries, weight: float = 1.0) -> None:
        """Fold a query batch in; ``weight`` scales the batch's counts (an
        operator priming a known-hot span against a large traffic backlog
        passes weight > 1 so the prime is not aged into noise)."""
        s = np.sort(np.asarray(queries, dtype=np.uint64).reshape(-1))
        if len(s) == 0:
            return
        first = np.flatnonzero(np.concatenate([[True], s[1:] != s[:-1]]))
        q = s[first]
        cnt = np.diff(np.append(first, len(s)))
        keys = sorted_unique(np.concatenate([self.keys, q]))
        w = np.zeros(len(keys), dtype=np.float64)
        w[np.searchsorted(keys, self.keys)] = self.weights
        w[np.searchsorted(keys, q)] += cnt * float(weight)
        if len(keys) > self.capacity:
            keep = np.sort(np.argpartition(w, -self.capacity)[-self.capacity:])
            keys, w = keys[keep], w[keep]
        self.keys, self.weights = keys, w

    def age(self) -> None:
        """Exponential decay + dust pruning (weights that rounded to ~0)."""
        self.weights = self.weights * DECAY
        live = self.weights > 1e-6
        if not live.all():
            self.keys, self.weights = self.keys[live], self.weights[live]

    def top(self, k: int) -> np.ndarray:
        """The ``k`` heaviest keys, sorted ascending (ties by key order)."""
        if len(self.keys) <= k:
            return self.keys.copy()
        pick = np.argpartition(self.weights, -k)[-k:]
        return np.sort(self.keys[pick])

    def space_bytes(self) -> int:
        return int(self.keys.nbytes + self.weights.nbytes)


def _fit(hot: np.ndarray, capacity: int) -> dict:
    """Monotone linear slot model + measured eps of a sorted hot set (host
    f64, the reference's arithmetic; the +2 margin absorbs rounding drift:
    an underestimate could only cost a miss, never a wrong rank)."""
    n = len(hot)
    kmin = np.float64(hot[0])
    span = np.float64(hot[-1]) - kmin
    inv_span = np.float64(1.0 / span) if span > 0 else np.float64(0.0)
    u = np.clip((hot.astype(np.float64) - kmin) * inv_span, 0.0, 1.0)
    slots = np.arange(n, dtype=np.float64)
    if n > 1 and span > 0:
        slope, icept = np.polyfit(u, slots, 1)
    else:
        slope, icept = np.float64(0.0), np.float64(0.0)
    pred = np.clip(np.floor(slope * u + icept), -4.0e15, 4.0e15)
    eps = int(np.max(np.abs(pred - slots))) + 2
    return {"kmin": kmin, "inv_span": inv_span, "slope": slope, "icept": icept,
            "eps": min(eps, capacity)}


def _model_tensors(model: dict, device) -> dict:
    """The probe model's scalars as 0-d tensors on ``device``: f64, and
    ``eps`` int64."""
    f64 = dict(dtype=torch.float64, device=device)
    out = {k: torch.tensor(float(model[k]), **f64) for k in ("kmin", "inv_span", "slope", "icept")}
    out["eps"] = torch.tensor(int(model["eps"]), dtype=torch.int64, device=device)
    return out


def _probe(keys, ranks, model: dict, n_hot: int, q, *, steps: int):
    """Model-guided membership probe over the resident hot set (encoded
    keys and queries on one device).

    Returns ``(hit, rank)``: ``hit[i]`` iff ``q[i]`` is exactly a live
    resident key, in which case ``rank[i]`` is its cached predecessor
    rank.  Pad slots sit at positions ``>= n_hot`` so a pad match never
    counts as a hit; an eps-window mispredict degrades to a miss."""
    c = keys.shape[0]
    u = torch.clamp((keymod.to_f64(q) - model["kmin"]) * model["inv_span"], 0.0, 1.0)
    pred = torch.clamp(torch.floor(model["slope"] * u + model["icept"]), -4.0e15, 4.0e15)
    pred = torch.clamp(pred.to(torch.int64), 0, c - 1)
    lo = torch.clamp(pred - model["eps"], 0, c - 1)
    hi = torch.clamp(pred + model["eps"], 0, c - 1)
    ub = search.bounded_upper_bound(keys, q, lo, hi - lo + 1, steps=steps)
    pos = torch.clamp(ub - 1, 0, c - 1)
    hit = (keys[pos] == q) & (pos < n_hot)
    return hit, ranks[pos]


class HotKeyCache:
    """A learned hot-key cache wrapped around a :class:`TunedTier`.

    Drop-in for the tier on the serving path: ``lookup`` probes the
    resident hot set first, and every mutating or policy method delegates
    to the wrapped tier, so :class:`repro_torch.serve.DecodeEngine` and
    :func:`repro_torch.obs.timed_lookup` accept either object.

    ``capacity`` is rounded up to a power of two (the probe's step count
    follows it); the sketch holds :data:`SKETCH_SLOTS_PER_ENTRY` slots an
    entry.  Staleness (the tier's epoch moved) triggers an immediate
    rebuild when ``rebuild_on_stale`` (the default) else a full-batch
    bypass.  Both are coherent; only their latency differs.  The
    reference's ``sketch_capacity``, ``decay`` and ``rebuild_every``
    options are not ported: no caller sets them.

    The reference also warms its jitted miss merge on the first batch of
    each shape (``_merge_warmed``), so no compile lands in a timed
    window; eager PyTorch compiles nothing, so the port has no such step.
    """

    def __init__(
        self,
        tier,
        *,
        capacity: int = 4096,
        rebuild_on_stale: bool = True,
    ):
        self.tier = tier
        self.device = tier.sidx.device
        self.capacity = _pow2ceil(capacity)
        self.sketch = KeySketch(SKETCH_SLOTS_PER_ENTRY * self.capacity)
        self.rebuild_on_stale = bool(rebuild_on_stale)
        self._steps = _bucket_steps(self.capacity)
        self.built_epoch = -1  # behind any real epoch until the first rebuild
        self.n_hot = 0
        self._keys = torch.full((self.capacity,), search.KEY_FILL, dtype=torch.int64,
                                device=self.device)
        self._ranks = torch.full((self.capacity,), search.NO_PRED, dtype=torch.int64,
                                 device=self.device)
        self._model = _model_tensors(
            {"kmin": 0.0, "inv_span": 0.0, "slope": 0.0, "icept": 0.0, "eps": 0}, self.device)

    # -- passthroughs (timed_lookup / DecodeEngine duck-typing) -----------
    @property
    def spec(self):
        return self.tier.spec

    @property
    def policy(self):
        return self.tier.policy

    @property
    def epoch(self) -> int:
        return self.tier.epoch

    def insert_batch(self, new_keys) -> None:
        self.tier.insert_batch(new_keys)

    def maybe_compact(self):
        return self.tier.maybe_compact()

    def maybe_rebalance(self):
        return self.tier.maybe_rebalance()

    # -- lifecycle ---------------------------------------------------------
    def stale(self) -> bool:
        return self.built_epoch != self.tier.epoch

    def space_bytes(self) -> int:
        """Cache residency: device arrays + model scalars + host sketch."""
        dev = self._keys.numel() * 8 + self._ranks.numel() * 8 + 5 * 8
        return int(dev) + self.sketch.space_bytes()

    def _label(self) -> dict:
        return dict(tier=getattr(self.tier, "name", "-"))

    def rebuild(self) -> int:
        """Re-mine the hot set from the (aged) sketch and refit the probe
        model; returns the resident entry count.  Ranks are resolved
        through the tier's drop-free ``ref`` lookup with telemetry off, so
        a rebuild never perturbs the routing counters it is fed by."""
        from repro_torch import obs
        from repro_torch.dist.sharded_index import sharded_lookup

        self.sketch.age()
        hot = self.sketch.top(self.capacity)
        hot = hot[hot != _MAXKEY]  # reserved pad sentinel, never a live key
        self.n_hot = len(hot)
        if self.n_hot:
            padded = np.full(self.capacity, _MAXKEY, dtype=np.uint64)
            padded[: self.n_hot] = hot
            resident = keymod.encode(padded, self.device)
            ranks = sharded_lookup(self.tier.sidx, resident, self.tier.ctx,
                                   backend=self.tier.policy.backend, mode="ref")
            self._keys = resident
            self._ranks = ranks.to(torch.int64)
            self._model = _model_tensors(_fit(hot, self.capacity), self.device)
            # a rebuild is off-path maintenance: wait for the resolved
            # residency here, so its device work is never billed to the
            # next serving lookup
            if self._ranks.is_cuda:
                torch.cuda.synchronize(self.device)
        self.built_epoch = self.tier.epoch
        lbl = self._label()
        obs.metric("hotcache_rebuilds").inc(**lbl)
        obs.metric("hotcache_entries").set(self.n_hot, **lbl)
        obs.metric("hotcache_space_bytes").set(self.space_bytes(), **lbl)
        return self.n_hot

    # -- serving path ------------------------------------------------------
    def lookup(self, queries, **kw):
        """Tier-compatible lookup (uint64 numpy or encoded int64 queries):
        probe the hot set, answer hits from the rank residency in one
        gather, fall misses through to the wrapped tier in a batch-shaped
        buffer, merge back.  Equal to the cache-off tier by construction:
        hits replay ranks the tier itself resolved at the current epoch."""
        from repro_torch import obs

        if torch.is_tensor(queries):
            q = keymod.as_keys(queries, self.device)
            q_np = keymod.decode(q)
        else:
            q_np = np.asarray(queries, dtype=np.uint64)
            q = None
        self.sketch.update(q_np)
        lbl = self._label()
        if self.stale():
            obs.metric("hotcache_stale").inc(**lbl)
            if self.rebuild_on_stale:
                self.rebuild()
            else:
                obs.metric("hotcache_misses").inc(len(q_np), **lbl)
                return self.tier.lookup(queries, **kw)
        if self.n_hot == 0:
            obs.metric("hotcache_misses").inc(len(q_np), **lbl)
            return self.tier.lookup(queries, **kw)
        if q is None:
            q = keymod.encode(q_np, self.device)
        hit, cached = _probe(self._keys, self._ranks, self._model, self.n_hot, q,
                             steps=self._steps)
        hit_np = hit.cpu().numpy()
        n_hit = int(hit_np.sum())
        obs.metric("hotcache_hits").inc(n_hit, **lbl)
        obs.metric("hotcache_misses").inc(len(q_np) - n_hit, **lbl)
        if n_hit == len(q_np):
            return cached  # one gather, no tier lookup
        # fixed-shape fall-through: misses are compacted to the front of a
        # batch-shaped buffer (pad lanes replay the first miss), and the
        # merge is a gather + where over batch-shaped operands
        miss_idx = np.flatnonzero(~hit_np)
        padded = np.full(len(q_np), q_np[miss_idx[0]], dtype=np.uint64)
        padded[: len(miss_idx)] = q_np[miss_idx]
        inv = np.zeros(len(q_np), dtype=np.int64)
        inv[miss_idx] = np.arange(len(miss_idx))
        tier_ranks = self.tier.lookup(padded, **kw).to(torch.int64)
        return torch.where(hit, cached, tier_ranks[torch.from_numpy(inv).to(self.device)])

    # -- telemetry ---------------------------------------------------------
    def metrics(self) -> dict:
        """Wrapped tier metrics + a ``hotcache`` section rendered from the
        registry snapshot under the tier's label."""
        from repro_torch import obs

        snap = obs.snapshot(prefix="hotcache_")
        lbl = self._label()
        out = self.tier.metrics()
        out["hotcache"] = {
            "entries": self.n_hot,
            "capacity": self.capacity,
            "space_bytes": self.space_bytes(),
            "built_epoch": self.built_epoch,
            "stale": self.stale(),
            "hits": int(obs.sample_value(snap, "hotcache_hits", **lbl)),
            "misses": int(obs.sample_value(snap, "hotcache_misses", **lbl)),
            "stale_detected": int(obs.sample_value(snap, "hotcache_stale", **lbl)),
            "rebuilds": int(obs.sample_value(snap, "hotcache_rebuilds", **lbl)),
        }
        return out
