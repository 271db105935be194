"""Batched serving engine: continuous-batching decode loop (counterpart of
``repro.serve.engine``).

Requests enter a queue, are admitted into free batch slots, prefill fills
their KV rows one token a step, then every engine tick decodes one token
for all live slots.  Finished sequences free their slots at once.  Greedy
sampling (argmax) keeps the engine deterministic.

The engine follows the reference step for step, including two of its
behaviours (ROADMAP queue 3): a prefill step runs ``decode_step`` on the
whole ``(B, 1)`` batch, zero tokens in the other rows, so it overwrites
every slot's K/V row at the prompt positions; and a tick runs every slot
at one position, the largest of the slots' positions.

The compute copy of the weights (the reference's per-step ``astype``) is
made once, here.  Under a placed ``ctx`` (the reference's ``(params, cfg,
ctx)``) every rank runs the same loop on the same requests: ``params``
are the rank's blocks (``transformer.init(gen, cfg, ctx)``), the cache is
its block (batch on ``dp``, sequence on ``seqm``:
``transformer.init_cache(..., ctx=ctx)``), and each tick goes through the
placed ``decode_step``, which gives every rank the whole logits.

Built with a ``tier`` (a :class:`~repro_torch.tune.TunedTier`, or a
:class:`~repro_torch.serve.hotcache.HotKeyCache` in front of one),
``tick()`` drives the tier's drift policy between decode steps:
``maybe_compact()``, and ``maybe_rebalance()`` where the tier has it.
:meth:`DecodeEngine.metrics` publishes the serving counters into the
:mod:`repro_torch.obs` registry (``serve_*``, labelled by engine) and
renders them, the sharded tier's routing counters
(``repro_torch.dist.tier_metrics()``) and the tier's own counters from
the registry.  The hot loop keeps plain int attributes: a tick of an
engine without a tier never imports ``repro_torch.obs``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer

_ENGINE_IDS = itertools.count()


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Serve ``cfg`` with ``params`` on their device (the card for
    :func:`~repro_torch.models.transformer.init` with a CUDA generator),
    attention on the hand-written kernel; ``ctx`` an optional sharding
    context (``params`` then this rank's blocks); ``tier`` an optional
    self-re-tuning index tier whose policy the ticks drive."""

    def __init__(self, params, cfg, *, ctx=None, batch_slots: int = 8, max_seq: int = 512,
                 tier=None):
        self.cfg = cfg
        self.ctx = ctx
        self.device = params["embed"].device
        self.params = transformer.cast_params(params, L.dtype_of(cfg.dtype))
        self.b = batch_slots
        self.max_seq = max_seq
        self.cache = transformer.init_cache(cfg, batch_slots, max_seq, device=self.device,
                                            ctx=ctx)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, dtype=np.int32)
        self.queue: List[Request] = []
        self.ticks = 0
        self.tokens_decoded = 0
        self.requests_finished = 0
        #: repro_torch.obs label: unique per engine, so several engines in
        #: one process keep separate serve_* labelsets
        self.name = f"engine{next(_ENGINE_IDS)}"
        self.tier = tier

    def metrics(self) -> dict:
        """Serving counters + the index substrate's telemetry.

        Publishes the plain int attributes into the ``repro_torch.obs``
        registry (``serve_*``, labelled by engine) and renders the result
        from one registry snapshot, with the reference's keys.
        ``index_traces`` is 0 and ``index_trace_counts`` is ``{}``: they
        count the reference's jitted lookup traces, and the port has no
        traces (its kernels count launches instead).  ``tier_routing`` is
        :func:`repro_torch.dist.tier_metrics`; ``tier`` the tier's own
        :meth:`metrics`, when the engine has one."""
        from repro_torch import obs
        from repro_torch.dist import tier_metrics

        lbl = dict(engine=self.name)
        obs.metric("serve_ticks").set_value(self.ticks, **lbl)
        obs.metric("serve_tokens_decoded").set_value(self.tokens_decoded, **lbl)
        obs.metric("serve_requests_finished").set_value(self.requests_finished, **lbl)
        obs.metric("serve_queued").set(len(self.queue), **lbl)
        obs.metric("serve_live_slots").set(sum(r is not None for r in self.slot_req), **lbl)
        snap = obs.snapshot()
        out = {
            "ticks": int(obs.sample_value(snap, "serve_ticks", **lbl)),
            "tokens_decoded": int(obs.sample_value(snap, "serve_tokens_decoded", **lbl)),
            "requests_finished": int(obs.sample_value(snap, "serve_requests_finished", **lbl)),
            "queued": int(obs.sample_value(snap, "serve_queued", **lbl)),
            "live_slots": int(obs.sample_value(snap, "serve_live_slots", **lbl)),
            "index_traces": 0,
            "index_trace_counts": {},
            "tier_routing": tier_metrics(),
        }
        if self.tier is not None:
            out["tier"] = self.tier.metrics()
        return out

    # -- device fns (methods, not bound methods kept on the instance: an
    # engine holds no reference cycle, so dropping it frees its cache) -----
    def _decode(self, params, cache, tokens, pos_per_slot):
        """One token for every slot, all at the largest slot position."""
        pos = int(np.max(pos_per_slot))
        return transformer.decode_step(params, cache, tokens, pos, self.cfg, self.ctx,
                                       max_seq=self.max_seq)

    def _prefill_tok(self, params, cache, tokens, pos):
        return transformer.decode_step(params, cache, tokens, pos, self.cfg, self.ctx,
                                       max_seq=self.max_seq)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.device)

    # -- engine ------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.b):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                # prefill: feed prompt tokens one step at a time into this
                # slot's cache rows (every row of the batch runs the step)
                for i, t in enumerate(req.prompt):
                    toks = np.zeros((self.b, 1), np.int32)
                    toks[slot, 0] = t
                    logits, self.cache = self._prefill_tok(
                        self.params, self.cache, self._tokens(toks), i
                    )
                self.slot_pos[slot] = len(req.prompt)
                nxt = int(torch.argmax(logits[slot]))
                req.out_tokens.append(nxt)

    def tick(self):
        """One continuous-batching step: admit, decode, retire (and let the
        tier, if any, act on accumulated drift first)."""
        if self.tier is not None:
            self.tier.maybe_compact()
            # skew-aware fence rebalancing: a no-op unless the tier's
            # policy enables it (rebalance_imbalance > 0)
            mr = getattr(self.tier, "maybe_rebalance", None)
            if mr is not None:
                mr()
        self._admit()
        live = [s for s in range(self.b) if self.slot_req[s] is not None]
        if not live:
            return False
        toks = np.zeros((self.b, 1), np.int32)
        for s in live:
            toks[s, 0] = self.slot_req[s].out_tokens[-1]
        logits, self.cache = self._decode(
            self.params, self.cache, self._tokens(toks), self.slot_pos.copy()
        )
        nxt = torch.argmax(logits, dim=1).cpu().numpy()
        self.ticks += 1
        for s in live:
            req = self.slot_req[s]
            req.out_tokens.append(int(nxt[s]))
            self.slot_pos[s] += 1
            self.tokens_decoded += 1
            if len(req.out_tokens) >= req.max_new_tokens or self.slot_pos[s] >= self.max_seq - 1:
                req.done = True
                self.requests_finished += 1
                self.slot_req[s] = None
        return True

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks
