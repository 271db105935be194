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
made once, here.  One card, no sharding context.  The reference's
``serve_*`` publishing into the metrics registry (ported as
:mod:`repro_torch.obs`) and its ``tier=`` hook (a
:class:`~repro_torch.tune.TunedTier` driven from the engine's ticks) wait
for the port of the serving layer's hot-key cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer


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
    attention on the hand-written kernel."""

    def __init__(self, params, cfg, *, batch_slots: int = 8, max_seq: int = 512,
                 tier=None):
        if tier is not None:
            raise NotImplementedError("tier= waits for the port of repro.tune.rebuild")
        self.cfg = cfg
        self.device = params["embed"].device
        self.params = transformer.cast_params(params, L.dtype_of(cfg.dtype))
        self.b = batch_slots
        self.max_seq = max_seq
        self.cache = transformer.init_cache(cfg, batch_slots, max_seq, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, dtype=np.int32)
        self.queue: List[Request] = []
        self._decode = self._decode_impl
        self._prefill_tok = self._prefill_one
        self.ticks = 0
        self.tokens_decoded = 0
        self.requests_finished = 0

    def metrics(self) -> dict:
        """The serving counters, as plain ints."""
        return {
            "ticks": int(self.ticks),
            "tokens_decoded": int(self.tokens_decoded),
            "requests_finished": int(self.requests_finished),
            "queued": len(self.queue),
            "live_slots": sum(r is not None for r in self.slot_req),
        }

    # -- device fns --------------------------------------------------------
    def _decode_impl(self, params, cache, tokens, pos_per_slot):
        """One token for every slot, all at the largest slot position."""
        pos = int(np.max(pos_per_slot))
        return transformer.decode_step(params, cache, tokens, pos, self.cfg)

    def _prefill_one(self, params, cache, tokens, pos):
        return transformer.decode_step(params, cache, tokens, pos, self.cfg)

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
        """One continuous-batching step: admit, decode, retire."""
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
