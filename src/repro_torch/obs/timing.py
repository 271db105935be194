"""Spans, stopwatches, and the latency-histogram lookup wrapper
(counterpart of ``repro.obs.timing``).

* :func:`span` — ``with span("name"):`` records host wall-time into the
  ``span_us`` histogram (host-side observe: nothing runs on the card).
  When ``REPRO_PROFILE=<dir>`` is set, the *outermost* span also brackets
  its body with ``torch.profiler.profile`` and exports a Chrome trace of
  it (host ops and, on a card, the CUDA kernels) into that directory.
* :func:`stopwatch` — the sanctioned way to take a wall-clock delta in
  ``src/repro_torch/`` (no raw ``time.perf_counter()`` subtraction
  outside ``repro_torch.obs``): ``sw = stopwatch(); ...; sw.elapsed``
  seconds.
* :func:`timed_lookup` — wraps any ``.lookup(...)`` target (``Index``,
  ``BatchedIndexes``, ``TunedTier``) and records BOTH the host time until
  the call returns and the time until its output is ready on the card
  (``torch.cuda.synchronize``) into the ``lookup_latency_us`` histogram,
  labeled (kind, backend, tier, phase), through one host-side
  :meth:`~repro_torch.obs.registry.Histogram.observe_groups`: it adds no
  launch to the card.
"""

from __future__ import annotations

import itertools
import os
import time
from contextlib import contextmanager

from . import registry as _registry

__all__ = ["Stopwatch", "span", "stopwatch", "timed_lookup"]


class Stopwatch:
    """Monotonic wall-clock delta without raw ``perf_counter`` math."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter()

    def restart(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def elapsed(self) -> float:
        """Seconds since construction / the last :meth:`restart`."""
        return time.perf_counter() - self._t0

    def __enter__(self) -> "Stopwatch":
        self.restart()
        return self

    def __exit__(self, *exc) -> None:
        pass


def stopwatch() -> Stopwatch:
    return Stopwatch()


_SPAN_DEPTH = 0  # outermost-span detection for the profiler bracket
_TRACE_IDS = itertools.count()  # one trace file per profiled outermost span


def _start_profile():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, prof_dir: str, name: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(prof_dir, exist_ok=True)
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in name)
    prof.export_chrome_trace(
        os.path.join(prof_dir, f"{safe}.{os.getpid()}.{next(_TRACE_IDS)}.trace.json")
    )


@contextmanager
def span(name: str, *, registry: "_registry.Registry | None" = None):
    """Record the block's host wall-time into ``span_us{name=...}``.

    Nested spans each record their own time; only the outermost span
    runs the optional ``torch.profiler`` bracket (``REPRO_PROFILE=<dir>``),
    so a profiled serving step yields one coherent trace file rather than
    one per nested span.
    """
    global _SPAN_DEPTH
    reg = registry or _registry.default_registry()
    prof_dir = os.environ.get("REPRO_PROFILE")
    prof = _start_profile() if prof_dir and _SPAN_DEPTH == 0 else None
    _SPAN_DEPTH += 1
    sw = Stopwatch()
    try:
        yield sw
    finally:
        elapsed_us = sw.elapsed * 1e6
        _SPAN_DEPTH -= 1
        if prof is not None:
            _stop_profile(prof, prof_dir, name)
        reg.metric("span_us").observe(elapsed_us, name=name)


def _target_kind(target) -> str:
    kind = getattr(target, "kind", None)
    if kind is None:
        kind = getattr(getattr(target, "spec", None), "kind", "?")
    return str(kind)


def _target_backend(target, kw: dict) -> str:
    be = kw.get("backend")
    if be is None:
        be = getattr(getattr(target, "policy", None), "backend", None)
    return str(be or "kernel")


def _out_device(out):
    """The CUDA device of the lookup's output, or None (a CPU result)."""
    import torch

    if torch.is_tensor(out) and out.is_cuda:
        return out.device
    return None


def timed_lookup(target, *args, tier: str = "-", registry=None, **kw):
    """``target.lookup(*args, **kw)`` + latency histograms.

    Records two phases into ``lookup_latency_us``:

    * ``phase=host`` — wall time until the call returns (the kernels may
      still run on the card);
    * ``phase=device`` — wall time until the output is ready: after
      ``torch.cuda.synchronize(device)`` when it lies on a card, the same
      instant as ``host`` for a CPU result.

    Both land through one :meth:`Histogram.observe_groups` call on the
    host; the backend label defaults to the port's ``"kernel"``.
    """
    import torch

    labels = dict(
        kind=_target_kind(target), backend=_target_backend(target, kw), tier=str(tier)
    )
    sw = Stopwatch()
    out = target.lookup(*args, **kw)
    host_us = sw.elapsed * 1e6
    dev = _out_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    device_us = sw.elapsed * 1e6
    reg = registry or _registry.default_registry()
    reg.metric("lookup_latency_us").observe_groups(
        [
            ({**labels, "phase": "host"}, [host_us]),
            ({**labels, "phase": "device"}, [device_us]),
        ]
    )
    return out
