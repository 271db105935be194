"""Serving (counterpart of ``repro.serve``): the continuous-batching
decode engine.  ``kvcache.PagedPool`` and ``hotcache`` wait for their
slices."""

from .engine import DecodeEngine, Request

__all__ = ["DecodeEngine", "Request"]
