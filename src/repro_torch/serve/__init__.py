"""Serving (counterpart of ``repro.serve``): the continuous-batching
decode engine, the paged KV cache with its learned-index page table, and
the learned hot-key cache."""

from . import engine, hotcache, kvcache
from .engine import DecodeEngine, Request
from .hotcache import HotKeyCache, KeySketch
from .kvcache import ContiguousCache, PagedPool

__all__ = ["ContiguousCache", "DecodeEngine", "HotKeyCache", "KeySketch", "PagedPool", "Request",
           "engine", "hotcache", "kvcache"]
