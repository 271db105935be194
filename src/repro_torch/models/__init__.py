"""Models (counterpart of ``repro.models``): the dense decoder-only LM's
serving side (``transformer``) over the shared ``layers``."""

from . import layers, transformer

__all__ = ["layers", "transformer"]
