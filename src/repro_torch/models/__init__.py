"""Models (counterpart of ``repro.models``): the decoder-only LM's serving
side (``transformer``, dense and MoE) over the shared ``layers`` and the
one-card MoE block (``moe``)."""

from . import layers, moe, transformer

__all__ = ["layers", "moe", "transformer"]
