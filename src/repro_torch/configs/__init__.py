"""Architecture configs: ``repro_torch.configs.get("<arch-id>")`` -> ArchSpec
(counterpart of ``repro.configs``).  The LM family is ported; the recsys
and GNN ids raise ``KeyError`` until their slice."""

from . import archs  # noqa: F401  (registers the ported archs)
from .base import LM_SHAPES, ArchSpec, ShapeCell, get, list_archs

__all__ = ["archs", "ArchSpec", "LM_SHAPES", "ShapeCell", "get", "list_archs"]
