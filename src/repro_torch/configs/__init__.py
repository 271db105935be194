"""Architecture configs: ``repro_torch.configs.get("<arch-id>")`` -> ArchSpec
(counterpart of ``repro.configs``).  The LM and recsys families are
ported; the GNN id raises ``KeyError`` until its slice."""

from . import archs  # noqa: F401  (registers the ported archs)
from .base import LM_SHAPES, RECSYS_SHAPES, ArchSpec, ShapeCell, get, list_archs

__all__ = ["archs", "ArchSpec", "LM_SHAPES", "RECSYS_SHAPES", "ShapeCell", "get", "list_archs"]
