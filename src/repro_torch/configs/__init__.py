"""Architecture configs: ``repro_torch.configs.get("<arch-id>")`` -> ArchSpec
(counterpart of ``repro.configs``): the LM, GNN and recsys families."""

from . import archs  # noqa: F401  (registers the ported archs)
from .base import LM_SHAPES, RECSYS_SHAPES, ArchSpec, ShapeCell, get, gnn_shapes, list_archs

__all__ = ["archs", "ArchSpec", "LM_SHAPES", "RECSYS_SHAPES", "ShapeCell", "get", "gnn_shapes",
           "list_archs"]
