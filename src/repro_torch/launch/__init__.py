"""Launch side (counterpart of ``repro.launch``): ``steps`` builds each
serving cell's inputs and step function.  The reference's dry run, HLO
analysis, mesh helpers and training launcher wait for their slices."""

from . import steps

__all__ = ["steps"]
