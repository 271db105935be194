"""Launch side (counterpart of ``repro.launch``): ``steps`` builds each
cell's inputs and step function; ``python -m repro_torch.launch.train``
trains an architecture through the fault-tolerant loop.  The reference's
dry run, HLO analysis and mesh helpers wait for the launch slice."""

from . import steps

__all__ = ["steps"]
