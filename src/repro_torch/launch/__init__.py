"""Launch side (counterpart of ``repro.launch``): ``steps`` builds each
cell's inputs, step function and sharding trees; ``mesh`` the production
meshes; ``dryrun`` sizes a cell on fake tensors and ``roofline_report``
renders its tables; ``python -m repro_torch.launch.train`` trains an
architecture through the fault-tolerant loop, on one rank or under
``torchrun``.  The reference's ``hlo_analysis`` has no counterpart: eager
PyTorch has no HLO (``dryrun``'s docstring)."""

from . import mesh, steps

__all__ = ["mesh", "steps"]
