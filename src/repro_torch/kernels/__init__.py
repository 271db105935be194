"""The hand-written CUDA search kernels and their plain PyTorch twins
(counterpart of ``repro.kernels``).

Each kernel module holds a wrapper (``kary_search``, ``rmi_search``,
``pgm_search``) that checks its operands, launches the CUDA kernel on
CUDA tensors (counting launches in the module's ``LAUNCHES``) and runs
the twin (``_kary_body``, ``_rmi_body``, ``_pgm_body``) on CPU tensors.
The library is built from ``csrc/`` at first use
(:mod:`repro_torch.kernels.cuda_lib`); nothing builds at import.
"""

from . import cuda_lib, kary_search, ops, pgm_search, ref, rmi_search

#: the kernel modules whose ``LAUNCHES`` count the main path's launches
KERNEL_MODULES = (kary_search, rmi_search, pgm_search)


def reset_launches() -> None:
    for mod in KERNEL_MODULES:
        mod.LAUNCHES = 0


def launches() -> dict:
    """Kernel module name -> launches since the last reset."""
    return {mod.__name__.rsplit(".", 1)[-1]: mod.LAUNCHES for mod in KERNEL_MODULES}


__all__ = ["cuda_lib", "kary_search", "ops", "pgm_search", "ref", "rmi_search",
           "KERNEL_MODULES", "reset_launches", "launches"]
