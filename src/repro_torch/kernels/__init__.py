"""The hand-written CUDA kernels and their plain PyTorch twins
(counterpart of ``repro.kernels``).

Each search kernel module holds a wrapper (``kary_search``,
``rmi_search``, ``pgm_search``, ``rs_search``) and its batched
counterpart (``batched_*``, one launch for a stack of tables) that check
their operands, launch the CUDA kernel on CUDA tensors (counting launches
in the module's ``LAUNCHES`` and ``BATCHED_LAUNCHES``) and run the twin
(``_kary_body``, ``_rmi_body``, ``_pgm_body``, ``_rs_body`` and their
``_batched_*_body``) on CPU tensors.  ``decode_attention`` (the LM
serving path's attention, twin ``_decode_body``) and ``embedding_bag``
(twin ``_bag_body``) have no batched variant and count ``LAUNCHES`` only,
as does ``corridor_scan`` (the device fits' sequential corridor
recurrence, which takes a stack of rows: ``corridor_scan``, twin
``corridor_scan_twin``, and the exact form ``corridor_scan_exact``, twin
``corridor_scan_exact_twin``, counted in ``LAUNCHES`` and on its own in
``EXACT_LAUNCHES``, reported as ``corridor_scan_exact``).
The library is built from ``csrc/`` at first use
(:mod:`repro_torch.kernels.cuda_lib`); nothing builds at import.
"""

from . import (
    corridor_scan, cuda_lib, decode_attention, embedding_bag, kary_search, ops, pgm_search, ref,
    rmi_search, rs_search,
)

#: the kernel modules whose ``LAUNCHES`` count the main path's launches
KERNEL_MODULES = (kary_search, rmi_search, pgm_search, rs_search, decode_attention, embedding_bag,
                  corridor_scan)


def reset_launches() -> None:
    for mod in KERNEL_MODULES:
        mod.LAUNCHES = 0
        for extra in ("BATCHED_LAUNCHES", "EXACT_LAUNCHES"):
            if hasattr(mod, extra):
                setattr(mod, extra, 0)


def launches() -> dict:
    """Kernel name -> launches since the last reset: ``<module>`` counts
    the single-table kernel, ``batched_<module>`` the batched one;
    ``corridor_scan`` counts both forms and ``corridor_scan_exact`` the
    exact form alone."""
    out = {}
    for mod in KERNEL_MODULES:
        name = mod.__name__.rsplit(".", 1)[-1]
        out[name] = mod.LAUNCHES
        if hasattr(mod, "BATCHED_LAUNCHES"):
            out[f"batched_{name}"] = mod.BATCHED_LAUNCHES
        if hasattr(mod, "EXACT_LAUNCHES"):
            out[f"{name}_exact"] = mod.EXACT_LAUNCHES
    return out


__all__ = ["corridor_scan", "cuda_lib", "decode_attention", "embedding_bag", "kary_search", "ops", "pgm_search",
           "ref", "rmi_search", "rs_search", "KERNEL_MODULES", "reset_launches", "launches"]
