"""Production meshes (counterpart of ``repro.launch.mesh``).

``make_production_mesh`` is a function: importing this module touches no
device or process-group state.  The single-pod mesh is (16, 16) = 256
ranks ``("data", "model")``; the multi-pod mesh is (2, 16, 16) = 512
ranks with a leading ``"pod"`` axis (dp/fsdp compose over ``("pod",
"data")``).  Each is a live ``DeviceMesh`` (``init_device_mesh``) when
the default process group has exactly that many ranks, and an
:class:`~repro_torch.dist.sharding.AbstractMesh` of the same axes and
sizes otherwise (the sharding trees and the dry run need only those).
"""

from __future__ import annotations


def _mesh(shape: tuple, axes: tuple, device_type: str | None):
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import AbstractMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == n:
        from torch.distributed.device_mesh import init_device_mesh

        dev = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
        return init_device_mesh(dev, shape, mesh_dim_names=axes)
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``; live when the world has that many
    ranks (on ``device_type``, default the card when there is one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str | None = None):
    """A small mesh for multi-rank tests: live when the world has
    ``prod(shape)`` ranks, abstract otherwise."""
    return _mesh(shape, axes, device_type)
