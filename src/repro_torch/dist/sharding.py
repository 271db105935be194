"""Logical-axis sharding contexts on ``torch.distributed`` (counterpart of
``repro.dist.sharding``).

Code talks in *logical* axes — ``dp`` (data parallel), ``fsdp``
(parameter shards), ``tp`` (tensor parallel), ``ep`` (expert parallel),
``edge`` (GNN edge shards), ``row`` (embedding-table rows) — and a
:class:`ShardingCtx` resolves them onto the physical dims of a
:class:`~torch.distributed.device_mesh.DeviceMesh` (``("data", "model")``
on one host, ``("pod", "data", "model")`` across pods).

Two profiles, as in the reference:

* ``tp_fsdp`` (LMs): dp/fsdp over the data-like dims, tp/ep over ``model``.
* ``flat_dp`` (recsys / GNN): every logical data axis flattens over the
  whole mesh; tp/ep are unused.

``edge`` and ``row`` always span the full mesh.

The context also gives the process group of a logical axis: the mesh's
own group of that dim, or, for a rule over several dims (``tp =
("data", "model")``), a group of the flattened sub-mesh built with
``dist.new_group``.  A rank's position in that group is its index along
the flattened axis (row-major over the rule's dims, as ``lax.axis_index``
counts).  The transport is whatever backend the caller's default group
has (gloo, NCCL): the context never picks one.  The reference's
``spec``/``sharding``/``constrain`` place model tensors and come with the
model-side port (ROADMAP queue 1, item 13.6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

PROFILES = ("tp_fsdp", "flat_dp")

# logical name -> which mesh dims (by preference) it may occupy
_DATA_AXES = ("pod", "data")
_MODEL_AXES = ("model",)


def _rules_for(profile: str, mesh_axes: tuple) -> dict:
    present = tuple(a for a in mesh_axes)
    data = tuple(a for a in _DATA_AXES if a in present)
    model = tuple(a for a in _MODEL_AXES if a in present)
    if profile == "tp_fsdp":
        rules = {"dp": data, "fsdp": data, "tp": model, "ep": model}
    elif profile == "flat_dp":
        rules = {"dp": present, "fsdp": present, "tp": (), "ep": ()}
    else:
        raise ValueError(f"unknown sharding profile {profile!r}; choose from {PROFILES}")
    rules["edge"] = present
    rules["row"] = present
    return rules


@dataclass
class ShardingCtx:
    """Resolves logical axis names against a ``DeviceMesh`` whose dims are
    named (``mesh_dim_names``).

    ``rules`` maps each logical name to a (possibly empty) tuple of mesh
    dim names; a bare string is one dim.  The process groups of
    :meth:`axes_group` are built at first use, which every rank of the
    mesh must reach together (``dist.new_group`` is collective).
    """

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    profile: str = "tp_fsdp"
    rules: dict = field(default_factory=dict)
    _groups: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if not self.rules:
            self.rules = _rules_for(self.profile, tuple(self.mesh.mesh_dim_names))
        # a bare string ("model") is one mesh dim, not its characters
        self.rules = {
            k: ((v,) if isinstance(v, str) else tuple(v or ())) for k, v in self.rules.items()
        }

    def mesh_axes(self, logical: str) -> tuple:
        """Mesh dim names a logical axis resolves to (possibly empty)."""
        return tuple(self.rules.get(logical, ()))

    def n(self, logical: str) -> int:
        """Number of shards a logical axis resolves to (1 if unmapped): the
        product over every mesh dim it occupies, size-1 dims included.  A
        rule that names a dim absent from this mesh raises."""
        names = tuple(self.mesh.mesh_dim_names)
        shape = tuple(self.mesh.mesh.shape)
        out = 1
        for a in self.mesh_axes(logical):
            if a not in names:
                raise ValueError(
                    f"logical axis {logical!r} resolves to mesh axis {a!r}, "
                    f"which is not on this mesh (axes: {names})"
                )
            out *= int(shape[names.index(a)])
        return out

    def axes_group(self, axes: tuple) -> tuple:
        """``(group, index)`` of this rank's sub-mesh over the mesh dims
        ``axes``: its process group and this rank's position along the
        flattened axis.  ``(None, 0)`` for no dims."""
        axes = tuple(axes or ())
        if not axes:
            return None, 0
        if axes not in self._groups:
            self._groups[axes] = self._build_group(axes)
        return self._groups[axes]

    def group(self, logical: str):
        """The process group of a logical axis (None when unmapped)."""
        return self.axes_group(self.mesh_axes(logical))[0]

    def index(self, logical: str) -> int:
        """This rank's position along a logical axis (0 when unmapped)."""
        return self.axes_group(self.mesh_axes(logical))[1]

    def _build_group(self, axes: tuple) -> tuple:
        names = tuple(self.mesh.mesh_dim_names)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} is not on this mesh (axes: {names})")
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh")
        grid = self.mesh.mesh
        dims = [names.index(a) for a in axes]
        others = [d for d in range(grid.dim()) if d not in dims]
        # one row per sub-mesh: the other dims' coordinates row-major, the
        # rule's dims flattened in the rule's order
        rows = grid.permute(*others, *dims).reshape(-1, math.prod(grid.shape[d] for d in dims))
        mine = 0
        for d in others:
            mine = mine * grid.shape[d] + coord[d]
        for row in rows.tolist():
            if row != sorted(row):
                raise ValueError(
                    f"the sub-mesh over {axes} holds ranks {row} out of order: a group's "
                    "ranks must increase along the flattened axis"
                )
        member = rows[mine].tolist()
        index = member.index(dist.get_rank())
        if len(axes) == 1:
            return self.mesh.get_group(axes[0]), index
        # every rank creates every sub-mesh's group, in the same order
        groups = [dist.new_group(row) for row in rows.tolist()]
        return groups[mine], index


def single_device_ctx(profile: str = "tp_fsdp", *, device=None) -> ShardingCtx:
    """A ``(1, 1)`` ``("data", "model")`` mesh of this process alone, on
    ``device`` (default: the card).  The caller's default process group
    must hold one rank."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized() or dist.get_world_size() != 1:
        raise ValueError("single_device_ctx needs an initialised default process group of 1 rank")
    dev = resolve_device(device)
    mesh = DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int), mesh_dim_names=("data", "model"))
    return ShardingCtx(mesh=mesh, profile=profile)
