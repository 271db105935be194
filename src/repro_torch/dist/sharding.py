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
has (gloo, NCCL): the context never picks one.

Placement, as the reference's ``spec``/``sharding``/``constrain``:
:meth:`ShardingCtx.spec` gives each dim's mesh axes (``None``, one name or
a tuple), :meth:`ShardingCtx.sharding` a :class:`NamedSharding` (mesh +
spec) with ``shard_shape`` and, on a live mesh, the ``DTensor``
placements, and :meth:`ShardingCtx.constrain` returns a plain tensor as it
is (eager PyTorch propagates no sharding, and the reference's constraint
never changes a value) and redistributes a ``DTensor``.

Placing a state (the LM family under ``tp_fsdp``): :func:`fit_sharding`
drops a dim's mesh axes until they divide it, as the reference's;
:func:`shard_state` cuts a whole state into this rank's blocks
(``launch.steps.state_shardings`` through :func:`fit_sharding`), and
:func:`gather_state` puts the blocks back together over the groups.

A mesh may also be an :class:`AbstractMesh`: axis names and sizes with no
process group behind it, for the sharding trees and the dry run.  Its
``group``/``index`` raise, unless it carries a :class:`CommLedger` (the
dry run's): then it stands for the mesh's first rank, and its groups are
:class:`CountingGroup` s that the collective helpers answer with tensors of
the right shape while counting the bytes each rank would move.
"""

from __future__ import annotations

import copy
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


class CommLedger:
    """Bytes a rank would move, by collective kind, under the reference's
    ring accounting (``repro/launch/dryrun.py:62-70``): an all-reduce
    moves twice its result, an all-gather its result, a reduce-scatter its
    operand, an all-to-all its result (the port makes no
    collective-permute: its count stays 0).  ``count`` the calls by kind."""

    KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

    def __init__(self):
        self.bytes = {k: 0 for k in self.KINDS}
        self.count = {k: 0 for k in self.KINDS}

    def add(self, kind: str, n_bytes: int) -> None:
        self.bytes[kind] += int(n_bytes)
        self.count[kind] += 1

    def summary(self) -> dict:
        out = dict(self.bytes)
        out.update({f"n_{k}": v for k, v in self.count.items()})
        out["total"] = sum(self.bytes.values())
        return out


@dataclass(frozen=True)
class CountingGroup:
    """The group of ``size`` ranks along some axes of an abstract mesh with
    a ledger: the collective helpers record into ``ledger`` and return
    tensors of the shape the real collective would."""

    size: int
    ledger: CommLedger


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh that only names its axes and their sizes (the reference's
    ``jax.sharding.AbstractMesh``).  With a ``ledger`` it stands for its
    first rank in the dry run."""

    axis_sizes: tuple
    axis_names: tuple
    ledger: CommLedger | None = field(default=None, compare=False)

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axis_names(mesh) -> tuple:
    """A mesh's axis names, live (``DeviceMesh.mesh_dim_names``) or abstract."""
    if isinstance(mesh, AbstractMesh):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a live or abstract mesh (the reference's
    ``mesh.shape``)."""
    sizes = mesh.axis_sizes if isinstance(mesh, AbstractMesh) else tuple(mesh.mesh.shape)
    return dict(zip(mesh_axis_names(mesh), (int(x) for x in sizes)))


class PartitionSpec(tuple):
    """Per-dim mesh-axis entries (``None``, one axis name, or a tuple of
    names), as ``jax.sharding.PartitionSpec`` holds them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec` (``jax.sharding.NamedSharding``):
    dim ``i`` is split over the product of the sizes of ``spec[i]``'s
    axes, row-major in the entry's order; dims past the spec are whole."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        """One rank's block of a ``shape`` array.  A dim that the product of
        its axes does not divide raises ``ValueError``, as JAX's does."""
        sizes = mesh_shape(self.mesh)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        out = list(shape)
        for i, entry in enumerate(self.spec):
            parts = math.prod(sizes[a] for a in _entry_axes(entry))
            if out[i] % parts:
                raise ValueError(f"sharding {self.spec} splits dim {i} of {tuple(shape)} "
                                 f"{parts} ways, which does not divide {out[i]}")
            out[i] //= parts
        return tuple(out)

    @property
    def placements(self) -> tuple:
        """The ``torch.distributed.tensor`` placement of each mesh dim:
        ``Shard(i)`` where the mesh axis splits tensor dim ``i``, else
        ``Replicate()``.  A tuple entry must name its axes in mesh order
        (``DTensor`` splits over mesh dims left to right)."""
        from torch.distributed.tensor import Replicate, Shard

        names = mesh_axis_names(self.mesh)
        out = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
            for p in pos:
                out[p] = Shard(i)
        return tuple(out)

    def local_block(self, x, coordinate):
        """The block of the whole array ``x`` that the rank at mesh
        ``coordinate`` holds (a view)."""
        sizes = mesh_shape(self.mesh)
        names = mesh_axis_names(self.mesh)
        block = self.shard_shape(tuple(x.shape))
        for i, entry in enumerate(self.spec):
            idx = 0
            for a in _entry_axes(entry):
                idx = idx * sizes[a] + int(coordinate[names.index(a)])
            x = x.narrow(i, idx * block[i], block[i])
        return x


@dataclass
class ShardingCtx:
    """Resolves logical axis names against a ``DeviceMesh`` whose dims are
    named (``mesh_dim_names``), or an :class:`AbstractMesh`.

    ``rules`` maps each logical name to a (possibly empty) tuple of mesh
    dim names; a bare string is one dim.  The process groups of
    :meth:`axes_group` are built at first use, which every rank of the
    mesh must reach together (``dist.new_group`` is collective).

    ``local_batch`` says how a train step feeds the model: False (the
    default, the reference's global view) means every rank passes the
    same whole batch and gets the whole answer; True means each rank
    passes its own slice of the batch along ``dp`` (:meth:`local_view`),
    and the row-sharded lookups answer each rank's own ids.
    """

    mesh: object  # DeviceMesh or AbstractMesh
    profile: str = "tp_fsdp"
    rules: dict = field(default_factory=dict)
    local_batch: bool = False
    _groups: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if not self.rules:
            self.rules = _rules_for(self.profile, mesh_axis_names(self.mesh))
        # a bare string ("model") is one mesh dim, not its characters
        self.rules = {
            k: ((v,) if isinstance(v, str) else tuple(v or ())) for k, v in self.rules.items()
        }

    @property
    def abstract(self) -> bool:
        """True on an :class:`AbstractMesh` (no process group behind it)."""
        return isinstance(self.mesh, AbstractMesh)

    def local_view(self) -> "ShardingCtx":
        """This context with ``local_batch`` on, sharing its groups."""
        out = copy.copy(self)
        out.local_batch = True
        return out

    # -- placement ----------------------------------------------------------
    def _resolve(self, logical):
        if logical is None:
            return None
        if isinstance(logical, tuple):  # already-flat tuple of logical names
            axes = []
            for lg in logical:
                axes.extend(_entry_axes(self._resolve(lg)))
            if not axes:
                return None
            return axes[0] if len(axes) == 1 else tuple(axes)
        ax = self.rules.get(logical, ())
        if not ax:
            return None
        return ax[0] if len(ax) == 1 else tuple(ax)

    def spec(self, *logical) -> PartitionSpec:
        """Each dim's mesh axes, as the reference's ``_resolve`` builds them."""
        return PartitionSpec(*[self._resolve(lg) for lg in logical])

    def sharding(self, *logical) -> NamedSharding:
        """The :class:`NamedSharding` of a value whose dims carry these
        logical axes."""
        return NamedSharding(self.mesh, self.spec(*logical))

    def constrain(self, x, *logical):
        """The reference's ``with_sharding_constraint``: a plain tensor comes
        back as it is (eager PyTorch has no sharding to propagate, and the
        constraint changes no value); a ``DTensor`` is redistributed to the
        placements of ``logical``."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.sharding(*logical).placements)
        return x

    # -- sizes and groups -----------------------------------------------------
    def mesh_axes(self, logical: str) -> tuple:
        """Mesh dim names a logical axis resolves to (possibly empty)."""
        return tuple(self.rules.get(logical, ()))

    def n(self, logical: str) -> int:
        """Number of shards a logical axis resolves to (1 if unmapped): the
        product over every mesh dim it occupies, size-1 dims included.  A
        rule that names a dim absent from this mesh raises."""
        sizes = mesh_shape(self.mesh)
        out = 1
        for a in self.mesh_axes(logical):
            if a not in sizes:
                raise ValueError(
                    f"logical axis {logical!r} resolves to mesh axis {a!r}, "
                    f"which is not on this mesh (axes: {tuple(sizes)})"
                )
            out *= sizes[a]
        return out

    def axes_group(self, axes: tuple) -> tuple:
        """``(group, index)`` of this rank's sub-mesh over the mesh dims
        ``axes``: its process group and this rank's position along the
        flattened axis.  ``(None, 0)`` for no dims.  On an abstract mesh
        with a ledger: a :class:`CountingGroup` and 0; without one, raises."""
        axes = tuple(axes or ())
        if not axes:
            return None, 0
        if self.abstract:
            if self.mesh.ledger is None:
                raise ValueError("an abstract mesh has no process groups")
            sizes = mesh_shape(self.mesh)
            return CountingGroup(math.prod(sizes[a] for a in axes), self.mesh.ledger), 0
        if axes not in self._groups:
            self._groups[axes] = self._build_group(axes)
        return self._groups[axes]

    def group(self, logical: str):
        """The process group of a logical axis (None when unmapped)."""
        return self.axes_group(self.mesh_axes(logical))[0]

    def index(self, logical: str) -> int:
        """This rank's position along a logical axis (0 when unmapped)."""
        return self.axes_group(self.mesh_axes(logical))[1]

    def coordinate(self) -> tuple:
        """This rank's coordinate on the mesh (all zeros on the dry run's
        abstract mesh)."""
        if self.abstract:
            if self.mesh.ledger is None:
                raise ValueError("an abstract mesh has no ranks")
            return (0,) * len(self.mesh.axis_names)
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh")
        return tuple(coord)

    def _build_group(self, axes: tuple) -> tuple:
        names = tuple(self.mesh.mesh_dim_names)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} is not on this mesh (axes: {names})")
        coord = self.coordinate()
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


def fit_sharding(shape, sharding, mesh):
    """Drop mesh axes per dim until the dim size divides evenly (the
    reference's ``jit`` in_shardings need exact divisibility; published
    vocab/batch sizes such as 151,936 and 10^6 do not always divide 256
    or 512): each dim falls back to the largest prefix of its axis tuple
    that does.  Only the mesh's axis sizes are read."""
    sizes = mesh_shape(mesh)
    new = []
    for i, entry in enumerate(sharding.spec):
        if entry is None:
            new.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if shape[i] % prod == 0:
                break
            axes = axes[:-1]
        if not axes:
            new.append(None)
        elif len(axes) == 1:
            new.append(axes[0])
        else:
            new.append(tuple(axes))
    return NamedSharding(mesh, PartitionSpec(*new))


def split_axes(sharding: NamedSharding) -> tuple:
    """The mesh axes of more than one rank that split some dim of a leaf
    placed by ``sharding``, in mesh order (those over which its ranks hold
    different blocks)."""
    used = {a for entry in sharding.spec for a in _entry_axes(entry)}
    sizes = mesh_shape(sharding.mesh)
    return tuple(a for a in mesh_axis_names(sharding.mesh) if a in used and sizes[a] > 1)


def placed_shardings(whole, ctx: ShardingCtx, family: str):
    """The fitted :class:`NamedSharding` of each leaf of a whole state or
    parameter tree (leaves: anything with ``.shape``), as the reference
    places it: ``launch.steps.state_shardings`` through
    :func:`fit_sharding`."""
    from repro_torch import tree
    from repro_torch.launch.steps import state_shardings

    shard = state_shardings(whole, family, ctx)
    return tree.unflatten(whole, [fit_sharding(tuple(t.shape), s, ctx.mesh) for t, s in zip(
        tree.leaves(whole), tree.flatten_up_to(whole, shard))])


def shard_state(whole, ctx: ShardingCtx, family: str, *, device=None):
    """This rank's blocks of a whole state (or parameter tree): each leaf's
    block under :func:`placed_shardings` at this rank's mesh coordinate, a
    contiguous copy (on ``device``, default the leaf's own), so the whole
    leaf can be freed.  Leaves may be tensors or numpy arrays (the
    reference's state as ``jax.tree.map(np.asarray, state)`` gives it,
    bfloat16 included: ``tree.from_numpy``)."""
    import numpy as np

    from repro_torch import tree

    leaves = [tree.from_numpy(t, "cpu") if isinstance(t, np.ndarray) else t
              for t in tree.leaves(whole)]
    whole = tree.unflatten(whole, leaves)
    coord = ctx.coordinate()
    out = []
    for t, s in zip(leaves, tree.flatten_up_to(whole, placed_shardings(whole, ctx, family))):
        block = s.local_block(t, coord)
        out.append(block.to(device or t.device, copy=True).contiguous())
    return tree.unflatten(whole, out)


def gather_state(local, ctx: ShardingCtx, family: str, whole, *, device="cpu"):
    """The whole state from this rank's blocks (:func:`shard_state`'s
    inverse), on every rank of the mesh together: each split dim
    all-gathered over the group of its axes.  ``whole`` is a matching tree
    whose leaves give the whole shapes (meta tensors, arrays): a block's
    shape alone does not say whether a dim fell back to replication.
    On a gloo group the blocks travel as host tensors (gloo crashes
    gathering a ``DTensor`` held on the card); the result is on
    ``device`` (the host by default)."""
    from repro_torch import tree
    from repro_torch.dist import collectives

    sizes = mesh_shape(ctx.mesh)
    leaves = tree.leaves(local)
    shards = tree.flatten_up_to(local, placed_shardings(whole, ctx, family))
    out = []
    for t, w, s in zip(leaves, tree.leaves(whole), shards):
        if tuple(s.shard_shape(tuple(w.shape))) != tuple(t.shape):
            raise ValueError(f"a block of shape {tuple(t.shape)} is not this rank's block of a "
                             f"{tuple(w.shape)} leaf under {s.spec}")
        split = [tuple(a for a in _entry_axes(e) if sizes[a] > 1) for e in s.spec]
        x = t.detach()
        if any(_gloo(ctx, axes) for axes in split):
            x = x.cpu()
        for i, axes in enumerate(split):
            x = collectives.all_gather_dim(x, axes, ctx, i)
        out.append(x.to(device))
    return tree.unflatten(local, out)


@dataclass
class StatePlacement:
    """A placed state's layout: its context, family and a tree of its
    whole leaves (anything with ``.shape``, e.g. meta tensors), for
    :func:`gather_state`, :func:`shard_state` and placed checkpoints."""

    ctx: ShardingCtx
    family: str
    whole: object

    def gather(self, local, *, device="cpu"):
        return gather_state(local, self.ctx, self.family, self.whole, device=device)

    def shard(self, whole, *, device=None):
        return shard_state(whole, self.ctx, self.family, device=device)

    def shardings(self) -> list:
        """The fitted :class:`NamedSharding` of each leaf, flattened order."""
        from repro_torch import tree

        return tree.leaves(placed_shardings(self.whole, self.ctx, self.family))


def _gloo(ctx: ShardingCtx, axes: tuple) -> bool:
    """Whether the group over ``axes`` is a gloo group (None: no group)."""
    if not axes or ctx.abstract:
        return False
    return dist.get_backend(ctx.axes_group(axes)[0]) == "gloo"


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
