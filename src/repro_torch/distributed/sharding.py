"""Mesh-aware sharding helpers (port of ``repro.distributed.sharding``):
partition specs → ``torch.distributed.tensor`` placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh`.

A :class:`PartitionSpec` is, as JAX's, one entry per tensor dimension:
``None`` (not sharded), a mesh axis name, or a tuple of axis names (the
dimension split over those axes together, the first one outermost).  On
a mesh it becomes one placement per mesh dimension — ``Shard(d)`` where
the spec names that mesh axis at tensor dimension ``d``, ``Replicate()``
elsewhere — which is what ``DTensor.from_local`` takes.  A tuple entry
must list its axes in the mesh's order (DTensor shards a dimension over
mesh dimensions outermost first).

``make_ctx`` (the model-parallel ``ShardingCtx``) belongs to the training
slice and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard


class PartitionSpec(tuple):
    """``PartitionSpec("data", None)``: one entry per tensor dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> List[Placement]:
    """The spec's placements on ``mesh``, one per mesh dimension."""
    names = tuple(mesh.mesh_dim_names or ())
    out: List[Placement] = [Replicate() for _ in names]
    used = set()
    for dim, entry in enumerate(spec):
        mesh_dims = []
        for axis in _entry_axes(entry):
            if axis not in names:
                raise ValueError(f"{spec} names axis {axis!r}; the mesh has "
                                 f"{names}")
            if axis in used:
                raise ValueError(f"{spec} names axis {axis!r} twice")
            used.add(axis)
            mesh_dims.append(names.index(axis))
        if mesh_dims != sorted(mesh_dims):
            raise ValueError(f"{spec}: a dimension's axes must be listed in "
                             f"the mesh's order {names}")
        for md in mesh_dims:
            out[md] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (JAX's ``NamedSharding``)."""
    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> List[Placement]:
        return placements(self.mesh, self.spec)


def batch_axes(mesh: DeviceMesh) -> tuple:
    """DP axes for activation batches: (pod, data) when both exist."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def all_axes(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _sanitize(mesh: DeviceMesh, spec: PartitionSpec) -> PartitionSpec:
    """Drop mesh axes a spec references that this mesh doesn't have."""
    names = set(mesh.mesh_dim_names)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None

    return PartitionSpec(*(fix(e) for e in spec))


def to_shardings(mesh: DeviceMesh, spec_tree: Any) -> Any:
    """PartitionSpec tree → NamedSharding tree for ``mesh`` (dicts, lists
    and tuples are walked; a PartitionSpec is a leaf)."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, _sanitize(mesh, spec_tree))
    if isinstance(spec_tree, dict):
        return {key: to_shardings(mesh, val)
                for key, val in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(to_shardings(mesh, s) for s in spec_tree)
    return spec_tree


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
