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

``make_ctx`` builds the ``ShardingCtx`` (``repro_torch.models.common``)
that the models thread through their forwards on a mesh; ``distribute``
places a tree of whole tensors (the same on every rank) on a mesh as
DTensors by a ``NamedSharding`` tree, each rank keeping its own slice.
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


def make_ctx(mesh: DeviceMesh, *, dp_over_all: bool = False):
    """The ShardingCtx the models thread through their forwards (reference
    ``sharding.py:22``).  ``dp_over_all`` is the recsys layout: pure data
    parallelism over every mesh axis (the embedding tables are
    model-parallel through their own exchange, the dense nets replicate
    and split the batch over every rank)."""
    from repro_torch.models.common import ShardingCtx
    return ShardingCtx(
        batch=all_axes(mesh) if dp_over_all else batch_axes(mesh),
        model="model" if "model" in mesh.mesh_dim_names else None,
        fsdp="data" if "data" in mesh.mesh_dim_names else None,
        enabled=True, mesh=mesh)


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


def _local_slice(x, mesh: DeviceMesh, pl: List[Placement]):
    """This rank's slice of ``x`` under placements ``pl``: each mesh
    dimension that shards a tensor dimension splits it, outermost first,
    into ``torch.chunk``'s pieces — DTensor's layout."""
    coord = mesh.get_coordinate()
    for md, p in enumerate(pl):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(md), dim=p.dim)[coord[md]]
    return x


def distribute(tree: Any, shardings: Any) -> Any:
    """A tree of whole tensors (the same values on every rank, on the
    mesh's device type) → DTensors on ``shardings``' meshes (a matching
    tree of ``NamedSharding``), each rank keeping a copy of its own slice;
    no collective runs."""
    from torch.distributed.tensor import DTensor
    if isinstance(shardings, NamedSharding):
        local = _local_slice(tree, shardings.mesh,
                             shardings.placements).contiguous().clone()
        return DTensor.from_local(local, shardings.mesh,
                                  shardings.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if isinstance(tree, dict):
        return {key: distribute(val, shardings[key])
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(val, sh)
                          for val, sh in zip(tree, shardings))
    return tree


def reduce_gradients(params: Any, shardings: Any, axes) -> None:
    """The data-parallel reduction of a train step: each leaf's ``.grad``
    (this rank's gradient of its share of the loss) summed over the axes
    of ``axes`` that its sharding's spec does not name.  An axis the spec
    names was summed already, by the backward of the leaf's gather over
    it (the LM's FSDP) or of the exchange (the sharded table block)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.checkpoint import tree_flatten
    for leaf, sh in zip(tree_flatten(params), tree_flatten(shardings)):
        named = {a for entry in sh.spec for a in _entry_axes(entry)}
        rest = tuple(a for a in _entry_axes(axes) if a not in named)
        if leaf.grad is not None and rest:
            leaf.grad = coll.all_reduce_sum(leaf.grad, sh.mesh, rest)
