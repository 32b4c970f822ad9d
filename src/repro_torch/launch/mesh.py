"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, with the reference's axis names.
Single pod: (16, 16) = 256 ranks, axes (data, model).  Multi-pod:
(2, 16, 16) = 512 ranks with the leading ``pod`` axis as outer data
parallelism.  The production shapes need that many ranks and raise
``ValueError`` on any other world size.

The mesh's device type follows the group's backend: NCCL serves CUDA
tensors and gloo CPU tensors, and the sharded code keeps every tensor it
hands a collective on the mesh's device type.  When no default group is
initialised, :func:`init_default_group` creates a one-rank group over a
``FileStore`` in a temporary directory — NCCL for ``device="cuda"``,
gloo for ``"cpu"`` — and destroys it at exit.  An initialised group
whose backend does not serve the asked device is an error: the card
never falls back to gloo.

A dry run (``launch/dryrun.py``) asks for ``device="meta"`` by name: its
mesh is over the ``"fake"`` backend's group, which the dry run creates
itself (``torch.testing._internal.distributed.fake_pg``, any world size,
collectives that move nothing).  This module never creates a fake group,
and only a meta device is served by one.  Such a mesh has the CPU's
device type (DTensor's sharding rules need a device type with a device
count) and holds meta tensors.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

# every process group of the port: a hung collective fails in a minute
GROUP_TIMEOUT = timedelta(seconds=60)
_BACKEND = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


def _destroy_own_group(group, store_dir: str) -> None:
    """atexit hook: destroy the one-rank group this module created (if it
    is still the default group) and remove its store's directory."""
    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


def backends(name: str) -> set:
    """The backends a group's backend string names: ``"nccl"`` → {nccl};
    ``"cpu:fake,meta:fake"`` (the dry run's group) → {fake}."""
    return {part.split(":")[-1] for part in name.split(",")}


def init_default_group(device="cuda") -> str:
    """Make sure a default process group serves ``device``; returns the
    mesh device type (``"cuda"`` or ``"cpu"``; ``"cpu"`` for ``"meta"``,
    whose group must be an existing fake one).

    With no group initialised, a one-rank group is created over a
    ``FileStore`` in a fresh temporary directory (no network): NCCL for
    CUDA, gloo for the CPU.  An initialised group must have the backend
    of ``device``'s type, else ``ValueError``."""
    dev = resolve_device(device, allow_meta=True)
    want = _BACKEND[dev.type]
    if not dist.is_initialized() and dev.type == "meta":
        raise ValueError("a meta mesh needs the dry run's fake process "
                         "group, initialised by the caller")
    if not dist.is_initialized():
        store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store = dist.FileStore(os.path.join(store_dir, "store"), 1)
        if dev.type == "cuda":       # the rank's card, before NCCL binds
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group(want, store=store, rank=0, world_size=1,
                                timeout=GROUP_TIMEOUT)
        atexit.register(_destroy_own_group, dist.group.WORLD, store_dir)
    have = dist.get_backend()
    if backends(have) != {want}:
        raise ValueError(
            f"the default process group's backend is {have!r}, which does "
            f"not serve {dev.type} tensors (want {want!r})")
    return "cpu" if dev.type == "meta" else dev.type


def _mesh(shape, axes, device) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the default group, in rank
    order; the world size must equal the mesh's size."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"a {shape} mesh needs {need} ranks; the default "
                         f"process group has {world}")
    device_type = init_default_group(device)
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over axes (data, model), or (2, 16, 16) over (pod, data,
    model) with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_flat_mesh(*, multi_pod: bool = False, axis: str = "data",
                   device="cuda"):
    """The production ranks as one ring — the CF engines' 1-axis view."""
    return _mesh((512 if multi_pod else 256,), (axis,), device)


def make_local_mesh(shape=None, axes=None, *, device="cuda"):
    """A mesh over every rank of the default group (creating a one-rank
    group when none is initialised): one ``"data"`` axis by default, or
    ``shape`` over ``axes``; ``axes`` alone names the one axis."""
    if shape is None:
        world = (dist.get_world_size() if dist.is_initialized() else 1)
        shape, axes = (world,), tuple(axes or ("data",))
    return _mesh(shape, axes, device)
