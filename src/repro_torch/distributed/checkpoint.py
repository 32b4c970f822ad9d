"""Sharded checkpointing with atomic commit: the reference's on-disk layout
(``repro.distributed.checkpoint``), written and read without JAX.

Layout:  <dir>/step_<n>/
           manifest.json            — tree structure, shapes, dtypes, step
           shard_<i>.msgpack.zst    — one leaf each: a msgpack map
                                      {"i", "data", "dtype", "shape"},
                                      zstd-compressed when ``zstandard``
                                      is importable, raw otherwise
           COMMITTED                — written last; restore ignores
                                      directories without it

Writes go to ``.tmp_step_<n>`` and the directory is renamed once
``COMMITTED`` is in it, so a failure mid-write never corrupts the latest
good checkpoint.  ``AsyncCheckpointer`` snapshots the tree to host memory
on the caller's thread and persists it on a background thread.

The two packages read each other's checkpoints bit for bit:

* leaves are numbered in JAX's flatten order — dict keys sorted, lists
  and tuples in order, and ``None`` or an empty dict adding no leaf
  (:func:`tree_flatten`);
* each shard is a msgpack map byte-identical to ``msgpack.packb`` with
  its defaults (:func:`pack_record`), so the port needs no ``msgpack``;
* the manifest's per-leaf ``dtype`` is what the reference writes,
  ``str(jnp.asarray(x).dtype)`` with 64-bit types narrowed to 32 bits;
  the shard holds the real dtype, and ``restore`` reads only the
  shard's.  ``treedef`` is a readable structure string nothing reads.

Leaves are stored whole (unsharded), so a checkpoint written on any mesh
restores onto any other: :func:`restore` hands back numpy arrays, or,
given ``shardings`` (a tree of
:class:`repro_torch.distributed.sharding.NamedSharding`, as
``to_shardings`` makes), one ``DTensor`` a leaf built from this rank's
slice alone — every rank reads the committed leaves and keeps the slice
its placements name, so no collective runs.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

try:                                     # optional: fall back to uncompressed
    import zstandard
except ImportError:
    zstandard = None

_FLAG = "COMMITTED"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# what jnp.asarray(x).dtype is for a 64-bit x with JAX's 64-bit mode off
_MANIFEST_X32 = {"int64": "int32", "uint64": "uint32",
                 "float64": "float32", "complex128": "complex64"}


def _compress(payload: bytes) -> bytes:
    if zstandard is None:
        return payload
    return zstandard.ZstdCompressor(level=3).compress(payload)


def _decompress(raw: bytes) -> bytes:
    """Shards self-describe: zstd frames start with the zstd magic number."""
    if not raw.startswith(_ZSTD_MAGIC):
        return raw
    if zstandard is None:
        raise ImportError(
            "checkpoint shard is zstd-compressed but the 'zstandard' package "
            "is not installed (pip install zstandard)")
    return zstandard.ZstdDecompressor().decompress(raw)


# -- the tree: JAX's flatten order --------------------------------------------

def tree_flatten(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in JAX's ``tree_flatten`` order: dict keys
    sorted, lists and tuples in order; ``None`` and empty containers add
    no leaf; anything else is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_flatten(
            tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_flatten(sub)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The structure of ``like`` with its leaves replaced, in
    :func:`tree_flatten` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    return build(like)


def _treedef_repr(tree: Any) -> str:
    """Readable structure string, ``*`` for a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_treedef_repr(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef_repr(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef_repr(x) for x in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host array: a tensor is detached and copied off its
    device, anything else goes through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# -- the shard payload: msgpack's encoding of one record ----------------------

def _pack_uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative int {n} in a checkpoint record")
    if n < 0x80:
        return bytes((n,))
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes((0xA0 | n,)) + b
    if n <= 0xFF:
        return b"\xd9" + struct.pack(">B", n) + b
    if n <= 0xFFFF:
        return b"\xda" + struct.pack(">H", n) + b
    return b"\xdb" + struct.pack(">I", n) + b


def _pack_bin(b: bytes) -> bytes:
    n = len(b)
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n) + b
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n) + b
    return b"\xc6" + struct.pack(">I", n) + b


def _pack_array_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x90 | n,))
    if n <= 0xFFFF:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def pack_record(i: int, arr: np.ndarray) -> bytes:
    """One shard's payload, byte-identical to ``msgpack.packb({"i": i,
    "data": arr.tobytes(), "dtype": str(arr.dtype), "shape":
    list(arr.shape)})`` with msgpack's defaults (``use_bin_type``)."""
    return b"".join((
        b"\x84",                                   # fixmap, 4 entries
        _pack_str("i"), _pack_uint(int(i)),
        _pack_str("data"), _pack_bin(arr.tobytes()),
        _pack_str("dtype"), _pack_str(str(arr.dtype)),
        _pack_str("shape"), _pack_array_header(arr.ndim),
        *(_pack_uint(int(d)) for d in arr.shape)))


class _Reader:
    """Decoder for the msgpack types a record holds: a fixmap, arrays,
    strings, binaries and non-negative ints."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.raw[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated checkpoint record")
        self.pos += n
        return out

    def uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",           # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",           # str
                 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",  # uint
                 0xDC: ">H", 0xDD: ">I"}                       # array
        if t not in sizes:
            raise ValueError(f"unsupported msgpack type 0x{t:02x} in a "
                             "checkpoint record")
        n = self.uint(sizes[t])
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if t in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if t in (0xDC, 0xDD):
            return [self.value() for _ in range(n)]
        return n

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpack_record(raw: bytes) -> dict:
    """Inverse of :func:`pack_record` (reads ``msgpack.packb``'s bytes of
    the same record too)."""
    r = _Reader(raw)
    out = r.value()
    if r.pos != len(raw) or not isinstance(out, dict):
        raise ValueError("malformed checkpoint record")
    return out


# -- save / restore ------------------------------------------------------------

def _manifest_leaf(arr: np.ndarray) -> dict:
    name = str(arr.dtype)
    return {"shape": list(arr.shape), "dtype": _MANIFEST_X32.get(name, name)}


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any) -> Path:
    """Synchronous sharded save with atomic commit."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = [_host(x) for x in tree_flatten(tree)]
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": _treedef_repr(tree),
                "leaves": [_manifest_leaf(x) for x in leaves]}
    for i, arr in enumerate(leaves):
        (tmp / f"shard_{i:05d}.msgpack.zst").write_bytes(
            _compress(pack_record(i, arr)))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / _FLAG).write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


class AsyncCheckpointer:
    """Snapshot-on-call, persist-on-thread checkpointing."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, tree: Any):
        self.wait()                       # one outstanding write at a time
        # the snapshot is taken here, on the caller's thread: a device
        # tensor updated in place after this call cannot reach the writer
        snapshot = tree_unflatten(tree, [_host(x).copy()
                                         for x in tree_flatten(tree)])

        def work():
            try:
                save(self.dir, step, snapshot)
                self._gc()
            except Exception as e:        # surfaced on next wait()
                # reprolint: disable=lock-discipline -- single outstanding writer; wait() joins the thread before reading, which is a happens-before edge
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best = None
    for d in sorted(ckpt_dir.glob("step_*")):
        if (d / _FLAG).exists():
            best = int(d.name.split("_")[1])
    return best


def read_shard(path: str | os.PathLike) -> Tuple[dict, bytes]:
    """``(record, payload)`` of one shard file: the decoded record and its
    uncompressed msgpack bytes."""
    payload = _decompress(Path(path).read_bytes())
    return unpack_record(payload), payload


def _local_slice(arr: np.ndarray, mesh, placements) -> np.ndarray:
    """This rank's slice of ``arr`` under ``placements``: each mesh
    dimension that shards a tensor dimension splits it, outermost first,
    into ``torch.chunk``'s pieces (ceil-sized, the last ones short or
    empty) — DTensor's layout."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for md, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        size, n = arr.shape[pl.dim], mesh.size(md)
        step = -(-size // n)
        lo = min(coord[md] * step, size)
        index = [slice(None)] * arr.ndim
        index[pl.dim] = slice(lo, min(lo + step, size))
        arr = arr[tuple(index)]
    return arr


def _place(arr: np.ndarray, sharding):
    """``arr`` as a DTensor on ``sharding``'s mesh, from this rank's
    slice (on the mesh's device type; no collective)."""
    from torch.distributed.tensor import DTensor
    mesh, placements = sharding.mesh, sharding.placements
    local = torch.as_tensor(np.array(_local_slice(arr, mesh, placements),
                                     order="C"), device=mesh.device_type)
    full = torch.empty(arr.shape, dtype=local.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def restore(ckpt_dir: str | os.PathLike, step: int, like: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (values ignored): numpy
    arrays, or with ``shardings`` (a tree of ``NamedSharding`` matching
    ``like``) DTensors holding this rank's slices."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / _FLAG).exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    n = len(tree_flatten(like))
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest["n_leaves"] != n:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves; "
                         f"target tree has {n}")
    out = []
    for i in range(n):
        rec, _ = read_shard(d / f"shard_{i:05d}.msgpack.zst")
        out.append(np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(
            rec["shape"]))
    if shardings is not None:
        placed = tree_flatten(shardings)
        if len(placed) != n:
            raise ValueError(f"{len(placed)} shardings for {n} leaves")
        out = [_place(arr, sh) for arr, sh in zip(out, placed)]
    return tree_unflatten(like, out)
