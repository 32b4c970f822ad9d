"""Per-rank op cost model of one step (counterpart of
``repro.launch.hlo_cost``).

The reference re-derives per-device costs from compiled HLO text.  The
port runs the step itself, eagerly, on meta tensors (shapes and dtypes,
no data), under :class:`OpCounter`, a ``TorchDispatchMode`` that sees
every aten op that this rank executes, and counts by the reference's
rules (``hlo_cost.py:1-22``):

* ``flops``: matmul-like ops 2·|out|·K by ``torch.utils.flop_counter``'s
  registered formulas (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, attention, ...), also summed alone as ``matmul_flops``;
  every other op |out| (elementwise, reductions, copies, gathers,
  scatters, sorts), except views, allocations (``empty``), ``detach``
  and other metadata ops, which cost nothing (the reference's
  ``_ZERO_COST``);
* ``bytes``: the operand bytes plus the output bytes of each counted op;
* ``collectives``: each collective's output bytes and count by type
  (all-reduce, all-gather, reduce-scatter, all-to-all, send/recv,
  broadcast), whether made by ``torch.distributed`` (the port's
  ``distributed/collectives.py``, the engines' rings, the embedding
  exchange) or by DTensor's own redistributions (whose ops reach the
  counter after DTensor has turned them into local ops and collectives);
  ``collective_bytes_total`` sums them;
* ``peak_bytes``: the peak of live storage bytes during the step, each
  storage rounded up to the caching allocator's 512-byte blocks and
  released by a finalizer when its last tensor goes (the inputs' storages
  live from the start); ``temp_bytes`` the peak less those inputs' blocks;
  ``argument_bytes`` and ``output_bytes``: the exact bytes of the storages
  of the step's inputs (parameters, their compute copies, optimizer
  state, batch, cache) and of its outputs.  Together they stand for the
  reference's ``compiled.memory_analysis()``.

The reference's ``unknown_trip_count_loops`` has no counterpart: an
eager loop dispatches each of its iterations, so every layer, µbatch and
ring step is counted as it runs.

A hand kernel (``repro_torch.kernels``) on meta tensors returns outputs of
its shapes and dtypes, with the workspaces it would allocate, and hands
this counter its work: one op whose operations and bytes are the
kernel module's ``work(...)`` (the count that ``PERF.md``'s bound column
divides), added to ``flops`` and ``bytes`` and listed under ``kernels``.
Its plain version's arithmetic is not counted.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

# the caching allocator hands out blocks in multiples of 512 bytes
BLOCK = 512

aten = torch.ops.aten
_ZERO_COST = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten.set_, aten.resize_, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten._unsafe_view,
}

# collective op name → (type, where its outputs are: "out" the op's
# return value, an int the positional argument holding them)
_COLLECTIVES = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_coalesced_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d.alltoall_": ("all-to-all", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "c10d.send": ("send/recv", 0),
    "c10d.recv_": ("send/recv", 0),
    "c10d.recv_any_source_": ("send/recv", 0),
    "c10d.broadcast_": ("broadcast", 0),
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                          "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional.broadcast": ("broadcast", "out"),
}
# waits, barriers and the like: no work of their own
_NO_WORK_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor", "profiler")


def _tensors(x):
    """Every tensor in a (nested) argument or output."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def state_tensors(obj, seen=None):
    """Every tensor that ``obj`` holds: a tensor, a (nested) dict / list /
    tuple, or an object with a ``__dict__`` (a model: its parameters,
    buffers and attributes such as a compute copy), recursively.  A
    DTensor stands for its local shard."""
    from torch.distributed.tensor import DTensor
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, DTensor):
        yield obj.to_local()
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from state_tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from state_tensors(v, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        yield from state_tensors(vars(obj), seen)


def storage_bytes(tensors, blocks: bool = False) -> int:
    """The bytes of the distinct storages of ``tensors``; with ``blocks``
    each rounded up to the allocator's block."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += _block(st.nbytes()) if blocks else st.nbytes()
    return total


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    entry_bytes: int = 0      # the inputs' blocks, live at the start

    def as_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["collective_bytes"] = {k: v["bytes"]
                                   for k, v in self.collectives.items()}
        out["collective_bytes_total"] = float(sum(
            v["bytes"] for v in self.collectives.values()))
        out["memory"] = {"argument_bytes": self.argument_bytes,
                         "output_bytes": self.output_bytes,
                         "temp_bytes": self.peak_bytes - self.entry_bytes,
                         "peak_bytes": self.peak_bytes}
        return out


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter(arguments):``
    into :attr:`cost` (see the module docstring).  ``arguments``: what the
    step reads (a model, optimizer state, batch, cache; any nesting), whose
    storages are live at entry; :meth:`outputs` records the step's
    outputs."""

    def __init__(self, arguments=()):
        super().__init__()
        self.cost = Cost()
        self._live: Dict[int, int] = {}
        self._arguments = arguments
        self._now = 0
        self._depth = 0

    # -- live storages ------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = _block(st.nbytes())
        self._live[key] = n
        self._now += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def __enter__(self):
        if not self._depth:
            args = list(state_tensors(self._arguments))
            self.cost.argument_bytes = storage_bytes(args)
            for t in args:
                self._track(t)
            self.cost.entry_bytes = self._now
            _build.META_LISTENERS.append(self._kernel)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _build.META_LISTENERS.remove(self._kernel)
        return super().__exit__(*exc)

    def outputs(self, tree) -> None:
        self.cost.output_bytes = storage_bytes(state_tensors(tree))

    # -- counting -----------------------------------------------------------

    def _kernel(self, name: str, operations: float, n_bytes: float) -> None:
        k = self.cost.kernels.setdefault(
            name, {"calls": 0, "operations": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["operations"] += operations
        k["bytes"] += n_bytes
        self.cost.flops += operations
        self.cost.bytes += n_bytes
        self.cost.ops += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its local ops and collectives then
            # come back through this mode, as one rank executes them
            return NotImplemented
        # a composite op reaches this mode whole where autograd is off
        # (inference mode): count the ops it is made of, as it runs them
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = f"{func.namespace}.{func._opname}"
        coll = _COLLECTIVES.get(name)
        in_bytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if coll is not None:
            kind, where = coll
            got = out if where == "out" else args[where]
            n = float(sum(_nbytes(t) for t in _tensors(got)))
            c = self.cost.collectives.setdefault(kind,
                                                 {"count": 0, "bytes": 0.0})
            c["count"] += 1
            c["bytes"] += n
            self.cost.bytes += n + in_bytes
            self.cost.ops += 1
            return
        if func.namespace in _NO_WORK_NAMESPACES:
            return
        packet = func.overloadpacket
        if packet in _ZERO_COST or getattr(func, "is_view", False):
            return
        outs = list(_tensors(out))
        out_elems = sum(t.numel() for t in outs)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.cost.matmul_flops += f
        else:
            f = float(out_elems)
        self.cost.flops += f
        self.cost.bytes += in_bytes + sum(_nbytes(t) for t in outs)
        self.cost.ops += 1


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """The counterpart of ``hlo_cost.analyze``: the counted costs of
    ``fn(*args, **kwargs)``, its arguments live from the start, as a dict
    (``flops``, ``bytes``, ``collective_bytes`` by type,
    ``collective_bytes_total``, with ``matmul_flops``, ``kernels``,
    ``collectives`` with counts, and ``memory``)."""
    with OpCounter((args, kwargs)) as counter:
        counter.outputs(fn(*args, **kwargs))
    return counter.cost.as_dict()

