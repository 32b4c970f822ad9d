"""Embedding bag (multi-hot gather + reduce): the hand-written CUDA kernel
(``csrc/embedding_bag.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.embedding_bag.embedding_bag``
(``_bag_kernel``): a (V, D) table and (B, L) ids, where an id < 0 is
padding, give (B, D) bags in the table's dtype — the sum of the valid rows
accumulated in f32 in l order, or for ``combiner="mean"`` that sum divided
by max(count, 1).  The kernel and :func:`embedding_bag_plain` take the
same order of sums, so they agree bit for bit.

Ids ≥ V lie outside the contract (the TPU kernel would DMA past the
table; the oracle's indexing clamps).  On the card the wrapper counts
them with a small check launch before the bag launch, copies that count
to pinned host memory, enqueues the bag launch and then waits for the
count alone (not for the bags), and raises ``ValueError``.  The bag
kernel never reads past the table either: it skips such an id and adds
it to the same counter.  The plain version raises on them too.

The bag launch follows a plan (:func:`plan`): the width of the words a
row is read in, and either the slot kernel (a warp's lanes on 32 slots
of one bag of narrow rows at a time) or the warp kernel (a warp's lanes
on the words of one bag's rows, with a ring of slots in flight a lane).
Its route — ``"slots"`` or ``"warp"`` — is counted in
``embedding_bag.routes``.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back.
On a meta tensor (a dry run, ``launch/dryrun.py``) it returns meta
outputs and hands :func:`work` to the run's counter, launching and
counting nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading

import torch

from repro_torch.kernels import _build

COMBINERS = ("sum", "mean")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ID_BITS = {torch.int32: 32, torch.int64: 64}
ROUTES = ("warp", "slots")
# slots in flight a lane for bags longer than 4, and the widest row (in
# words) of the slot kernel: the kernel's own constants
DEPTH = _build.source_constant("embedding_bag", "DEPTH")
SLOT_WORDS = _build.source_constant("embedding_bag", "SLOT_WORDS")


def _check(table: torch.Tensor, indices: torch.Tensor, combiner: str):
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"need a (V, D) table and (B, L) ids, got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if indices.device != table.device:
        raise ValueError("table and ids must be on one device")
    if indices.dtype not in _ID_BITS:
        raise TypeError(f"ids must be int32 or int64, got {indices.dtype}")


def _out_of_range(n_bad: int, n_rows: int):
    return ValueError(f"{n_bad} id(s) ≥ the table's {n_rows} rows: outside "
                      f"the embedding bag's contract")


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor, *,
                        combiner: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: one gathered (B, D) row block per slot l,
    added in f32 in order l = 0..L−1 where the id is valid (a padded slot
    leaves the sum as it is), the mean divided by max(count, 1), cast to
    the table's dtype.  Runs on any device; ids ≥ V raise."""
    _check(table, indices, combiner)
    n_rows = table.shape[0]
    ids = indices.long()
    n_bad = int((ids >= n_rows).sum())
    if n_bad:
        raise _out_of_range(n_bad, n_rows)
    b, bag_len = ids.shape
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    count = torch.zeros((b, 1), dtype=torch.float32, device=table.device)
    for slot in range(bag_len):
        valid = (ids[:, slot] >= 0)[:, None]
        rows = table[ids[:, slot].clamp_min(0)].float()
        acc = torch.where(valid, acc + rows, acc)
        count = count + valid.float()
    if combiner == "mean":
        acc = acc / count.clamp_min(1.0)
    return acc.to(table.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the bag kernel covers a launch (see ``csrc/embedding_bag.cu``):
    rows are read in words of ``word_bytes``; one warp owns one bag.  With
    ``slots`` its lanes take 32 slots of the bag at a time (route
    ``"slots"``); otherwise they take the words of its rows and each keeps
    ``depth`` slots in flight (route ``"warp"``)."""
    word_bytes: int
    depth: int
    slots: bool = False

    @property
    def route(self) -> str:
        return "slots" if self.slots else "warp"


@functools.lru_cache(maxsize=1024)
def plan(dim: int, elem_bytes: int, bag_len: int, align: int = 16) -> Plan:
    """The launch plan for bags of L = ``bag_len`` slots over rows of
    D = ``dim`` elements of ``elem_bytes``, with the table and output
    aligned to ``align`` bytes: the widest word of at most 16 bytes that
    divides a row and the alignment; the slot kernel for a row of at most
    ``SLOT_WORDS`` words; ``DEPTH`` slots in flight a lane, or 4 / 1 for
    bags of at most 4 / 1 slots (fewer registers, more warps resident)."""
    row = dim * elem_bytes
    word = 16
    while word > elem_bytes and (row % word or align % word):
        word //= 2
    depth = next(p for p in (1, 4, DEPTH) if p >= min(bag_len, DEPTH))
    return Plan(word, depth, row // word <= SLOT_WORDS)


def _align(*tensors) -> int:
    """The largest power of two ≤ 16 that divides every tensor's
    address."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _on(device: torch.device):
    """``device`` made current for a launch, unless it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/embedding_bag.cu``) with the argument
    types of its entry points set."""
    fn, checked = lib.repro_embedding_bag, lib.repro_embedding_bag_checked
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        bag = [p, ll, ll, p, i, ll, ll, i, p, p, i, i, i, i]
        fn.argtypes = bag + [p]
        checked.argtypes = bag + [p, p, p]
        fn.restype = checked.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("embedding_bag"))


_host = threading.local()


def _count_slot(device: torch.device):
    """This thread's pinned int32 that the id check's count is copied to
    on ``device``, a numpy view of it, and the event recorded after the
    copy (one each a thread and device: a call waits for its own copy
    before it returns, so the next call may reuse them)."""
    slots = _host.__dict__.setdefault("slots", {})
    if device.index not in slots:
        count = torch.zeros((1,), dtype=torch.int32, pin_memory=True)
        counted = torch.cuda.Event()
        counted.record()                   # creates the event on device
        slots[device.index] = (count, count.numpy(), counted)
    return slots[device.index]


def work(table: torch.Tensor, indices: torch.Tensor, *,
         distinct: int | None = None, n_valid: int | None = None):
    """(operations, bytes) of one call, as ``PERF.md``'s bound for kernel 9
    counts them: each distinct row read once, the (B, L) ids read and the
    (B, D) bags written once; one operation a valid id and column.
    ``distinct`` and ``n_valid`` depend on the data; without them every
    id counts as valid and distinct (up to V rows)."""
    b, bag_len = indices.shape
    n_rows, dim = table.shape
    n_valid = b * bag_len if n_valid is None else n_valid
    distinct = min(n_valid, n_rows) if distinct is None else distinct
    return (float(n_valid * dim),
            float((distinct * dim + b * dim) * table.element_size()
                  + b * bag_len * indices.element_size()))


def _launch(table, indices, n_bad, combiner, how, counted=None):
    b, bag_len = indices.shape
    n_rows, dim = table.shape
    out = torch.empty((b, dim), dtype=table.dtype, device=table.device)
    if not out.numel():
        return out
    if how is None:
        how = plan(dim, table.element_size(), bag_len, _align(table, out))
    args = (table.data_ptr(), n_rows, dim, indices.data_ptr(),
            _ID_BITS[indices.dtype], b, bag_len, int(combiner == "mean"),
            out.data_ptr(), n_bad.data_ptr(), _DTYPES[table.dtype],
            how.word_bytes, int(how.slots), how.depth)
    stream = torch.cuda.current_stream().cuda_stream
    if counted is None:
        status = _lib().repro_embedding_bag(*args, stream)
    else:
        count, event = counted
        status = _lib().repro_embedding_bag_checked(
            *args, count.data_ptr(), event.cuda_event, stream)
    _build.check(status, "embedding_bag")
    embedding_bag.launches += 1
    embedding_bag.routes[how.route] += 1
    return out


def launch(table: torch.Tensor, indices: torch.Tensor, n_bad: torch.Tensor,
           *, combiner: str = "sum", how: Plan | None = None
           ) -> torch.Tensor:
    """Launch the bag kernel on CUDA tensors (checked by
    :func:`embedding_bag`) with the plan ``how`` (default :func:`plan`'s)
    and add one to ``embedding_bag.launches`` and to the plan's route in
    ``embedding_bag.routes``; ids ≥ V are skipped and added to the int32
    device counter ``n_bad``, which nothing reads here, so nothing waits
    for the launch.  :func:`embedding_bag` is the entry point; this is
    its launch alone, which ``chip_smoke.py`` times."""
    with _on(table.device):
        return _launch(table, indices, n_bad, combiner, how)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  combiner: str = "sum") -> torch.Tensor:
    """(V, D) table × (B, L) ids (−1 = padding) → (B, D) bags in the
    table's dtype (see the module docstring).

    CUDA tensors (an f32 or bf16 contiguous table, contiguous int32 or
    int64 ids), in one call into the library: count the ids ≥ V on the
    current stream and copy the count to pinned host memory, launch the
    bag kernel (one added to ``embedding_bag.launches`` and to its
    route), then wait for the count alone and raise ``ValueError`` if it
    is not 0; the bags may still be running when this returns.  CPU
    tensors run the plain version.
    """
    _check(table, indices, combiner)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, indices, combiner=combiner)
    if table.device.type == "meta":
        _build.meta_call("embedding_bag", work(table, indices))
        return torch.empty((indices.shape[0], table.shape[1]),
                           dtype=table.dtype, device=table.device)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be f32 or bf16, got {table.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    n_bad = torch.empty((1,), dtype=torch.int32, device=table.device)
    with _on(table.device):
        count, seen, counted = _count_slot(table.device)
        seen[0] = 0                  # stays 0 if nothing is launched
        out = _launch(table, indices, n_bad, combiner, None, (count, counted))
    if seen[0]:
        raise _out_of_range(int(seen[0]), table.shape[0])
    return out


embedding_bag.launches = 0
embedding_bag.routes = dict.fromkeys(ROUTES, 0)
