"""Embedding bag (multi-hot gather + reduce): the hand-written CUDA kernel
(``csrc/embedding_bag.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.embedding_bag.embedding_bag``
(``_bag_kernel``): a (V, D) table and (B, L) ids, where an id < 0 is
padding, give (B, D) bags in the table's dtype — the sum of the valid rows
accumulated in f32 in l order, or for ``combiner="mean"`` that sum divided
by max(count, 1).  The kernel and :func:`embedding_bag_plain` take the
same order of sums, so they agree bit for bit.

Ids ≥ V lie outside the contract (the TPU kernel would DMA past the
table; the oracle's indexing clamps).  The kernel never reads past the
table: it skips such an id and counts it into a one-int device counter,
and the wrapper reads that counter after the launch — one device-to-host
copy, which waits for the launch — and raises ``ValueError``.  The plain
version raises on them too.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

COMBINERS = ("sum", "mean")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ID_BITS = {torch.int32: 32, torch.int64: 64}


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


def _lib():
    lib = _build.load("embedding_bag")
    fn = lib.repro_embedding_bag
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, p, i, ll, ll, i, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def launch(table: torch.Tensor, indices: torch.Tensor, n_bad: torch.Tensor,
           *, combiner: str = "sum") -> torch.Tensor:
    """Launch the kernel on CUDA tensors (checked by :func:`embedding_bag`)
    and add one to ``embedding_bag.launches``; ids ≥ V are added to the
    int32 device counter ``n_bad``, which nothing reads here, so nothing
    waits for the launch.  :func:`embedding_bag` is the entry point;
    this is its launch alone, which ``chip_smoke.py`` times."""
    b, bag_len = indices.shape
    n_rows, dim = table.shape
    out = torch.empty((b, dim), dtype=table.dtype, device=table.device)
    if not out.numel():
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib()(table.data_ptr(), n_rows, dim, indices.data_ptr(),
                        _ID_BITS[indices.dtype], b, bag_len,
                        int(combiner == "mean"), out.data_ptr(),
                        n_bad.data_ptr(), _DTYPES[table.dtype], stream)
    _build.check(status, "embedding_bag")
    embedding_bag.launches += 1
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  combiner: str = "sum") -> torch.Tensor:
    """(V, D) table × (B, L) ids (−1 = padding) → (B, D) bags in the
    table's dtype (see the module docstring).

    CUDA tensors (an f32 or bf16 contiguous table, contiguous int32 or
    int64 ids) launch the kernel on the current stream and add one to
    ``embedding_bag.launches``, then read the out-of-range count (which
    waits for the launch) and raise ``ValueError`` if an id is ≥ V.  CPU
    tensors run the plain version.
    """
    _check(table, indices, combiner)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, indices, combiner=combiner)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be f32 or bf16, got {table.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    n_bad = torch.zeros((1,), dtype=torch.int32, device=table.device)
    out = launch(table, indices, n_bad, combiner=combiner)
    bad = int(n_bad.item())
    if bad:
        raise _out_of_range(bad, table.shape[0])
    return out


embedding_bag.launches = 0
