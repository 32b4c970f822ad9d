"""Fused tile predictor: the hand-written CUDA kernel (``csrc/predict.cu``)
and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.predict.fused_tile_predict``
(``_predict_kernel``).  The GPU form gathers inside the kernel: it reads
the rating matrix by neighbor id over the item range ``[lo, hi)``, so the
(m, k, T) neighbor tile is never materialised, and a caller can cover the
whole item range in one launch.  The plain version is the same gather
followed by ``repro_torch.core.predict._tile_predict``, whose k-reduction
runs in the kernel's order — the two agree bit for bit.

Two routes on the card, chosen from the source's dtype and counted in
``fused_tile_predict.routes``: ``"int8"`` (the int8 gather source: each
thread owns 16 items of a row, read as one 16-byte load per neighbor row)
and ``"f32"`` (f32 ratings, e.g. half stars: one thread per item).

On a CPU tensor the wrapper runs the plain version and counts nothing; on
a CUDA tensor it launches the kernel or raises — it never falls back.
On a meta tensor (a dry run, ``launch/dryrun.py``) it returns meta
outputs and hands :func:`work` to the run's counter, launching and
counting nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.int8: 1}
ROUTES = ("int8", "f32")


def tile_predict_plain(src: torch.Tensor, ids: torch.Tensor,
                       w: torch.Tensor, nb_means: torch.Tensor,
                       q_means: torch.Tensor, lo: int, hi: int
                       ) -> torch.Tensor:
    """Plain PyTorch version: gather the (m, k, T) tile, then the
    ordered-k tile predictor."""
    from repro_torch.core.predict import _tile_predict
    nbr = src[:, lo:hi][ids.long()].float()
    return _tile_predict(w, nbr, nb_means, q_means)


def work(src: torch.Tensor, ids: torch.Tensor, lo: int, hi: int, *,
         rows_read: int | None = None, terms: int | None = None):
    """(operations, bytes) of one call, as ``PERF.md``'s bound for kernel 2
    counts them: each distinct neighbor row's ``[lo, hi)`` read once (at
    ``src``'s width), the ids, weights and neighbor means (4 bytes each a
    slot), the query means and the f32 output once; 4 operations a rated
    (neighbor, item) term under a nonzero weight and 5 an output for the
    epilogue.  ``rows_read`` and ``terms`` depend on the data; without
    them every gathered row and element counts (min(m·k, U) rows, m·k·T
    terms), the most a call can need."""
    m, k = ids.shape
    t = hi - lo
    rows_read = min(m * k, src.shape[0]) if rows_read is None else rows_read
    terms = m * k * t if terms is None else terms
    return (4.0 * terms + 5.0 * m * t,
            float(rows_read * t * src.element_size() + m * k * 4 * 3
                  + m * 4 + m * t * 4))


def _lib():
    lib = _build.load("predict")
    fn = lib.repro_tile_predict
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def fused_tile_predict(src: torch.Tensor, ids: torch.Tensor,
                       w: torch.Tensor, nb_means: torch.Tensor,
                       q_means: torch.Tensor, lo: int, hi: int
                       ) -> torch.Tensor:
    """(m, hi − lo) f32 predictions for items ``[lo, hi)``.

    ``src``: (U, I) gather source, int8 or f32 (``make_gather_source``);
    ``ids``: (m, k) int32 neighbor ids, already clipped into [0, U);
    ``w``: (m, k) masked weights (invalid neighbors at 0); ``nb_means``:
    (m, k) neighbor means; ``q_means``: (m,) query means.  CUDA tensors
    launch the kernel on the current stream (output from ``torch.empty``,
    no synchronisation) and add one to ``fused_tile_predict.launches`` and
    to the route's entry of ``fused_tile_predict.routes`` (``"int8"`` for
    an int8 source, ``"f32"`` for f32); CPU tensors run the plain version.
    """
    if src.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"need (U, I) src and (m, k) ids, got "
                         f"{tuple(src.shape)} and {tuple(ids.shape)}")
    m, k = ids.shape
    if w.shape != (m, k) or nb_means.shape != (m, k) \
            or q_means.shape != (m,):
        raise ValueError(f"w/nb_means must be {(m, k)} and q_means {(m,)}, "
                         f"got {tuple(w.shape)}, {tuple(nb_means.shape)}, "
                         f"{tuple(q_means.shape)}")
    if not 0 <= lo < hi <= src.shape[1]:
        raise ValueError(f"bad item range [{lo}, {hi}) for {src.shape[1]} "
                         f"items")
    tensors = (src, ids, w, nb_means, q_means)
    if any(t.device != src.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if src.device.type == "cpu":
        return tile_predict_plain(src, ids, w, nb_means, q_means, lo, hi)
    if src.device.type == "meta":
        _build.meta_call("fused_tile_predict", work(src, ids, lo, hi))
        return torch.empty((m, hi - lo), dtype=torch.float32,
                           device=src.device)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if src.dtype not in _DTYPES or ids.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in (w, nb_means, q_means)):
        raise TypeError(f"need int8/f32 src, int32 ids and f32 weights and "
                        f"means, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((m, hi - lo), dtype=torch.float32, device=src.device)
    if m:
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib()(src.data_ptr(), _DTYPES[src.dtype],
                            src.shape[0], src.shape[1], ids.data_ptr(),
                            w.data_ptr(), nb_means.data_ptr(),
                            q_means.data_ptr(), out.data_ptr(), m, k, lo, hi,
                            stream)
        _build.check(status, "fused_tile_predict")
        fused_tile_predict.launches += 1
        fused_tile_predict.routes[
            "int8" if src.dtype == torch.int8 else "f32"] += 1
    return out


fused_tile_predict.launches = 0
fused_tile_predict.routes = dict.fromkeys(ROUTES, 0)
