"""Fused support scorer (segmented SpMM): the hand-written CUDA kernel
(``csrc/support.cu``) and its plain PyTorch versions.

Port of the Pallas TPU kernel ``repro.kernels.support.fused_support_scores``
(``_support_kernel``), the item index's exact shortlist scorer:

    num[b, i] = Σ_k w[b,k] · dev[nb[b,k], i]
    den[b, i] = Σ_k w[b,k] · msk[nb[b,k], i]
    pred      = clip(q̄_b + num/den, 1, 5)     (q̄_b where den ≤ 1e-8)

over dense (U, I') deviation / rated-mask tables (``I'`` = the item count
padded to ``BT`` columns, as the reference's operand cache pads it;
:func:`support_tables` builds them).  The k-reduction runs in order
k = 0..k−1 with a separate multiply and add per step in the kernel and in
:func:`support_scores_plain` alike, so the two agree bit for bit; on the
same rounded ``r − r̄`` values that is also the tile predictor's order, so
a support score equals the exact prediction.

Two routes on the card, chosen before the launch from the operand's dtype
(:func:`support_route`) and counted in ``fused_support_scores.routes``:
``"table"`` (the f32 tables) and ``"int8"`` (the (U, I) int8 rating
matrix and the (U,) user means in their place: the kernel rebuilds each
table element from one byte, bit for bit, so both routes give the same
scores; :func:`support_scores_int8_plain` is the int8 route's plain
version).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back.
On a meta tensor (a dry run, ``launch/dryrun.py``) it returns meta
outputs and hands :func:`work` to the run's counter, launching and
counting nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DEN_EPS = 1e-8

BT = 512            # item-tile width the operand tables are padded to
ROUTES = ("table", "int8")


def support_width(n_items: int) -> int:
    """The scorer's padded output width I' for ``n_items`` columns."""
    return n_items + (-n_items) % min(BT, n_items) if n_items else 0


def center_rows(ratings: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """Mean-centered rating rows: rated cells become (r − mean), rest 0."""
    zero = torch.zeros((), dtype=torch.float32, device=ratings.device)
    return torch.where(ratings > 0, ratings - means[:, None], zero)


def support_tables(rows: torch.Tensor, means: torch.Tensor, width: int):
    """(n, I) rating rows and their users' means → the support scorer's
    (n, width) f32 deviation (:func:`center_rows`) and rated-mask rows,
    zero columns past I (den 0 there: the mean fallback, sliced off by
    the caller)."""
    rows = rows.float()
    dev = center_rows(rows, means)
    msk = (rows > 0).float()
    pad = width - rows.shape[1]
    if pad:
        dev = torch.nn.functional.pad(dev, (0, pad))
        msk = torch.nn.functional.pad(msk, (0, pad))
    return dev.contiguous(), msk.contiguous()


def support_scores_plain(dev: torch.Tensor, msk: torch.Tensor,
                         nb_idx: torch.Tensor, nb_w: torch.Tensor,
                         q_means: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one gathered (b, I') row pair per neighbor
    slot, accumulated in order k = 0..k−1, then the predictor's epilogue
    (every division tensor by tensor)."""
    b, k = nb_idx.shape
    ids = nb_idx.long()
    num = torch.zeros((b, dev.shape[1]), dtype=torch.float32,
                      device=dev.device)
    den = torch.zeros_like(num)
    for j in range(k):
        wj = nb_w[:, j, None]
        num = num + wj * dev[ids[:, j]]
        den = den + wj * msk[ids[:, j]]
    qm = q_means[:, None]
    pred = qm + num / den.clamp_min(_DEN_EPS)
    pred = torch.where(den > _DEN_EPS, pred, qm)
    return pred.clamp(1.0, 5.0)


def support_scores_int8_plain(ratings: torch.Tensor, means: torch.Tensor,
                              nb_idx: torch.Tensor, nb_w: torch.Tensor,
                              q_means: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 route: the tables from the (U, I) rating
    matrix and (U,) means (:func:`support_tables`), then
    :func:`support_scores_plain`."""
    dev, msk = support_tables(ratings, means,
                              support_width(ratings.shape[1]))
    return support_scores_plain(dev, msk, nb_idx, nb_w, q_means)


def support_route(dev: torch.Tensor, msk: torch.Tensor) -> str:
    """The route for a ``(dev, msk)`` operand pair: ``"table"`` for equal
    (U, I') f32 tables, ``"int8"`` for a (U, I) int8 rating matrix with
    its (U,) f32 means; raises ``TypeError`` /
    ``ValueError`` on anything else."""
    if dev.dim() != 2:
        raise ValueError(f"need a (U, I') table or (U, I) matrix, got "
                         f"{tuple(dev.shape)}")
    if dev.dtype == torch.int8:
        if msk.dtype != torch.float32:
            raise TypeError(f"the int8 route takes f32 means, got "
                            f"{msk.dtype}")
        if msk.shape != dev.shape[:1]:
            raise ValueError(f"means must be {tuple(dev.shape[:1])}, got "
                             f"{tuple(msk.shape)}")
        return "int8"
    if dev.shape != msk.shape:
        raise ValueError(f"need equal (U, I') tables, got "
                         f"{tuple(dev.shape)} and {tuple(msk.shape)}")
    if dev.dtype != torch.float32 or msk.dtype != torch.float32:
        raise TypeError(f"need f32 tables or an int8 matrix, got "
                        f"{dev.dtype} and {msk.dtype}")
    return "table"


def work(dev: torch.Tensor, msk: torch.Tensor, nb_idx: torch.Tensor, *,
         rows_read: int | None = None, terms: int | None = None):
    """(operations, bytes) of one call, as ``PERF.md``'s bound for kernel 7
    counts them: each distinct neighbor row read once — on the ``"int8"``
    route its I int8 ratings and its f32 mean, on ``"table"`` its two f32
    table rows — the ids and weights (8 bytes a slot), the query means and
    the (b, I') f32 output once; 4 operations a rated (neighbor, item)
    term under a nonzero weight and 5 an output for the epilogue.
    ``rows_read`` and ``terms`` depend on the data; without them every
    gathered row and element counts (min(b·k, U) rows, b·k·I terms)."""
    route = support_route(dev, msk)
    b, k = nb_idx.shape
    n_users, n_items = dev.shape
    width = n_items if route == "table" else support_width(n_items)
    rows_read = min(b * k, n_users) if rows_read is None else rows_read
    terms = b * k * n_items if terms is None else terms
    row_bytes = n_items + 4.0 if route == "int8" else 2.0 * width * 4
    return (4.0 * terms + 5.0 * b * width,
            rows_read * row_bytes + b * k * 8.0 + b * 4.0 + b * width * 4.0)


def _lib(route: str):
    lib = _build.load("support")
    p, i = ctypes.c_void_p, ctypes.c_int
    if route == "table":
        fn = lib.repro_support_scores
        if fn.argtypes is None:
            fn.argtypes = [p, p, i, i, p, p, p, p, i, i, p]
    else:
        fn = lib.repro_support_scores_int8
        if fn.argtypes is None:
            fn.argtypes = [p, p, i, i, i, p, p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def fused_support_scores(dev: torch.Tensor, msk: torch.Tensor,
                         nb_idx: torch.Tensor, nb_w: torch.Tensor,
                         q_means: torch.Tensor) -> torch.Tensor:
    """(U, I') deviation/mask tables × (b, k) neighbors → (b, I') scores.

    On the ``"int8"`` route ``dev`` is the (U, I) int8 rating matrix and
    ``msk`` the (U,) f32 user means, and the output is (b,
    :func:`support_width` of I), scored as the tables
    :func:`support_tables` would give.  ``nb_w`` must be the masked
    weights (invalid / non-positive neighbors at 0) and ``nb_idx`` int32
    ids clipped into ``[0, U)`` — what the item index's scorer prepares.
    Seen-item knockout is the caller's.  CUDA tensors launch the kernel
    on the current stream (output from ``torch.empty``, no
    synchronisation) and add one to ``fused_support_scores.launches`` and
    to the route's entry of ``fused_support_scores.routes``; CPU tensors
    run the plain version.
    """
    route = support_route(dev, msk)
    if nb_idx.dim() != 2:
        raise ValueError(f"need (b, k) ids, got {tuple(nb_idx.shape)}")
    b, k = nb_idx.shape
    if nb_w.shape != (b, k) or q_means.shape != (b,):
        raise ValueError(f"nb_w must be {(b, k)} and q_means {(b,)}, got "
                         f"{tuple(nb_w.shape)} and {tuple(q_means.shape)}")
    tensors = (dev, msk, nb_idx, nb_w, q_means)
    if any(t.device != dev.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    n_users, n_items = dev.shape
    if dev.device.type == "cpu":
        if route == "int8":
            return support_scores_int8_plain(dev, msk, nb_idx, nb_w,
                                             q_means)
        return support_scores_plain(dev, msk, nb_idx, nb_w, q_means)
    if dev.device.type == "meta":
        _build.meta_call("fused_support_scores", work(dev, msk, nb_idx))
        return torch.empty((b, n_items if route == "table"
                            else support_width(n_items)),
                           dtype=torch.float32, device=dev.device)
    if dev.device.type != "cuda":
        raise ValueError(f"unsupported device {dev.device}")
    if nb_idx.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (nb_w, q_means)):
        raise TypeError(f"need f32 weights and means and int32 ids, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    n_cols = n_items if route == "table" else support_width(n_items)
    out = torch.empty((b, n_cols), dtype=torch.float32, device=dev.device)
    if b and n_cols:
        with torch.cuda.device(dev.device):
            stream = torch.cuda.current_stream().cuda_stream
            common = (nb_idx.data_ptr(), nb_w.data_ptr(),
                      q_means.data_ptr(), out.data_ptr(), b, k, stream)
            if route == "table":
                status = _lib(route)(dev.data_ptr(), msk.data_ptr(),
                                     n_users, n_cols, *common)
            else:
                status = _lib(route)(dev.data_ptr(), msk.data_ptr(),
                                     n_users, n_items, n_cols, *common)
        _build.check(status, "fused_support_scores")
        fused_support_scores.launches += 1
        fused_support_scores.routes[route] += 1
    return out


fused_support_scores.launches = 0
fused_support_scores.routes = dict.fromkeys(ROUTES, 0)
