"""Fused support scorer (segmented SpMM): the hand-written CUDA kernel
(``csrc/support.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.support.fused_support_scores``
(``_support_kernel``), the item index's exact shortlist scorer:

    num[b, i] = Σ_k w[b,k] · dev[nb[b,k], i]
    den[b, i] = Σ_k w[b,k] · msk[nb[b,k], i]
    pred      = clip(q̄_b + num/den, 1, 5)     (q̄_b where den ≤ 1e-8)

over dense (U, I') deviation / rated-mask tables (``I'`` = the item count
padded to ``BT`` columns, as the reference's operand cache pads it).  The
k-reduction runs in order k = 0..k−1 with a separate multiply and add per
step in the kernel and in :func:`support_scores_plain` alike, so the two
agree bit for bit; on the same rounded ``r − r̄`` values that is also the
tile predictor's order, so a support score equals the exact prediction.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DEN_EPS = 1e-8

BT = 512            # item-tile width the operand tables are padded to


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


def _lib():
    lib = _build.load("support")
    fn = lib.repro_support_scores
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def fused_support_scores(dev: torch.Tensor, msk: torch.Tensor,
                         nb_idx: torch.Tensor, nb_w: torch.Tensor,
                         q_means: torch.Tensor) -> torch.Tensor:
    """(U, I') deviation/mask tables × (b, k) neighbors → (b, I') scores.

    ``nb_w`` must be the masked weights (invalid / non-positive neighbors
    at 0) and ``nb_idx`` int32 ids clipped into ``[0, U)`` — what the item
    index's scorer prepares.  Seen-item knockout is the caller's.  CUDA
    tensors launch the kernel on the current stream (output from
    ``torch.empty``, no synchronisation) and add one to
    ``fused_support_scores.launches``; CPU tensors run the plain version.
    """
    if dev.dim() != 2 or dev.shape != msk.shape or nb_idx.dim() != 2:
        raise ValueError(f"need equal (U, I') tables and (b, k) ids, got "
                         f"{tuple(dev.shape)}, {tuple(msk.shape)} and "
                         f"{tuple(nb_idx.shape)}")
    b, k = nb_idx.shape
    if nb_w.shape != (b, k) or q_means.shape != (b,):
        raise ValueError(f"nb_w must be {(b, k)} and q_means {(b,)}, got "
                         f"{tuple(nb_w.shape)} and {tuple(q_means.shape)}")
    tensors = (dev, msk, nb_idx, nb_w, q_means)
    if any(t.device != dev.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if dev.device.type == "cpu":
        return support_scores_plain(dev, msk, nb_idx, nb_w, q_means)
    if dev.device.type != "cuda":
        raise ValueError(f"unsupported device {dev.device}")
    if nb_idx.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (dev, msk, nb_w, q_means)):
        raise TypeError(f"need f32 tables, weights and means and int32 ids, "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((b, dev.shape[1]), dtype=torch.float32,
                      device=dev.device)
    if b and dev.shape[1]:
        with torch.cuda.device(dev.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib()(dev.data_ptr(), msk.data_ptr(), dev.shape[0],
                            dev.shape[1], nb_idx.data_ptr(),
                            nb_w.data_ptr(), q_means.data_ptr(),
                            out.data_ptr(), b, k, stream)
        _build.check(status, "fused_support_scores")
        fused_support_scores.launches += 1
    return out


fused_support_scores.launches = 0
