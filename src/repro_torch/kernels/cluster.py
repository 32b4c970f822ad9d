"""Fused centroid distances: the hand-written CUDA kernel
(``csrc/cluster.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel
``repro.kernels.cluster.fused_centroid_distances``
(``_dist_kernel``): (m, D) rows × (C, D) centroids → (m, C) squared
Euclidean distances ``max((‖x‖² − 2x·c) + ‖c‖², 0)``, consumed by the
index's k-means sweep, spill assignment, refold and cluster probe.

Batch invariance is the contract: the index's consistency check compares
spill distances computed over all rows with distances its refold computed
over a padded subset, bit for bit.  So every sum runs in order d = 0..D−1
with separately rounded products, in the kernel and in the plain version
(``ref.centroid_distances_ref``) alike; the two agree bit for bit and a
row's distances never depend on the rows beside it.

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
from repro_torch.kernels.ref import centroid_distances_ref

centroid_distances_plain = centroid_distances_ref


def work(x: torch.Tensor, c: torch.Tensor):
    """(operations, bytes) of one call on (m, D) × (C, D), as ``PERF.md``'s
    bound for kernel 3 counts them: 2·m·C·D for the cross term, 2·(m + C)·D
    for the norms and 3·m·C for the epilogue; rows and centroids read and
    the (m, C) f32 output written once."""
    m, d = x.shape
    n = c.shape[0]
    return (2.0 * m * n * d + 2.0 * (m + n) * d + 3.0 * m * n,
            ((m + n) * d + m * n) * 4.0)


def _lib():
    lib = _build.load("cluster")
    fn = lib.repro_centroid_distances
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def fused_centroid_distances(x: torch.Tensor, c: torch.Tensor
                             ) -> torch.Tensor:
    """(m, D) × (C, D) f32 → (m, C) f32 squared distances.

    CUDA tensors launch the kernel on the current stream (output from
    ``torch.empty``, no synchronisation) and add one to
    ``fused_centroid_distances.launches``; CPU tensors run the plain
    version.
    """
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"need (m, D) × (C, D), got {tuple(x.shape)} × "
                         f"{tuple(c.shape)}")
    if x.device != c.device:
        raise ValueError(f"x on {x.device} but c on {c.device}")
    if x.device.type == "cpu":
        return centroid_distances_plain(x, c)
    if x.device.type == "meta":
        _build.meta_call("fused_centroid_distances", work(x, c))
        return torch.empty((x.shape[0], c.shape[0]), dtype=torch.float32,
                           device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"need f32 rows and centroids, got {x.dtype} and "
                        f"{c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("rows and centroids must be contiguous")
    m, d = x.shape
    n = c.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib()(x.data_ptr(), c.data_ptr(), out.data_ptr(), m, n,
                            d, stream)
        _build.check(status, "fused_centroid_distances")
        fused_centroid_distances.launches += 1
    return out


fused_centroid_distances.launches = 0


def centroid_distances(x: torch.Tensor, c: torch.Tensor, *,
                       use_kernel: bool = True) -> torch.Tensor:
    """The index's distance entry point: the kernel wrapper, or the plain
    version on any device with ``use_kernel=False`` (how the index runs
    its plain path on the card for comparison)."""
    if use_kernel:
        return fused_centroid_distances(x.float().contiguous(),
                                        c.float().contiguous())
    return centroid_distances_plain(x, c)
