"""Fused pairwise similarity: the hand-written CUDA kernel
(``csrc/similarity.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.similarity.fused_similarity``
(``_sim_kernel``).  The kernel accumulates all six masked Gram products
and the four row statistics in one pass over the item axis and applies
the measure's epilogue in registers; it is bound by operations (see the
note in the CUDA source).  The plain version is
``repro_torch.core.similarity``'s ``gram_terms`` plus the epilogues.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import similarity as sim
from repro_torch.kernels import _build

MEASURES = ("jaccard", "cosine", "pcc")
ALL_MEASURES = MEASURES + ("pcc_sig",)    # "all" keeps the 3-tuple
_CODES = {"jaccard": 0, "cosine": 1, "pcc": 2, "pcc_sig": 3, "all": 4}
_DTYPES = {torch.float32: 0, torch.int8: 1}


def similarity_plain(ra: torch.Tensor, rb: torch.Tensor, *,
                     measure: str = "all",
                     beta: float = sim.PCC_SIG_BETA):
    """Plain PyTorch version of the kernel (torch.matmul Gram terms)."""
    g = sim.gram_terms(ra, rb)
    if measure == "all":
        return (sim.jaccard_from_gram(g), sim.cosine_from_gram(g),
                sim.pcc_from_gram(g))
    if measure == "pcc_sig":
        return sim.pcc_sig_from_gram(g, beta=beta)
    return sim._EPILOGUES[measure](g)


def _lib():
    lib = _build.load("similarity")
    fn = lib.repro_similarity
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def fused_similarity(ra: torch.Tensor, rb: torch.Tensor, *,
                     measure: str = "all",
                     beta: float = sim.PCC_SIG_BETA):
    """(m, D) × (n, D) rating blocks → (m, n) f32 similarity under
    ``measure``, or the (jaccard, cosine, pcc) tuple for ``"all"``.

    ``ra``/``rb``: contiguous f32 or int8, both on one device.  CUDA
    tensors launch the kernel on the current stream (output from
    ``torch.empty``, no synchronisation) and add one to
    ``fused_similarity.launches``; CPU tensors run the plain version.
    """
    if measure not in _CODES:
        raise ValueError(f"unknown measure {measure!r}; want one of "
                         f"{ALL_MEASURES} or 'all'")
    beta = sim.resolve_beta(beta)
    if ra.dim() != 2 or rb.dim() != 2 or ra.shape[1] != rb.shape[1]:
        raise ValueError(f"need (m, D) × (n, D) blocks, got "
                         f"{tuple(ra.shape)} × {tuple(rb.shape)}")
    if ra.device != rb.device:
        raise ValueError(f"ra on {ra.device} but rb on {rb.device}")
    if ra.device.type == "cpu":
        return similarity_plain(ra, rb, measure=measure, beta=beta)
    if ra.device.type != "cuda":
        raise ValueError(f"unsupported device {ra.device}")
    if ra.dtype not in _DTYPES or rb.dtype != ra.dtype:
        raise TypeError(f"need matching f32 or int8 blocks, got {ra.dtype} "
                        f"and {rb.dtype}")
    if not (ra.is_contiguous() and rb.is_contiguous()):
        raise ValueError("rating blocks must be contiguous")
    m, d = ra.shape
    n = rb.shape[0]
    n_out = 3 if measure == "all" else 1
    outs = [torch.empty((m, n), dtype=torch.float32, device=ra.device)
            for _ in range(n_out)]
    if m and n:
        ptrs = [o.data_ptr() for o in outs] + [0] * (3 - n_out)
        with torch.cuda.device(ra.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib()(ra.data_ptr(), rb.data_ptr(), *ptrs, m, n, d,
                            _DTYPES[ra.dtype], _CODES[measure], beta, stream)
        _build.check(status, "fused_similarity")
        fused_similarity.launches += 1
    return tuple(outs) if measure == "all" else outs[0]


fused_similarity.launches = 0
