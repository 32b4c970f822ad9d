"""Fused co-rated Gram rerank: the hand-written CUDA kernel
(``csrc/rerank.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.rerank.fused_rerank_scores``
(``_rerank_kernel``): the exact rerank of the clustered index scores a
block of query rows against the union of their shortlisted candidates,
gathered once, with the candidates' full-row norms and rated counts
passed in (cosine: one Gram product; jaccard: one; pcc / pcc_sig: six).
Every product carries a query-side factor, so full-width candidate rows
give exactly the co-rated sums of the paper's per-pair loop.

On integer ratings every Gram sum is an exact f32 integer in any order,
and kernel and plain version keep the reference's epilogue order with
IEEE square roots and divisions, so the kernel, the plain version
(``ref.rerank_scores_ref``, which stands in for the reference's
``rerank_scores_xla`` twin) and the reference's oracle agree bit for bit.
The index's staged grouped rerank runs the plain version where the
reference runs its host BLAS twin ``rerank_scores_host``: on integer
ratings the two agree bit for bit.

Two routes on the card, chosen before the launch from the operands'
dtypes and counted in ``fused_rerank_scores.routes``: ``"imma"`` (query
and candidate rows both int8: the int8 tensor cores, int32 sums) and
``"simt"`` (f32 query rows, f32 or int8 candidates: f32 FMAs).  The
``"imma"`` route's domain is every Gram sum at most 2^24 — where the f32
plain version is exact too — checked on the host from J and a bound on
|value| (``max_value``, else int8's own 128); outside it the wrapper
raises.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back.
On a meta tensor (a dry run, ``launch/dryrun.py``) it returns meta
outputs and hands :func:`work` to the run's counter, launching and
counting nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import similarity as sim
from repro_torch.kernels import _build
from repro_torch.kernels.ref import rerank_scores_ref

MEASURES = ("jaccard", "cosine", "pcc", "pcc_sig")
ROUTES = ("imma", "simt")
_CODES = {"jaccard": 0, "cosine": 1, "pcc": 2, "pcc_sig": 3}
_DTYPES = {torch.float32: 0, torch.int8: 1}
# the "imma" route's domain: f32 is exact on every Gram sum up to 2^24
EXACT_SUM = 2 ** 24

rerank_scores_plain = rerank_scores_ref


def work(q_vals: torch.Tensor, cand_rows: torch.Tensor,
         measure: str = "cosine"):
    """(operations, bytes) of one call on (G, J) × (Kc, J), as ``PERF.md``'s
    bound for kernel 6 counts them: 2·G·Kc·J operations a Gram product —
    one for jaccard and for cosine, six for pcc and pcc_sig — and both
    row blocks (at their widths), the candidates' norms and counts read
    once and the (G, Kc) f32 output written once."""
    g, j = q_vals.shape
    kc = cand_rows.shape[0]
    products = 1 if measure in ("jaccard", "cosine") else 6
    return (2.0 * products * g * kc * j,
            float(g * j * q_vals.element_size()
                  + kc * j * cand_rows.element_size() + kc * 8 + g * kc * 4))


def _lib():
    lib = _build.load("rerank")
    fn = lib.repro_rerank_scores
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float,
                       p]
        fn.restype = ctypes.c_int
    return fn


def fused_rerank_scores(q_vals: torch.Tensor, cand_rows: torch.Tensor,
                        cand_norms: torch.Tensor, cand_counts: torch.Tensor,
                        *, measure: str = "cosine",
                        beta: float = sim.PCC_SIG_BETA,
                        max_value: int | None = None) -> torch.Tensor:
    """Exact similarity of a query group against a candidate union.

    ``q_vals``: (G, J) query rows, f32 or int8 (0 = unrated);
    ``cand_rows``: (Kc, J) candidate rows, int8 or f32 (int8 when the
    queries are); ``cand_norms`` / ``cand_counts``: (Kc,) f32 full-row L2
    norms and rated counts.  ``max_value``: a bound on |value| of both
    operands that the caller knows (the ratings' scale), for the int8
    route's exactness domain ``max_value² · J ≤ 2^24``; without it int8's
    own bound, 128, is assumed.  Returns (G, Kc) f32 scores; self /
    padding masking is the caller's.  CUDA tensors launch the kernel on
    the current stream and add one to ``fused_rerank_scores.launches``
    and to the route's entry of ``fused_rerank_scores.routes``; CPU
    tensors run the plain version.
    """
    if measure not in _CODES:
        raise ValueError(f"unknown measure {measure!r}; want one of "
                         f"{MEASURES}")
    beta = sim.resolve_beta(beta)
    if q_vals.dim() != 2 or cand_rows.dim() != 2 \
            or q_vals.shape[1] != cand_rows.shape[1]:
        raise ValueError(f"need (G, J) × (Kc, J), got {tuple(q_vals.shape)}"
                         f" × {tuple(cand_rows.shape)}")
    g, j = q_vals.shape
    kc = cand_rows.shape[0]
    if cand_norms.shape != (kc,) or cand_counts.shape != (kc,):
        raise ValueError(f"cand_norms / cand_counts must be ({kc},)")
    tensors = (q_vals, cand_rows, cand_norms, cand_counts)
    if any(t.device != q_vals.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if q_vals.device.type == "cpu":
        return rerank_scores_plain(q_vals, cand_rows, cand_norms,
                                   cand_counts, measure=measure, beta=beta)
    if q_vals.device.type == "meta":
        _build.meta_call("fused_rerank_scores",
                         work(q_vals, cand_rows, measure))
        return torch.empty((g, kc), dtype=torch.float32,
                           device=q_vals.device)
    if q_vals.device.type != "cuda":
        raise ValueError(f"unsupported device {q_vals.device}")
    if q_vals.dtype not in _DTYPES or cand_rows.dtype not in _DTYPES \
            or (q_vals.dtype == torch.int8
                and cand_rows.dtype != torch.int8) \
            or cand_norms.dtype != torch.float32 \
            or cand_counts.dtype != torch.float32:
        raise TypeError(f"need f32 or int8 queries, int8/f32 candidates "
                        f"(int8 with int8 queries), f32 norms and counts, "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    route = "imma" if q_vals.dtype == torch.int8 else "simt"
    if route == "imma":
        bound = 128 if max_value is None else int(max_value)
        if bound * bound * j > EXACT_SUM:
            raise ValueError(
                f"int8 rerank outside its exact domain: max_value² · J = "
                f"{bound}² · {j} > 2^24, where f32 Gram sums stop being "
                f"exact; pass the ratings' bound as max_value, or f32 rows")
        # rows of 16-byte multiples: a zero item adds nothing to any sum
        j = -(-j // 16) * 16
        q_vals = _build.padded_rows(q_vals, j)
        cand_rows = _build.padded_rows(cand_rows, j)
    out = torch.empty((g, kc), dtype=torch.float32, device=q_vals.device)
    if g and kc:
        with torch.cuda.device(q_vals.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib()(q_vals.data_ptr(), cand_rows.data_ptr(),
                            cand_norms.data_ptr(), cand_counts.data_ptr(),
                            out.data_ptr(), g, kc, j,
                            _DTYPES[q_vals.dtype],
                            _DTYPES[cand_rows.dtype], _CODES[measure], beta,
                            stream)
        _build.check(status, "fused_rerank_scores")
        fused_rerank_scores.launches += 1
        fused_rerank_scores.routes[route] += 1
    return out


fused_rerank_scores.launches = 0
fused_rerank_scores.routes = dict.fromkeys(ROUTES, 0)
