"""Fused pairwise similarity: the hand-written CUDA kernel
(``csrc/similarity.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.similarity.fused_similarity``
(``_sim_kernel``).  The kernel accumulates all six masked Gram products
and the four row statistics in one pass over the item axis and applies
the measure's epilogue in registers; it is bound by operations (see the
note in the CUDA source).  The plain version is
``repro_torch.core.similarity``'s ``gram_terms`` plus the epilogues.

Two routes on the card, chosen before the launch from the operands'
dtypes (:func:`similarity_route`) and counted in
``fused_similarity.routes``: ``"imma"`` (both blocks int8: the int8
tensor cores, int32 sums) and ``"simt"`` (both blocks f32: f32 FMAs on
the CUDA cores).  The ``"imma"`` route's domain is every Gram sum at most
2^24 — where the f32 plain version is exact too — checked on the host
from D and a bound on |value| (``max_value``, else int8's own 128);
outside it the wrapper raises.  The kernel checks ``max_value`` against
the data and counts the rows past it, so a bound below the data raises
too (after the launch).

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

MEASURES = ("jaccard", "cosine", "pcc")
ALL_MEASURES = MEASURES + ("pcc_sig",)    # "all" keeps the 3-tuple
ROUTES = ("imma", "simt")
_CODES = {"jaccard": 0, "cosine": 1, "pcc": 2, "pcc_sig": 3, "all": 4}
_ROUTE_OF = {torch.int8: "imma", torch.float32: "simt"}
# the "imma" route's domain: f32 is exact on every Gram sum up to 2^24
EXACT_SUM = 2 ** 24
# |value| ≤ 15 keeps v² in one u8 square plane; above, a hi plane joins
NARROW_MAX = 15


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


def similarity_route(a_dtype: torch.dtype, b_dtype: torch.dtype, d: int,
                     max_value: int | None = None) -> str:
    """The card's route for (m, d) × (n, d) blocks of these dtypes:
    ``"imma"`` for int8 × int8, ``"simt"`` for f32 × f32; raises
    ``TypeError`` on any other pair and ``ValueError`` when an int8 pair
    lies outside the exact domain ``max_value² · d ≤ 2^24`` (int8's own
    bound, 128, without ``max_value``)."""
    route = _ROUTE_OF.get(a_dtype)
    if route is None or b_dtype != a_dtype:
        raise TypeError(f"need matching f32 or int8 blocks, got {a_dtype} "
                        f"and {b_dtype}")
    if route == "imma":
        bound = 128 if max_value is None else int(max_value)
        if bound * bound * d > EXACT_SUM:
            raise ValueError(
                f"int8 similarity outside its exact domain: max_value² · D "
                f"= {bound}² · {d} > 2^24, where f32 Gram sums stop being "
                f"exact; pass the ratings' bound as max_value, or f32 rows")
    return route


def work(ra: torch.Tensor, rb: torch.Tensor, measure: str = "all"):
    """(operations, bytes) of one call on (m, D) × (n, D) blocks, as
    ``PERF.md``'s bound for kernel 1 counts them: 2·m·n·D operations a
    masked Gram product — one for jaccard and for cosine, six for pcc,
    pcc_sig and "all" — and each block read once and each (m, n) f32
    output written once."""
    m, d = ra.shape
    n = rb.shape[0]
    products = 1 if measure in ("jaccard", "cosine") else 6
    n_out = 3 if measure == "all" else 1
    return (2.0 * products * m * n * d,
            float(m * d * ra.element_size() + n * d * rb.element_size()
                  + n_out * m * n * 4))


def _meta(ra, rb, measure, max_value):
    """The call on meta tensors: the outputs and the "imma" route's
    square planes and row statistics, its work handed to the dry run's
    counter.  No data, so the rows-past-``max_value`` count is not
    checked."""
    route = _ROUTE_OF.get(ra.dtype)
    if route is None or rb.dtype != ra.dtype:
        raise TypeError(f"need matching f32 or int8 blocks, got {ra.dtype} "
                        f"and {rb.dtype}")
    m, d = ra.shape
    n = rb.shape[0]
    dev = ra.device
    if route == "imma":
        d16 = -(-d // 16) * 16
        bound = 128 if max_value is None else min(int(max_value), 128)
        planes = 0 if measure in ("jaccard", "cosine") \
            else 1 + (bound > NARROW_MAX)
        for rows in (m, n):
            torch.empty((planes, rows, d16), dtype=torch.uint8, device=dev)
            torch.empty((2, rows), dtype=torch.float32, device=dev)
    outs = [torch.empty((m, n), dtype=torch.float32, device=dev)
            for _ in range(3 if measure == "all" else 1)]
    _build.meta_call("fused_similarity", work(ra, rb, measure))
    return tuple(outs) if measure == "all" else outs[0]


def _lib(route: str):
    lib = _build.load("similarity")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if route == "simt":
        fn = lib.repro_similarity
        if fn.argtypes is None:
            fn.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    else:
        fn = lib.repro_similarity_imma
        if fn.argtypes is None:
            fn.argtypes = [p] * 9 + [i, i, i, i, i, i, p, f, p]
    fn.restype = ctypes.c_int
    return fn


def fused_similarity(ra: torch.Tensor, rb: torch.Tensor, *,
                     measure: str = "all",
                     beta: float = sim.PCC_SIG_BETA,
                     max_value: int | None = None,
                     n_bad: torch.Tensor | None = None):
    """(m, D) × (n, D) rating blocks → (m, n) f32 similarity under
    ``measure``, or the (jaccard, cosine, pcc) tuple for ``"all"``.

    ``ra``/``rb``: contiguous, both f32 or both int8, on one device.
    ``max_value``: a bound on |value| of both blocks (the ratings'
    scale), for the int8 route's exactness domain ``max_value² · D ≤
    2^24``; at most 15 also keeps each square in one u8 plane.  The
    kernel counts the rows of either block holding a value past it: into
    ``n_bad``, a (1,) int32 tensor on the blocks' device that the caller
    reads when it next waits (a fit reads it once for all its launches),
    or, without ``n_bad``, into a counter of its own that the wrapper
    reads after the launch, waiting for it, and raises ``ValueError`` if
    it is not 0.  CUDA tensors launch the kernel on the current stream
    (outputs and scratch from ``torch.empty``) and add one to
    ``fused_similarity.launches`` and to the route's entry of
    ``fused_similarity.routes``; CPU tensors run the plain version; meta
    tensors give meta outputs and hand :func:`work` to a dry run's
    counter, launching nothing and counting no launch.
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
    if ra.device.type == "meta":
        return _meta(ra, rb, measure, max_value)
    if ra.device.type != "cuda":
        raise ValueError(f"unsupported device {ra.device}")
    m, d = ra.shape
    n = rb.shape[0]
    route = similarity_route(ra.dtype, rb.dtype, d, max_value)
    if not (ra.is_contiguous() and rb.is_contiguous()):
        raise ValueError("rating blocks must be contiguous")
    dev = ra.device
    n_out = 3 if measure == "all" else 1
    outs = [torch.empty((m, n), dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    if m and n:
        ptrs = [o.data_ptr() for o in outs] + [0] * (3 - n_out)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if route == "simt":
                status = _lib(route)(ra.data_ptr(), rb.data_ptr(), *ptrs, m,
                                     n, d, _CODES[measure], beta, stream)
            else:
                # rows of 16-byte multiples: a zero item adds nothing to
                # any sum or row statistic
                d = -(-d // 16) * 16
                ra = _build.padded_rows(ra, d)
                rb = _build.padded_rows(rb, d)
                bound = 128 if max_value is None else min(int(max_value),
                                                          128)
                own = n_bad is None and bound < 128
                if own:
                    n_bad = torch.zeros((1,), dtype=torch.int32, device=dev)
                elif n_bad is not None and (n_bad.dtype != torch.int32
                                            or n_bad.device != dev):
                    raise ValueError("n_bad must be an int32 counter on "
                                     f"{dev}")
                wide = bound > NARROW_MAX
                planes = 0 if measure in ("jaccard", "cosine") \
                    else 1 + wide
                sq_a = torch.empty((planes, m, d), dtype=torch.uint8,
                                   device=dev)
                sq_b = torch.empty((planes, n, d), dtype=torch.uint8,
                                   device=dev)
                st_a = torch.empty((2, m), dtype=torch.float32, device=dev)
                st_b = torch.empty((2, n), dtype=torch.float32, device=dev)
                status = _lib(route)(
                    ra.data_ptr(), rb.data_ptr(), sq_a.data_ptr(),
                    sq_b.data_ptr(), st_a.data_ptr(), st_b.data_ptr(),
                    *ptrs, m, n, d, _CODES[measure], int(wide), bound,
                    0 if n_bad is None else n_bad.data_ptr(), beta, stream)
        _build.check(status, "fused_similarity")
        fused_similarity.launches += 1
        fused_similarity.routes[route] += 1
        if route == "imma" and own:
            bad = int(n_bad.item())
            if bad:
                raise ValueError(
                    f"{bad} row(s) hold a value past max_value = "
                    f"{max_value}: the int8 similarity would drop squares "
                    f"or leave its exact domain; pass the ratings' bound")
    return tuple(outs) if measure == "all" else outs[0]


fused_similarity.launches = 0
fused_similarity.routes = dict.fromkeys(ROUTES, 0)
