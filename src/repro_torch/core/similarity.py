"""Pairwise user-similarity measures (port of ``repro.core.similarity``).

All measures (Jaccard, Cosine, Pearson, significance-weighted Pearson)
between two blocks of users derive from one set of *Gram terms*: six
masked matrix products over the item axis plus per-row counts and norms.
These plain ``torch.matmul`` functions are also the plain version the
hand-written kernel in ``repro_torch.kernels.similarity`` is held to.

Exactness: for integer ratings 0..5 every Gram sum is an integer below
2²⁴ at the paper's D = 3952, so the f32 sums are exact in any order (TF32
is off, see ``repro_torch.device``) and equal the reference's bit for bit.
The epilogues keep the reference's operation order with IEEE rounding
at every step, like the CUDA kernel's explicitly rounded intrinsics:

* square roots are taken in f64 and rounded to f32 (``_sqrt``), which is
  the correctly rounded f32 root — PyTorch's f32 ``sqrt`` on the CPU can
  be one ulp off (sqrt(5757) is one case);
* every division is tensor / tensor — a CUDA division by a Python scalar
  is computed as a multiply by its reciprocal, which rounds differently.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import device as _device  # noqa: F401  (pins TF32 off)

SIMILARITY_MEASURES = ("jaccard", "cosine", "pcc", "pcc_sig")

_EPS = 1e-8


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (via f64, exact for f32 inputs)."""
    return torch.sqrt(x.double()).float()


# significance-weighting shrink horizon: pairs with fewer than PCC_SIG_BETA
# co-rated items have their pcc scaled by n/β (Herlocker et al.'s n/50 rule)
PCC_SIG_BETA = 50.0


@dataclasses.dataclass(frozen=True)
class GramTerms:
    """Sufficient statistics for all pairwise similarities of a block pair:
    ``(m, n)`` pairwise fields, ``(m,)`` / ``(n,)`` per-side counts/norms."""

    n_common: torch.Tensor   # |P_a ∩ P_b| — number of co-rated items
    dot: torch.Tensor        # Σ_{q∈common} r_a[q] · r_b[q]
    sum_a: torch.Tensor      # Σ_{q∈common} r_a[q]
    sum_b: torch.Tensor      # Σ_{q∈common} r_b[q]
    sq_a: torch.Tensor       # Σ_{q∈common} r_a[q]²
    sq_b: torch.Tensor       # Σ_{q∈common} r_b[q]²
    count_a: torch.Tensor    # |P_a| — items rated by each query user
    count_b: torch.Tensor    # |P_b|
    norm_a: torch.Tensor     # √(Σ_all r_a²) — full-vector L2 norm
    norm_b: torch.Tensor


def gram_terms(ra: torch.Tensor, rb: torch.Tensor) -> GramTerms:
    """Shared Gram terms for a (query, candidate) block pair.

    ``ra``: (m, D), ``rb``: (n, D) dense ratings with 0 = unrated.
    """
    ra = ra.float()
    rb = rb.float()
    ma = (ra > 0).float()
    mb = (rb > 0).float()
    n_common = ma @ mb.T
    dot = ra @ rb.T
    sum_a = ra @ mb.T
    sum_b = ma @ rb.T
    sq_a = (ra * ra) @ mb.T
    sq_b = ma @ (rb * rb).T
    count_a = ma.sum(-1)
    count_b = mb.sum(-1)
    norm_a = _sqrt((ra * ra).sum(-1))
    norm_b = _sqrt((rb * rb).sum(-1))
    return GramTerms(n_common, dot, sum_a, sum_b, sq_a, sq_b,
                     count_a, count_b, norm_a, norm_b)


def jaccard_from_gram(g: GramTerms) -> torch.Tensor:
    """Jaccard similarity |P_a ∩ P_b| / |P_a ∪ P_b|  (paper Eq. 1)."""
    union = g.count_a[:, None] + g.count_b[None, :] - g.n_common
    return g.n_common / union.clamp_min(_EPS)


def cosine_from_gram(g: GramTerms) -> torch.Tensor:
    """Full-vector cosine similarity (unrated = 0)."""
    denom = g.norm_a[:, None] * g.norm_b[None, :]
    return g.dot / denom.clamp_min(_EPS)


def pcc_from_gram(g: GramTerms, normalize: bool = True) -> torch.Tensor:
    """Pearson correlation over co-rated items (paper Eq. 2), mapped to
    [0, 1] with ``normalize``.  Pairs with < 2 co-rated items or zero
    variance score 0."""
    n = g.n_common
    cov = n * g.dot - g.sum_a * g.sum_b
    var_a = n * g.sq_a - g.sum_a * g.sum_a
    var_b = n * g.sq_b - g.sum_b * g.sum_b
    denom = _sqrt(var_a.clamp_min(0.0) * var_b.clamp_min(0.0))
    valid = (n >= 2) & (denom > _EPS)
    zero = torch.zeros((), dtype=n.dtype, device=n.device)
    pcc = torch.where(valid, cov / denom.clamp_min(_EPS), zero)
    pcc = pcc.clamp(-1.0, 1.0)
    if normalize:
        pcc = torch.where(valid, (pcc + 1.0) * 0.5, zero)
    return pcc


def pcc_sig_from_gram(g: GramTerms,
                      beta: float = PCC_SIG_BETA) -> torch.Tensor:
    """Significance-weighted pcc: ``pcc01 · min(n_common, β)/β``."""
    b = torch.full((), beta, dtype=torch.float32, device=g.n_common.device)
    shrink = g.n_common.clamp_max(beta) / b
    return pcc_from_gram(g) * shrink


_EPILOGUES = {
    "jaccard": jaccard_from_gram,
    "cosine": cosine_from_gram,
    "pcc": pcc_from_gram,
    "pcc_sig": pcc_sig_from_gram,
}


def resolve_beta(beta) -> float:
    """The ``pcc_sig`` shrink horizon: explicit value or module default."""
    b = PCC_SIG_BETA if beta is None else float(beta)
    if b <= 0:
        raise ValueError(f"pcc_sig beta must be > 0, got {b}")
    return b


def pairwise_similarity(ra: torch.Tensor, rb: torch.Tensor,
                        measure: str = "pcc",
                        beta: float | None = None) -> torch.Tensor:
    """(m, D) × (n, D) → (m, n) similarity under ``measure``."""
    if measure not in _EPILOGUES:
        raise ValueError(f"unknown measure {measure!r}; want one of "
                         f"{SIMILARITY_MEASURES}")
    g = gram_terms(ra, rb)
    if measure == "pcc_sig":
        return pcc_sig_from_gram(g, beta=resolve_beta(beta))
    return _EPILOGUES[measure](g)


def all_measures(ra: torch.Tensor, rb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(jaccard, cosine, pcc01) from one shared Gram computation."""
    g = gram_terms(ra, rb)
    return jaccard_from_gram(g), cosine_from_gram(g), pcc_from_gram(g)


def means_from_stats(cnt: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """Per-user means from rated counts/sums; 0-raters get the global mean."""
    global_mean = tot.sum() / cnt.sum().clamp_min(1)
    return torch.where(cnt > 0, tot / cnt.clamp_min(1), global_mean)


def user_stats(ratings: torch.Tensor):
    """(rated count int32, rating sum, means) per user — the incremental
    update's sufficient statistics."""
    cnt = (ratings > 0).sum(-1, dtype=torch.int32)
    tot = ratings.sum(-1)
    return cnt, tot, means_from_stats(cnt, tot)


def user_means(ratings: torch.Tensor) -> torch.Tensor:
    """Per-user mean over *rated* items only; 0-raters get the global mean."""
    return user_stats(ratings)[2]
