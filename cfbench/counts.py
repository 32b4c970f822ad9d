"""Frozen counts of the work each job needs, from its shapes and the
measure's definition alone, and the published peaks they are held to.

Nothing here reads the program: not its kernels' ``work`` functions, not
its dry-run cost model.  A later change that fuses, re-tiles or removes a
kernel cannot move a count, so a roofline share and the whole step's share
of the peak read the same work whatever implements it.

Fit (the exact top-k of every user over all users, Pearson over co-rated
items).  For a (user a, candidate b) pair pcc needs six sums over the items
both rated: n = Σ m_a m_b, dot = Σ r_a r_b, sum_a = Σ r_a m_b,
sum_b = Σ m_a r_b, sq_a = Σ r_a² m_b and sq_b = Σ m_a r_b², with m the
rated mask.  Over all ordered pairs of one matrix, sum_b and sq_b are the
transposes of sum_a and sq_a, and n and dot are symmetric, so a fit needs
I·(U² + U² + U(U+1)/2 + U(U+1)/2) = I·(3U² + U) multiply-adds, two
operations each.  The program computes all six products (12 operations a
triple); counting the four the definition cannot do without keeps the
share honest for a kernel that uses the symmetry.  Every rating is an
integer in 1..5, so the products run at the int8 tensor-core peak.  Bytes:
the ratings read once at one byte a cell, and the (U, k) neighbor cache
(f32 score, int32 id) written once.

Recommend pass (the top-n unseen items of every user from a (U, k) cache).
For each user u and each neighbor v of positive weight, each item v rated
is one term: num += w·(r - mean_v) and den += w, four operations; each
(user, item) prediction's epilogue (divide, add, fallback, clamp to 1..5)
is five.  The terms depend on the data: Σ_u Σ_{v ∈ N(u), w > 0} |P_v|.
That arithmetic is f32 on the CUDA cores.  Bytes: the ratings read once at
one byte a cell (neighbor rows and the seen mask), the cache (8 bytes a
slot), the (U,) means, and the (U, n) top-n (f32 score, int32 id) written.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at its full
# 700 W power limit (the card's limit is read with each run)
H100_PEAKS = {
    "int8_ops": 1.979e15,       # int8 tensor-core operations a second
    "f32_flops": 67e12,         # f32 outside the tensor cores
    "hbm_bytes": 3.35e12,       # HBM3 bytes a second
}


def peaks_for(kind: str):
    """The published peaks of the card named ``kind``, or None."""
    return H100_PEAKS if "H100" in kind else None


def fit_work(n_users: int, n_items: int, k: int) -> dict:
    """Operations (int8) and bytes one exact pcc fit needs."""
    u, i = int(n_users), int(n_items)
    macs = i * (3 * u * u + u)
    return {"ops": 2.0 * macs, "ops_peak": "int8_ops",
            "bytes": float(u * i + u * k * 8)}


def recommend_work(n_users: int, n_items: int, k: int, n: int,
                   terms: int) -> dict:
    """Operations (f32) and bytes one exact recommend pass over every user
    needs; ``terms`` is the count of rated (neighbor, item) terms under a
    positive weight (:func:`rated_terms`)."""
    u, i = int(n_users), int(n_items)
    return {"ops": 4.0 * terms + 5.0 * u * i, "ops_peak": "f32_flops",
            "bytes": float(u * i + u * k * 8 + u * 4 + u * n * 8)}


def rated_terms(counts, ids, weights) -> int:
    """Σ over users and neighbor slots of positive weight of the neighbor's
    rated-item count: ``counts`` (U,) ratings a user, ``ids`` / ``weights``
    (U, k) the cache."""
    per_slot = counts.long()[ids.long().clamp_min(0)]
    live = (weights > 0) & (ids >= 0)
    return int((per_slot * live).sum())


def bound_seconds(work: dict, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations at
    their peak and the bytes at the HBM rate."""
    return max(work["ops"] / peaks[work["ops_peak"]],
               work["bytes"] / peaks["hbm_bytes"])
