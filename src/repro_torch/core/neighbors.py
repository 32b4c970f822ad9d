"""Top-k neighbor selection with blocked streaming merge (port of
``repro.core.neighbors``).

Selection runs as a loop over candidate-user blocks with an associative
running-top-k merge, so the U×U similarity matrix is never materialised.
The merge is a canonical two-key sort — descending score, ties to the
lower neighbor id — written as two stable sorts (id, then −score), the
counterpart of ``lax.sort(num_keys=2)``.  ``torch.topk``'s tie set is
arbitrary and would make the result depend on block order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import similarity as sim

NEG_INF = torch.finfo(torch.float32).min


def merge_topk(scores_a: torch.Tensor, idx_a: torch.Tensor,
               scores_b: torch.Tensor, idx_b: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (m, ka)/(m, kb) candidate sets into the canonical best
    (m, k): descending score, ties to the lower neighbor id."""
    scores = torch.cat([scores_a, scores_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    order = torch.sort(idx, dim=-1, stable=True).indices
    scores = torch.gather(scores, -1, order)
    idx = torch.gather(idx, -1, order)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    return (torch.gather(scores, -1, order[..., :k]),
            torch.gather(idx, -1, order[..., :k]))


def block_topk(q_block: torch.Tensor, ratings: torch.Tensor, k: int, *,
               measure: str = "pcc", q_offset: int = 0,
               cand_offset: int = 0, block_size: int = 1024,
               q_ids: torch.Tensor | None = None,
               beta: float | None = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k neighbors for a query block against all candidate users.

    ``q_block``: (m, D) query ratings (global ids from ``q_offset``, or the
    explicit (m,) ``q_ids`` — negative or out-of-range ids never match a
    candidate, so padding rows may use them); ``ratings``: (U, D)
    candidates (global ids from ``cand_offset``).  Self-pairs and padding
    candidates score NEG_INF; empty slots carry id -1.  Peak memory is
    O(m·block_size).  Returns (scores, neighbor_ids), both (m, k).
    """
    dev = ratings.device
    m = q_block.shape[0]
    n_users = ratings.shape[0]
    if q_ids is None:
        q_ids = q_offset + torch.arange(m, device=dev)
    q_ids = q_ids.to(device=dev, dtype=torch.int64)
    best_s = torch.full((m, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    for b0 in range(0, n_users, block_size):
        block = ratings[b0:b0 + block_size]
        n_pad = block_size - block.shape[0]
        if n_pad:
            # padded candidate slots, as the reference's padded last block
            block = torch.cat([block, block.new_zeros(n_pad, block.shape[1])])
        s = sim.pairwise_similarity(q_block, block, measure=measure,
                                    beta=beta)
        cand = cand_offset + b0 + torch.arange(block_size, device=dev)
        invalid = (cand[None, :] == q_ids[:, None]) | \
                  (cand[None, :] >= cand_offset + n_users)
        s = s.masked_fill(invalid, NEG_INF)
        ids = cand.to(torch.int32)[None, :].expand(m, -1)
        best_s, best_i = merge_topk(best_s, best_i, s, ids, k)
    return best_s, best_i


def topk_neighbors(ratings: torch.Tensor, k: int, *, measure: str = "pcc",
                   block_size: int = 1024, beta: float | None = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-users top-k neighbors: (U, k) scores + (U, k) int32 ids."""
    return block_topk(ratings, ratings, k, measure=measure,
                      block_size=min(block_size, ratings.shape[0]),
                      beta=beta)


def neighbor_weight_matrix(scores: torch.Tensor, idx: torch.Tensor,
                           n_users: int, *, clip_negative: bool = True
                           ) -> torch.Tensor:
    """Densify (U, k) top-k into a (U, U) row-sparse weight matrix."""
    u = scores.shape[0]
    floor = 0.0 if clip_negative else NEG_INF / 2
    w = torch.where(scores > floor, scores, torch.zeros_like(scores))
    w = torch.where(idx >= 0, w, torch.zeros_like(w))
    dense = torch.zeros((u, n_users), dtype=torch.float32,
                        device=scores.device)
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx)).long()
    dense.scatter_add_(1, safe, w)
    return dense
