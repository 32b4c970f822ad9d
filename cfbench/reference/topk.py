"""Plain Pearson top-k neighbors (paper Eq. 2, mapped to [0, 1]).

For a query user u, the six sums over the items u and v both rated are
exact integers (ratings are integers 1..5), summed here in int64.  The
epilogue follows Eq. 2 in ``dtype``:

    cov = n·dot − sum_u·sum_v,  var_u = n·sq_u − sum_u²,  var_v likewise
    pcc = cov / sqrt(max(var_u, 0)·max(var_v, 0)), clamped to [−1, 1]
    score = (pcc + 1) / 2, or 0 where n < 2 or the root is ≤ 1e-8

with the square root taken in f64 and rounded to f32 (the correctly
rounded f32 root).  A user is not its own neighbor (score = the f32
minimum), and the top k are ordered by descending score, ties to the
lower user id.
"""

from __future__ import annotations

import torch

NEG = torch.finfo(torch.float32).min
EPS = 1e-8


def pair_sums(ratings: torch.Tensor, u: int):
    """(n, dot, sum_u, sum_v, sq_u, sq_v) of user ``u`` against every user,
    each (U,) int64, over the items both rated."""
    cols = torch.nonzero(ratings[u] > 0).flatten()
    cand = ratings[:, cols].to(torch.int64)           # (U, c)
    mine = ratings[u, cols].to(torch.int64)            # (c,)
    both = (cand > 0).to(torch.int64)
    return (both.sum(1), (cand * mine).sum(1), (both * mine).sum(1),
            cand.sum(1), (both * mine * mine).sum(1), (cand * cand).sum(1))


def pcc_scores(sums, dtype=torch.float32) -> torch.Tensor:
    """Eq. 2's score in [0, 1] from :func:`pair_sums`, computed in
    ``dtype`` (the root via f64 for f32), returned as f32."""
    n, dot, sum_u, sum_v, sq_u, sq_v = (x.to(dtype) for x in sums)
    cov = n * dot - sum_u * sum_v
    var_u = n * sq_u - sum_u * sum_u
    var_v = n * sq_v - sum_v * sum_v
    prod = var_u.clamp_min(0.0) * var_v.clamp_min(0.0)
    root = (torch.sqrt(prod.double()).to(dtype) if dtype == torch.float32
            else torch.sqrt(prod))
    valid = (n >= 2) & (root > EPS)
    zero = torch.zeros((), dtype=dtype, device=n.device)
    pcc = torch.where(valid, cov / root.clamp_min(EPS), zero)
    pcc = pcc.clamp(-1.0, 1.0)
    return torch.where(valid, (pcc + 1.0) * 0.5, zero).float()


def topk_rows(ratings: torch.Tensor, users, k: int,
              dtype=torch.float32):
    """The exact top-k (scores f32, ids int32), each (len(users), k), of
    the given users over all users."""
    out_s, out_i = [], []
    for u in users:
        u = int(u)
        s = pcc_scores(pair_sums(ratings, u), dtype)
        s[u] = NEG
        order = torch.sort(s, descending=True, stable=True).indices[:k]
        out_s.append(s[order])
        out_i.append(order.to(torch.int32))
    return torch.stack(out_s), torch.stack(out_i)
