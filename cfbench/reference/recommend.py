"""Plain exact recommend: the mean-centred weighted-deviation predictor
(the paper's Eq. 3) over a neighbor cache, and the top-n unseen items.

    p(u, i) = mean_u + Σ_j w_j·(r_{v_j,i} − mean_{v_j})·[v_j rated i]
                       ─────────────────────────────────────────
                              Σ_j w_j·[v_j rated i]

over the cache's slots j = 0..k−1 in order, with weights w_j the cache's
scores where positive (else 0); mean_u when the denominator is ≤ 1e-8;
clamped to [1, 5].  Items u rated are never recommended; the top n go by
descending prediction, ties to the lower item id, and a slot no unseen
item fills is item −1 with score −inf.  Means are recomputed here from
the ratings: sum / count over rated items (the mean over all ratings for
a user with none).
"""

from __future__ import annotations

import torch

EPS = 1e-8


def user_means(ratings: torch.Tensor) -> torch.Tensor:
    """(U,) f32 mean rating of each user over the items it rated."""
    cnt = (ratings > 0).sum(1)
    tot = ratings.to(torch.float64).sum(1).float()     # exact: integers
    overall = tot.double().sum() / cnt.sum().clamp_min(1)
    return torch.where(cnt > 0, tot / cnt.clamp_min(1).float(),
                       overall.float())


def recommend_rows(ratings, means, scores, ids, users, n: int,
                   dtype=torch.float32):
    """Top-n (scores f32, item ids int32), each (len(users), n), for the
    users ``users`` (a 1-D long tensor) from the (U, k) cache."""
    s, idx = scores[users], ids[users]
    w = torch.where((s > 0) & (idx >= 0), s, torch.zeros_like(s)).to(dtype)
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx)).long()
    nb_mean = means[safe].to(dtype)
    m, k = s.shape
    n_items = ratings.shape[1]
    num = torch.zeros((m, n_items), dtype=dtype, device=ratings.device)
    den = torch.zeros_like(num)
    for j in range(k):
        r = ratings[safe[:, j]].to(dtype)
        rated = (r > 0).to(dtype)
        dev = (r - nb_mean[:, j, None]) * rated
        wj = w[:, j, None]
        num = num + wj * dev
        den = den + wj * rated
    own = means[users].to(dtype)[:, None]
    pred = own + num / den.clamp_min(EPS)
    pred = torch.where(den > EPS, pred, own).clamp(1.0, 5.0).float()
    pred = pred.masked_fill(ratings[users] > 0, float("-inf"))
    vals, items = torch.sort(pred, dim=1, descending=True, stable=True)
    vals, items = vals[:, :n], items[:, :n].to(torch.int32)
    return vals, torch.where(vals == float("-inf"),
                             torch.full_like(items, -1), items)
