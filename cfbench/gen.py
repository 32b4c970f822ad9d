"""Seeded rating data made on the device: the benchmark's own generator.

A PyTorch rewrite of the MovieLens surrogate's calibration (a latent taste
model, user and item biases, Zipf item popularity, log-normal user
activity, integer ratings 1-5), drawn in user blocks on the device so that
10^8 ratings take seconds.  Items are drawn per user without replacement
with probability proportional to popularity by the Gumbel-top-c trick: a
user's c items are the c largest of ``log p_i + Gumbel noise``.

Every seed gets the same set of sizes: the activity counts are the
log-normal's quantiles scaled to the configuration's exact rating total,
and the Zipf weights are the ranks 1..I; the seed only decides which user
gets which count, which item gets which rank, the tastes, biases and noise.
So two seeds give the device the same amount of work.

Three independent streams come from one ``--seed``: the matrix, the refit
job's stream of new ratings, and the recommend job's neighbor cache.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# distinct generator streams derived from one seed
_STREAMS = {"matrix": 0x6A09E667, "updates": 0xBB67AE85, "cache": 0x3C6EF372}
_BLOCK_CELLS = 1 << 26          # cells of one user block while drawing


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one of the streams of ``seed``."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + _STREAMS[stream]) % (1 << 63)
    g = torch.Generator(device=device)
    g.manual_seed(mixed)
    return g


def activity_counts(n_users: int, n_items: int, n_ratings: int,
                    min_per_user: int, sigma: float) -> torch.Tensor:
    """(n_users,) int64 ratings a user, ascending, summing to exactly
    ``n_ratings``: the quantiles of a log-normal of shape ``sigma``, scaled
    and floored, each within [min_per_user, n_items]."""
    if not n_users * min_per_user <= n_ratings <= n_users * n_items:
        raise ValueError(f"{n_ratings} ratings cannot spread over "
                         f"{n_users} users of {min_per_user}..{n_items}")
    q = (torch.arange(n_users, dtype=torch.float64) + 0.5) / n_users
    act = torch.exp(sigma * torch.special.ndtri(q))

    def total(scale):
        return (act * scale).floor().clamp(min_per_user, n_items).sum()

    lo, hi = 0.0, float(n_items) / float(act[0])
    for _ in range(200):                  # largest scale not over the total
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if total(mid) <= n_ratings else (lo, mid)
    scaled = act * lo
    counts = scaled.floor().clamp(min_per_user, n_items).long()
    short = n_ratings - int(counts.sum())
    # hand the remainder to the users nearest their next whole rating
    frac = torch.where(counts < n_items, scaled - scaled.floor(),
                       torch.full_like(scaled, -1.0))
    while short > 0:
        take = torch.argsort(frac, descending=True, stable=True)[:short]
        take = take[counts[take] < n_items]
        counts[take] += 1
        frac[take] = -1.0
        short -= len(take)
    return torch.sort(counts).values


@dataclasses.dataclass
class Ratings:
    """A generated deployment: the dense (U, I) f32 matrix (0 = unrated) and
    the latent model it was drawn from, which the streams reuse."""
    matrix: torch.Tensor        # (U, I) f32 on the device
    taste_u: torch.Tensor       # (U, d) user tastes
    taste_i: torch.Tensor       # (I, d) item tastes
    bias_u: torch.Tensor        # (U,)
    bias_i: torch.Tensor        # (I,)
    log_pop: torch.Tensor       # (I,) log popularity weight (unnormalised)
    counts: torch.Tensor        # (U,) int64 ratings a user
    model: dict                 # the configuration's generator settings

    def raw_value(self, users, items, noise):
        """The latent model's real-valued rating of (users[j], items[j])."""
        m = self.model
        aff = (self.taste_u[users] * self.taste_i[items]).sum(-1)
        return (m["global_mean"] + self.bias_u[users] + self.bias_i[items]
                + m["affinity_scale"] * aff + m["noise_std"] * noise)

    def rating(self, raw):
        m = self.model
        return torch.round(raw).clamp(m["rating_min"], m["rating_max"])


def model_settings(cfg: dict) -> dict:
    """The generator's settings of a configuration file: its sizes and the
    values it lists under ``assumed``."""
    out = dict(cfg["assumed"])
    for key in ("n_users", "n_items", "n_ratings", "min_user_ratings",
                "rating_min", "rating_max"):
        out[key] = cfg[key]
    return out


def generate(cfg: dict, seed: int, device) -> Ratings:
    """The configuration's rating matrix for ``seed``, made on ``device``
    in user blocks of at most 2^26 cells."""
    m = model_settings(cfg)
    n_u, n_i, d = m["n_users"], m["n_items"], m["latent_dim"]
    g = generator(seed, "matrix", device)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    taste_u = torch.randn(n_u, d, **f32) / math.sqrt(d)
    taste_i = torch.randn(n_i, d, **f32) / math.sqrt(d)
    bias_u = torch.randn(n_u, **f32) * m["user_bias_std"]
    bias_i = torch.randn(n_i, **f32) * m["item_bias_std"]
    ranks = torch.randperm(n_i, generator=g, device=device) + 1
    log_pop = -m["popularity_alpha"] * torch.log(ranks.float())
    counts = activity_counts(n_u, n_i, m["n_ratings"], m["min_user_ratings"],
                             m["activity_sigma"]).to(device)
    counts = counts[torch.randperm(n_u, generator=g, device=device)]
    out = Ratings(torch.empty((n_u, n_i), dtype=torch.float32, device=device),
                  taste_u, taste_i, bias_u, bias_i, log_pop, counts, m)
    block = max(1, _BLOCK_CELLS // n_i)
    items = torch.arange(n_i, device=device)
    for lo in range(0, n_u, block):
        hi = min(n_u, lo + block)
        u = torch.rand(hi - lo, n_i, **f32).clamp_min_(1e-30)
        keys = log_pop - torch.log(-torch.log(u))        # + Gumbel noise
        order = torch.sort(keys, dim=1, descending=True).indices
        del u, keys
        chosen = torch.zeros((hi - lo, n_i), dtype=torch.bool, device=device)
        chosen.scatter_(1, order, items[None, :] < counts[lo:hi, None])
        del order
        # taste affinity as d multiply-adds (no matmul, whose precision
        # switches would change the matrix)
        aff = torch.zeros((hi - lo, n_i), dtype=torch.float32, device=device)
        for j in range(d):
            aff += taste_u[lo:hi, j, None] * taste_i[None, :, j]
        raw = (m["global_mean"] + bias_u[lo:hi, None] + bias_i[None, :]
               + m["affinity_scale"] * aff
               + m["noise_std"] * torch.randn(hi - lo, n_i, **f32))
        out.matrix[lo:hi] = torch.where(chosen, out.rating(raw), 0.0)
    return out


class UpdateStream:
    """The refit job's stream of new ratings: each batch draws ``size``
    (user, item) cells, users by activity and items by popularity, rated by
    the latent model; a cell drawn twice in one batch keeps its first
    draw's value.  Every call is device work only, with no host sync."""

    def __init__(self, data: Ratings, seed: int, size: int):
        self.data = data
        self.size = int(size)
        dev = data.matrix.device
        self.g = generator(seed, "updates", dev)
        self.user_w = data.counts.double()
        self.item_w = torch.exp(data.log_pop.double())
        self.pos = torch.arange(self.size, device=dev)

    def next(self):
        """(flat cell ids, values) of the next batch, sorted by cell."""
        d, g = self.data, self.g
        users = torch.multinomial(self.user_w, self.size, replacement=True,
                                  generator=g)
        items = torch.multinomial(self.item_w, self.size, replacement=True,
                                  generator=g)
        noise = torch.randn(self.size, generator=g, device=users.device)
        vals = d.rating(d.raw_value(users, items, noise))
        cells = users * d.matrix.shape[1] + items
        cells, order = torch.sort(cells, stable=True)
        vals = vals[order]
        start = torch.ones_like(cells, dtype=torch.bool)
        start[1:] = cells[1:] != cells[:-1]
        first = torch.where(start, self.pos, 0).cummax(0).values
        return cells, vals[first]


def neighbor_cache(data: Ratings, seed: int, k: int, pool: int = 2048):
    """A restored neighbor cache: for each user, the ``k`` users nearest in
    the latent taste space (cosine) among a seeded pool of ``pool``
    distinct others, with weights (1 + cos) / 2 in (0, 1], descending.
    Returns ((U, k) f32 weights, (U, k) int32 ids)."""
    n_u = data.matrix.shape[0]
    dev = data.matrix.device
    g = generator(seed, "cache", dev)
    pool = min(pool, n_u)
    if pool <= k:
        raise ValueError(f"{n_u} users cannot give {k} neighbors each")
    unit = torch.nn.functional.normalize(data.taste_u, dim=1)
    scores = torch.empty((n_u, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n_u, k), dtype=torch.int32, device=dev)
    block = 4096
    for lo in range(0, n_u, block):
        hi = min(n_u, lo + block)
        cand = torch.randperm(n_u, generator=g, device=dev)[:pool]
        cos = unit[lo:hi] @ unit[cand].T
        me = torch.arange(lo, hi, device=dev)
        cos = cos.masked_fill(cand[None, :] == me[:, None], -math.inf)
        top = torch.topk(cos, k, dim=1)
        scores[lo:hi] = ((1.0 + top.values) * 0.5).clamp(2.0 ** -10, 1.0)
        ids[lo:hi] = cand[top.indices].to(torch.int32)
    return scores, ids
