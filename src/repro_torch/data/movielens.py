"""Synthetic MovieLens-1M surrogate, kept byte-for-byte in step with
``repro.data.movielens`` (numpy only, so both packages draw identical
parity inputs from one spec and seed).

The generator is calibrated to ML-1M's published marginals:
  * 6040 users × 3952 movies, ~1,000,209 ratings (≈4.2% density)
  * integer ratings 1..5, global mean ≈ 3.58, std ≈ 1.12
  * power-law item popularity (a few blockbusters, a long tail)
  * log-normal per-user activity (median ≈ 96 ratings, min 20)
  * rating value = global mean + user bias + item bias + affinity noise,
    where affinity comes from a low-rank latent taste model so that user-user
    similarity structure (what CF exploits) actually exists.

All randomness is seeded; the matrix is deterministic per (seed, shape).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

ML1M_USERS = 6040
ML1M_ITEMS = 3952
ML1M_RATINGS = 1_000_209


@dataclasses.dataclass(frozen=True)
class MovieLensSpec:
    n_users: int = ML1M_USERS
    n_items: int = ML1M_ITEMS
    n_ratings: int = ML1M_RATINGS
    latent_dim: int = 8
    global_mean: float = 3.58
    user_bias_std: float = 0.30
    item_bias_std: float = 0.30
    noise_std: float = 0.55
    affinity_scale: float = 2.6
    popularity_alpha: float = 1.1     # zipf-ish item popularity exponent
    min_user_ratings: int = 4
    seed: int = 0

    def scaled(self, n_users: int, n_items: int) -> "MovieLensSpec":
        """Shrink while preserving the *co-rated overlap*, not the density.

        Memory-based CF lives on the expected number of co-rated items
        between two users, overlap ≈ (ratings/user)²/n_items (≈ 6.9 for
        ML-1M).  Keeping density constant while shrinking the item axis
        drives overlap toward zero and silently breaks every neighborhood
        method — so the surrogate preserves overlap instead.
        """
        overlap = (self.n_ratings / self.n_users) ** 2 / self.n_items
        per_user = (overlap * n_items) ** 0.5
        return dataclasses.replace(
            self, n_users=n_users, n_items=n_items,
            n_ratings=max(int(per_user * n_users), 4 * n_users))


def generate_ratings(spec: MovieLensSpec = MovieLensSpec()) -> np.ndarray:
    """Dense (n_users, n_items) float32 matrix; 0 = unrated, else 1..5."""
    rng = np.random.default_rng(spec.seed)
    U, I = spec.n_users, spec.n_items

    # latent taste model → realistic user-user similarity structure
    p = rng.normal(0, 1.0 / np.sqrt(spec.latent_dim), (U, spec.latent_dim))
    q = rng.normal(0, 1.0 / np.sqrt(spec.latent_dim), (I, spec.latent_dim))
    user_bias = rng.normal(0, spec.user_bias_std, U)
    item_bias = rng.normal(0, spec.item_bias_std, I)

    # item popularity: zipf over a random permutation of items
    ranks = rng.permutation(I) + 1.0
    item_p = ranks ** (-spec.popularity_alpha)
    item_p /= item_p.sum()

    # per-user activity: log-normal, clipped; allocate the rating budget
    activity = rng.lognormal(mean=0.0, sigma=0.9, size=U)
    counts = activity / activity.sum() * spec.n_ratings
    counts = np.maximum(counts.astype(np.int64), spec.min_user_ratings)
    counts = np.minimum(counts, I)

    ratings = np.zeros((U, I), np.float32)
    # Vectorised assignment user-by-user (I is small; a python loop over U
    # at 6k users is ~1s and keeps popularity sampling exact w/o replacement).
    for u in range(U):
        k = counts[u]
        items = rng.choice(I, size=k, replace=False, p=item_p)
        affinity = p[u] @ q[items].T
        raw = (spec.global_mean + user_bias[u] + item_bias[items]
               + spec.affinity_scale * affinity
               + rng.normal(0, spec.noise_std, k))
        ratings[u, items] = np.clip(np.rint(raw), 1, 5)
    return ratings


def train_test_split(ratings: np.ndarray, test_fraction: float = 0.1,
                     seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §VI-A: 90/10 split over observed ratings, per user.

    Every user keeps ≥1 training rating so user means stay defined.
    """
    rng = np.random.default_rng(seed)
    train = ratings.copy()
    test = np.zeros_like(ratings)
    users, items = np.nonzero(ratings)
    order = rng.permutation(len(users))
    # per-user counters so we never strip a user below 1 training rating
    remaining = (ratings > 0).sum(axis=1).astype(np.int64)
    budget = int(len(users) * test_fraction)
    taken = 0
    for j in order:
        if taken >= budget:
            break
        u, i = users[j], items[j]
        if remaining[u] <= 1:
            continue
        test[u, i] = ratings[u, i]
        train[u, i] = 0.0
        remaining[u] -= 1
        taken += 1
    return train, test


def load_ml1m_synthetic(n_users: int | None = None, n_items: int | None = None,
                        seed: int = 0):
    """Convenience: generate + split. Small sizes for tests via the args."""
    spec = MovieLensSpec(seed=seed)
    if n_users is not None or n_items is not None:
        spec = spec.scaled(n_users or spec.n_users, n_items or spec.n_items)
    full = generate_ratings(spec)
    train, test = train_test_split(full, seed=seed + 1)
    return train, test, spec
