"""(Weighted) Slope One — the paper's cited prior art, ref. [12] (port of
``repro.core.slope_one``).

Slope One is item-based (a deviation matrix between item pairs), so its
parallel axis is items where UserCF's is users:

    dev(i, j) = Σ_{u rated both} (r_ui − r_uj) / |co-raters(i, j)|
    pred(u, i) = Σ_{j∈rated(u)} c_ij · (dev(i, j) + r_uj) / Σ_j c_ij

Both phases are masked matmuls over the item axis: the deviation and
count matrices come from three Gram-style products, the prediction from
three more.  The reference computes them outside any Pallas kernel, so
they are ``torch.matmul`` here, with TF32 off (pinned by
``repro_torch.device``).  On integer ratings every product of the
deviation build is an exact f32 integer, so ``dev`` and ``counts`` equal
the reference's bit for bit.  :func:`sharded_deviation` is ref. [12]'s
multithreaded build on ``torch.distributed``: each rank of a mesh axis
computes its block of item rows, and the blocks are gathered.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import engine, metrics
from repro_torch.core.cf_model import as_model_tensor
from repro_torch.device import resolve_device


def _rm(ratings: torch.Tensor):
    r = ratings.float()
    return r, (r > 0).float()


def _deviation(rows_t, mask_rows_t, r, m):
    """dev and counts of the item rows ``rows_t`` ((I', U), with their
    rated mask) against every item of ``r`` ((U, I), mask ``m``)."""
    counts = mask_rows_t @ m                           # (I', I)
    sum_i = rows_t @ m                                 # Σ r_ui over co-raters
    sum_j = mask_rows_t @ r                            # Σ r_uj over co-raters
    return (sum_i - sum_j) / counts.clamp_min(1.0), counts


def deviation_matrix(ratings: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ratings (U, I) with 0 = unrated → (dev (I, I), counts (I, I)).

    dev[i, j] = mean over co-raters of (r_ui − r_uj); counts[i, j] =
    number of co-raters.  Three matmuls: Mᵀ·M, Rᵀ·M, Mᵀ·R."""
    r, m = _rm(ratings)
    return _deviation(r.T, m.T, r, m)


def predict(ratings: torch.Tensor, dev: torch.Tensor, counts: torch.Tensor
            ) -> torch.Tensor:
    """Weighted Slope One prediction for every (user, item) cell, clipped
    to [1, 5]; a user whose rated items share no co-rater with an item
    gets their mean rating there."""
    r, m = _rm(ratings)
    # num[u, i] = Σ_j m[u, j]·c_ij·(dev_ij + r_uj)
    #           = Σ_j c_ij·dev_ij·m[u, j] + Σ_j c_ij·r_uj
    num = m @ (counts * dev).T + r @ counts.T
    den = m @ counts.T
    pred = num / den.clamp_min(1e-8)
    fallback = r.sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp_min(1.0)
    pred = torch.where(den > 1e-8, pred, fallback)
    return pred.clamp(1.0, 5.0)


def sharded_deviation(ratings: torch.Tensor, mesh=None, *,
                      axis: str = "data"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Item-sharded deviation build: the rank at index i of ``axis`` owns
    the item rows ``[i·I/P, (i+1)·I/P)`` and computes their (I/P, I)
    blocks of ``dev`` and ``counts``; the blocks are ``all_gather``ed, so
    every rank returns the full matrices, equal to
    :func:`deviation_matrix`.  I must divide over the axis
    (``ValueError``).  With no mesh, :func:`repro_torch.core.engine.
    default_mesh` on the ratings' device."""
    mesh = mesh if mesh is not None else engine.default_mesh(
        ratings.device, axis)
    group, me, n = engine.mesh_axis(mesh, axis, ratings)
    n_items = ratings.shape[1]
    if n_items % n != 0:
        raise ValueError(f"I={n_items} must divide axis {axis}={n}")
    shard = n_items // n
    r, m = _rm(ratings)
    rows = slice(me * shard, (me + 1) * shard)
    dev, counts = _deviation(r.T[rows], m.T[rows], r, m)
    return (engine.all_gather_rows(dev, group, n),
            engine.all_gather_rows(counts, group, n))


class SlopeOne:
    """fit / predict / evaluate API mirroring UserCF.  With a ``mesh``,
    ``fit`` builds the deviations item-sharded over its ``"data"`` axis.
    ``device`` (default ``"cuda"``, a missing card raises) is where numpy
    inputs go."""

    def __init__(self, mesh=None, *, device="cuda"):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dev = None
        self.counts = None

    def fit(self, ratings) -> "SlopeOne":
        r = as_model_tensor(ratings, self.device)
        if self.mesh is None:
            self.dev, self.counts = deviation_matrix(r)
        else:
            self.dev, self.counts = sharded_deviation(r, self.mesh)
        return self

    def predict(self, ratings) -> torch.Tensor:
        if self.dev is None:
            raise RuntimeError("call fit() first")
        return predict(as_model_tensor(ratings, self.device), self.dev,
                       self.counts)

    def evaluate(self, train, test) -> dict:
        """MAE, RMSE and the paper's Eqs. 4-6 on the held-out ratings."""
        test = as_model_tensor(test, self.device)
        pred = self.predict(train)
        mask = test > 0
        out = {"mae": metrics.mae(pred, test, mask),
               "rmse": metrics.rmse(pred, test, mask)}
        out.update(metrics.precision_recall_f1(pred, test, mask=mask))
        return {k: float(v) for k, v in out.items()}
