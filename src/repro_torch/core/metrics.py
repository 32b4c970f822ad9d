"""Evaluation metrics from the paper: MAE, RMSE, Precision, Recall, F-Score
(port of ``repro.core.metrics``).  An item is relevant when its true
rating ≥ threshold and predicted-relevant when the prediction is.  A
top-n list variant scores each user's n highest-predicted unseen items
against the relevant unseen test items."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.predict import recommend_topn

DEFAULT_RELEVANCE_THRESHOLD = 3.5


def _mask(truth, mask):
    return ((truth > 0) if mask is None else mask).float()


def mae(pred: torch.Tensor, truth: torch.Tensor,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean absolute error over observed test ratings (paper Eq. 3)."""
    mask = _mask(truth, mask)
    err = (pred - truth).abs() * mask
    return err.sum() / mask.sum().clamp_min(1.0)


def rmse(pred: torch.Tensor, truth: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    mask = _mask(truth, mask)
    err = (pred - truth).square() * mask
    return torch.sqrt(err.sum() / mask.sum().clamp_min(1.0))


def confusion_counts(pred: torch.Tensor, truth: torch.Tensor, *,
                     threshold: float = DEFAULT_RELEVANCE_THRESHOLD,
                     mask: torch.Tensor | None = None
                     ) -> Dict[str, torch.Tensor]:
    """TP/FP/FN/TN over observed test cells under the relevance threshold."""
    maskf = _mask(truth, mask)
    rel = (truth >= threshold).float() * maskf
    hit = (pred >= threshold).float() * maskf
    return {"tp": (rel * hit).sum(), "fp": ((maskf - rel) * hit).sum(),
            "fn": (rel * (maskf - hit)).sum(),
            "tn": ((maskf - rel) * (maskf - hit)).sum()}


def precision_recall_f1(pred: torch.Tensor, truth: torch.Tensor, *,
                        threshold: float = DEFAULT_RELEVANCE_THRESHOLD,
                        mask: torch.Tensor | None = None
                        ) -> Dict[str, torch.Tensor]:
    """Paper Eqs. 4–6 on thresholded relevance."""
    c = confusion_counts(pred, truth, threshold=threshold, mask=mask)
    precision = c["tp"] / (c["tp"] + c["fp"]).clamp_min(1.0)
    recall = c["tp"] / (c["tp"] + c["fn"]).clamp_min(1.0)
    f1 = 2.0 * precision * recall / (precision + recall).clamp_min(1e-8)
    return {"precision": precision, "recall": recall, "f1": f1, **c}


def topn_precision_recall(pred: torch.Tensor, truth: torch.Tensor,
                          seen_mask: torch.Tensor, n: int, *,
                          threshold: float = DEFAULT_RELEVANCE_THRESHOLD
                          ) -> Dict[str, torch.Tensor]:
    """Recommendation-list variant: top-n unseen items vs relevant test
    items, averaged over the users that have a relevant item.

    The list is :func:`~repro_torch.core.predict.recommend_topn`'s (a
    stable descending sort: ties go to the lower item id, as the
    reference's ``lax.top_k`` gives them).  Seen items score −inf, so a
    user with fewer than n unseen items fills the list with seen items,
    which are never relevant: they count as no hit."""
    _, items = recommend_topn(pred, seen_mask, n)
    rel = (truth >= threshold) & ~seen_mask          # (U, I) relevant, unseen
    n_hits = rel.gather(1, items.long()).sum(-1).float()
    n_rel = rel.sum(-1).float()
    has_rel = n_rel > 0
    precision = torch.where(has_rel, n_hits / n, 0.0)
    recall = torch.where(has_rel, n_hits / n_rel.clamp_min(1.0), 0.0)
    denom = has_rel.float().sum().clamp_min(1.0)
    precision = precision.sum() / denom
    recall = recall.sum() / denom
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-8)
    return {"precision": precision, "recall": recall, "f1": f1}
