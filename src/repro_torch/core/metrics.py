"""Evaluation metrics from the paper: MAE, RMSE, Precision, Recall, F-Score
(port of ``repro.core.metrics``).  An item is relevant when its true
rating ≥ threshold and predicted-relevant when the prediction is."""

from __future__ import annotations

from typing import Dict

import torch

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
