"""The comparison that decides ``correct``: a program's (scores, ids) rows
against the reference's, slot by slot."""

from __future__ import annotations

import torch


def gaps(got_s, got_i, ref_s, ref_i):
    """(widest score gap, id mismatches) between two (m, k) row sets.
    Equal scores (−inf included) gap 0; a NaN gaps +inf."""
    same = got_s == ref_s
    gap = torch.where(same, torch.zeros_like(ref_s), (got_s - ref_s).abs())
    gap = torch.nan_to_num(gap, nan=float("inf"))
    widest = float(gap.max()) if gap.numel() else 0.0
    return widest, int((got_i != ref_i).sum())
