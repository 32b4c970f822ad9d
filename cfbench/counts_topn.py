"""The frozen count of the bulk recommend's top-n select, from its shapes
alone, as ``cfbench/counts.py`` counts the pass.

A pass ranks every user's (I,) masked predictions and keeps n: each
prediction read once (f32, 4 bytes) and each kept (score, item) pair
written once (f32 + int32, 8 bytes).  One comparison a prediction is far
below the bytes' time, so the bytes bound it.  The count is the same
whatever implements the select (a radix select, a sort, a fused mask).
"""

from __future__ import annotations


def topn_work(n_users: int, n_items: int, n: int) -> dict:
    """Bytes the top-``n`` of every user of a (U, I) pass needs."""
    u, i = int(n_users), int(n_items)
    return {"bytes": float(u * i * 4 + u * int(n) * 8)}
