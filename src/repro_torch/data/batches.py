"""Synthetic batches (port of ``repro.data.batches``: ``lm_batch``,
``recsys_batch``, ``bert4rec_batch``, ``candidates``): host-side numpy, deterministic per
seed, byte-identical to the reference's generators."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def lm_batch(batch: int, seq_len: int, vocab: int, seed: int = 0
             ) -> Dict[str, np.ndarray]:
    """{"tokens": (batch, seq_len), "labels": the tokens shifted by one},
    int32 ids in [0, vocab)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def recsys_batch(batch: int, field_sizes: Sequence[int], n_dense: int = 0,
                 seed: int = 0, power_law: bool = True
                 ) -> Dict[str, np.ndarray]:
    """CTR batch: {"sparse": (batch, F) int32 per-field ids, "labels":
    (batch,) int32 0/1, and with ``n_dense`` "dense": (batch, n_dense)
    f32 normals}.  A field of more than 100 ids draws zipf(1.2) − 1
    clipped to its vocabulary (the hot-row skew of real CTR logs), a
    smaller one uniformly."""
    rng = np.random.default_rng(seed)
    cols = []
    for s in field_sizes:
        if power_law and s > 100:
            raw = rng.zipf(1.2, batch) - 1
            cols.append(np.minimum(raw, s - 1))
        else:
            cols.append(rng.integers(0, s, batch))
    out = {"sparse": np.stack(cols, 1).astype(np.int32),
           "labels": rng.integers(0, 2, batch).astype(np.int32)}
    if n_dense:
        out["dense"] = rng.normal(0, 1, (batch, n_dense)).astype(np.float32)
    return out


def bert4rec_batch(batch: int, seq_len: int, n_items: int,
                   mask_token: int, mask_prob: float = 0.15, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Masked-item batch: {"items": (batch, seq_len) int32 ids in [1,
    n_items) with ``mask_token`` at the masked positions, "labels": the
    original id there and −1 elsewhere}; each position is masked with
    probability ``mask_prob``."""
    rng = np.random.default_rng(seed)
    items = rng.integers(1, n_items, (batch, seq_len), dtype=np.int32)
    mask = rng.random((batch, seq_len)) < mask_prob
    labels = np.where(mask, items, -1).astype(np.int32)
    masked = np.where(mask, mask_token, items).astype(np.int32)
    return {"items": masked, "labels": labels}


def candidates(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    """(n,) int32 candidate ids, uniform in [0, vocab)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, n).astype(np.int32)
