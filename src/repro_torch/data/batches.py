"""Synthetic LM batches (port of ``repro.data.batches.lm_batch``):
host-side numpy, deterministic per seed, byte-identical to the
reference's generator."""

from __future__ import annotations

from typing import Dict

import numpy as np


def lm_batch(batch: int, seq_len: int, vocab: int, seed: int = 0
             ) -> Dict[str, np.ndarray]:
    """{"tokens": (batch, seq_len), "labels": the tokens shifted by one},
    int32 ids in [0, vocab)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
