"""Plain-torch oracles for the port's kernels, under the reference's names
(``repro.kernels.ref``), so the parity tests read alike.  They run on any
device and allocate freely."""

from __future__ import annotations

import torch

from repro_torch.core import predict as core_pred
from repro_torch.kernels.similarity import similarity_plain


def similarity_ref(ra: torch.Tensor, rb: torch.Tensor, measure: str = "all"):
    """(m, D) × (n, D) → similarity under ``measure`` (or the jaccard,
    cosine, pcc triple for ``"all"``): the fused-similarity kernel's plain
    version."""
    return similarity_plain(ra, rb, measure=measure)


def tile_predict_ref(nbr: torch.Tensor, w: torch.Tensor,
                     nb_means: torch.Tensor,
                     q_means: torch.Tensor) -> torch.Tensor:
    """(m, k, T) gathered neighbor ratings, (m, k) masked weights and
    neighbor means, (m,) query means → (m, T) clipped predictions, with
    the k-reduction in the kernel's order."""
    return core_pred._tile_predict(w, nbr.float(), nb_means, q_means)
