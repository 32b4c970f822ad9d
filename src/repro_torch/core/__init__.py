"""Core of the paper in PyTorch: exact memory-based collaborative
filtering (port of ``repro.core``, exact mode)."""

from repro_torch.core.facade import (BACKENDS, NEIGHBOR_MODES, CFEngine,
                                     UpdateStats)
from repro_torch.core.metrics import mae, precision_recall_f1, rmse
from repro_torch.core.neighbors import merge_topk, topk_neighbors
from repro_torch.core.predict import predict_from_neighbors, recommend_topn
from repro_torch.core.similarity import (SIMILARITY_MEASURES, all_measures,
                                         gram_terms, pairwise_similarity,
                                         user_means)

__all__ = [
    "BACKENDS", "NEIGHBOR_MODES", "CFEngine", "UpdateStats",
    "SIMILARITY_MEASURES", "all_measures", "gram_terms",
    "pairwise_similarity", "user_means", "topk_neighbors", "merge_topk",
    "predict_from_neighbors", "recommend_topn", "mae", "rmse",
    "precision_recall_f1",
]
