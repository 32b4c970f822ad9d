"""Core of the paper in PyTorch: exact memory-based collaborative
filtering (port of ``repro.core``, exact mode): the paper's ``UserCF``
model, the ``CFEngine`` facade and the Slope One baseline."""

from repro_torch.core.cf_model import CFConfig, CFState, UserCF
from repro_torch.core.facade import (BACKENDS, NEIGHBOR_MODES, CFEngine,
                                     UpdateStats)
from repro_torch.core.metrics import (mae, precision_recall_f1, rmse,
                                      topn_precision_recall)
from repro_torch.core.neighbors import merge_topk, topk_neighbors
from repro_torch.core.predict import predict_from_neighbors, recommend_topn
from repro_torch.core.similarity import (SIMILARITY_MEASURES, all_measures,
                                         gram_terms, pairwise_similarity,
                                         user_means)
from repro_torch.core.slope_one import SlopeOne

__all__ = [
    "BACKENDS", "NEIGHBOR_MODES", "CFEngine", "UpdateStats",
    "CFConfig", "CFState", "UserCF", "SIMILARITY_MEASURES",
    "all_measures", "gram_terms", "pairwise_similarity", "user_means",
    "topk_neighbors", "merge_topk", "predict_from_neighbors",
    "recommend_topn", "mae", "rmse", "precision_recall_f1",
    "topn_precision_recall", "SlopeOne",
]
