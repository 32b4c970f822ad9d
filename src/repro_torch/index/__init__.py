"""Clustered candidate generation (port of ``repro.index``).

``ClusteredIndex`` partitions users with blocked spill k-means and answers
neighbor queries through the fused device chain — probe, proxy shortlist,
exact co-rated rerank — with true similarity scores
(``CFEngine(neighbor_mode="approx")``).  ``ItemClusteredIndex`` clusters
the item columns and serves the two-stage recommend path — support-scorer
shortlist, exact rerank (``CFEngine(recommend_mode="approx")``).
"""

from repro_torch.index.clustered import (ClusteredIndex, IndexConfig,
                                         QueryStats, RefoldStats)
from repro_torch.index.item_index import (ItemClusteredIndex,
                                          ItemIndexConfig, RecommendStats)
from repro_torch.index.kmeans import KMeansStats, center_rows, kmeans

__all__ = ["ClusteredIndex", "IndexConfig", "ItemClusteredIndex",
           "ItemIndexConfig", "KMeansStats", "QueryStats", "RecommendStats",
           "RefoldStats", "center_rows", "kmeans"]
