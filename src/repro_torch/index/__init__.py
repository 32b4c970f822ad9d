"""Clustered candidate generation (port of ``repro.index``, user side).

``ClusteredIndex`` partitions users with blocked spill k-means and answers
neighbor queries through the fused device chain — probe, proxy shortlist,
exact co-rated rerank — with true similarity scores.
``CFEngine(neighbor_mode="approx")`` is the integrated entry point.  The
item index (``ItemClusteredIndex``) is a later slice of the port.
"""

from repro_torch.index.clustered import (ClusteredIndex, IndexConfig,
                                         QueryStats, RefoldStats)
from repro_torch.index.kmeans import KMeansStats, center_rows, kmeans

__all__ = ["ClusteredIndex", "IndexConfig", "KMeansStats", "QueryStats",
           "RefoldStats", "center_rows", "kmeans"]
