"""Data substrate of the port: the synthetic MovieLens-1M surrogate, the
graph substrate and neighbor sampler, and the model families' seeded
batches."""

from repro_torch.data.batches import (bert4rec_batch, candidates, lm_batch,
                                      recsys_batch)
from repro_torch.data.graph import (GraphSpec, NeighborSampler,
                                    molecules_batch, synthetic_graph)
from repro_torch.data.movielens import (MovieLensSpec, generate_ratings,
                                        load_ml1m_synthetic, train_test_split)

__all__ = ["MovieLensSpec", "generate_ratings", "load_ml1m_synthetic",
           "train_test_split", "GraphSpec", "NeighborSampler",
           "molecules_batch", "synthetic_graph", "lm_batch", "recsys_batch",
           "bert4rec_batch", "candidates"]
