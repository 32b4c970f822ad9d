"""Data substrate of the port: the synthetic MovieLens-1M surrogate."""

from repro_torch.data.movielens import (MovieLensSpec, generate_ratings,
                                        load_ml1m_synthetic, train_test_split)

__all__ = ["MovieLensSpec", "generate_ratings", "load_ml1m_synthetic",
           "train_test_split"]
