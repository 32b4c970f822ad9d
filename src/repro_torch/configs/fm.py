"""Factorization Machine [Rendle ICDM'10; 39 fields, k=10, sum-square]."""

import dataclasses

from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.models.fm import FMConfig

CONFIG = FMConfig()


def smoke_config() -> FMConfig:
    return dataclasses.replace(
        CONFIG, field_sizes=(9000, 50, 10000, 3, 120), embed_dim=8,
        n_shards=8, candidate_field=2)


ARCH = ArchSpec(name="fm", kind="recsys", config=CONFIG,
                optimizer="adagrad", shapes=RECSYS_SHAPES,
                smoke_config=smoke_config, model="fm")
