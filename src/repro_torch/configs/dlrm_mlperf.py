"""DLRM MLPerf [arXiv:1906.00091; Criteo-1TB tables, dot interaction]."""

import dataclasses

from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig()      # exact MLPerf numbers are the dataclass defaults


def smoke_config() -> DLRMConfig:
    return dataclasses.replace(
        CONFIG, field_sizes=(9000, 50, 10000, 3, 120), embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(64, 1), n_shards=8)


ARCH = ArchSpec(name="dlrm-mlperf", kind="recsys", config=CONFIG,
                optimizer="adagrad", shapes=RECSYS_SHAPES,
                smoke_config=smoke_config, model="dlrm")
