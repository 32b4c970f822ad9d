"""xDeepFM [arXiv:1803.05170; CIN 200-200-200, DNN 400-400]."""

import dataclasses

from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.models.xdeepfm import XDeepFMConfig

CONFIG = XDeepFMConfig()


def smoke_config() -> XDeepFMConfig:
    return dataclasses.replace(
        CONFIG, field_sizes=(9000, 50, 10000, 3, 120), embed_dim=8,
        cin_layers=(16, 16), mlp=(32,), n_shards=8, candidate_field=2,
        retrieval_chunk=64)


ARCH = ArchSpec(name="xdeepfm", kind="recsys", config=CONFIG,
                optimizer="adagrad", shapes=RECSYS_SHAPES,
                smoke_config=smoke_config, model="xdeepfm")
