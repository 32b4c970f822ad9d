"""The paper's own architecture: mesh-parallel user-based CF on MovieLens
(port of ``repro.configs.cf_movielens``).

``fit_ml1m`` is the paper's scale (users padded 6040 → 6144 so the user
axis divides a 512-rank mesh); ``fit_1m_users`` is the production-scale
cell that motivates the ring engine (2^20 users never fit one device).
"""

import dataclasses

from repro_torch.configs.registry import CF_SHAPES, ArchSpec
from repro_torch.core.cf_model import CFConfig

CONFIG = CFConfig(measure="pcc", top_k=40, engine="ring", block_size=1024)


def smoke_config() -> CFConfig:
    return dataclasses.replace(CONFIG, top_k=8, block_size=64,
                               engine="sequential")


ARCH = ArchSpec(name="cf-movielens", kind="cf", config=CONFIG,
                optimizer="sgd", shapes=CF_SHAPES,
                smoke_config=smoke_config)
