"""BERT4Rec [arXiv:1904.06690; d=64, 2 blocks, 2 heads, seq 200]."""

import dataclasses

from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.models.bert4rec import BERT4RecConfig

CONFIG = BERT4RecConfig()


def smoke_config() -> BERT4RecConfig:
    return dataclasses.replace(CONFIG, n_items=100, embed_dim=16,
                               n_blocks=2, n_heads=2, seq_len=16,
                               mask_token=100)


ARCH = ArchSpec(name="bert4rec", kind="recsys", config=CONFIG,
                optimizer="adamw", shapes=RECSYS_SHAPES,
                smoke_config=smoke_config, model="bert4rec")
