"""EGNN [arXiv:2102.09844; 4 layers, hidden 64, E(n)-equivariant]."""

import dataclasses

from repro_torch.configs.registry import ArchSpec, GNN_SHAPES
from repro_torch.models.egnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_feat=1433,
                    d_out=47)       # ogbn-products has 47 classes (max)


def smoke_config() -> EGNNConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, d_feat=16,
                               d_out=4)


ARCH = ArchSpec(name="egnn", kind="gnn", config=CONFIG, optimizer="adamw",
                shapes=GNN_SHAPES, smoke_config=smoke_config)
