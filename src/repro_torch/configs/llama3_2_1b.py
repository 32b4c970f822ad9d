"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; dense, GQA kv=8, tied embed]."""

import dataclasses
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
    n_kv_heads=8, head_dim=64, d_ff=8192, vocab=128256,
    tie_embeddings=True, rope_theta=500_000.0)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, remat=False, dtype=torch.float32,
        attn_chunk_q=16, attn_chunk_kv=16, xent_chunk=16)


ARCH = ArchSpec(name="llama3.2-1b", kind="lm", config=CONFIG,
                optimizer="adamw", shapes=lm_shapes(full_attention=True),
                smoke_config=smoke_config)
