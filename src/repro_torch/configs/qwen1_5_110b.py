"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B family; dense, GQA kv=8, QKV bias]."""

import dataclasses
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, head_dim=128, d_ff=49152, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, remat=False, dtype=torch.float32,
        attn_chunk_q=16, attn_chunk_kv=16, xent_chunk=16)


ARCH = ArchSpec(name="qwen1.5-110b", kind="lm", config=CONFIG,
                optimizer="adamw", shapes=lm_shapes(full_attention=True),
                smoke_config=smoke_config)
