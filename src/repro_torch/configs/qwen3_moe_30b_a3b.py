"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; MoE 128e top-8, GQA kv=4, QK-norm]."""

import dataclasses
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936, qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, n_shared=0,
                  norm_topk_prob=True))


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512, remat=False, dtype=torch.float32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=0),
        attn_chunk_q=16, attn_chunk_kv=16, xent_chunk=16)


ARCH = ArchSpec(name="qwen3-moe-30b-a3b", kind="lm", config=CONFIG,
                optimizer="adamw", shapes=lm_shapes(full_attention=True),
                smoke_config=smoke_config)
