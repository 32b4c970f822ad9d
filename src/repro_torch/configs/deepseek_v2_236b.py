"""DeepSeek-V2-236B [arXiv:2405.04434; MLA kv_lora=512, MoE 2 shared + 160
routed top-6, first layer dense]."""

import dataclasses
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer import (MLAConfig, MoEConfig,
                                            TransformerConfig)

CONFIG = TransformerConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=12288, vocab=102400, first_k_dense=1,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536, n_shared=2,
                  norm_topk_prob=False, routed_scaling_factor=16.0))


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, first_k_dense=1, remat=False, dtype=torch.float32,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=2,
                      norm_topk_prob=False, routed_scaling_factor=16.0),
        attn_chunk_q=16, attn_chunk_kv=16, xent_chunk=16)


ARCH = ArchSpec(name="deepseek-v2-236b", kind="lm", config=CONFIG,
                optimizer="adamw", shapes=lm_shapes(full_attention=True),
                smoke_config=smoke_config)
