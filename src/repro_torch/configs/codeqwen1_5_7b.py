"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B; dense, MHA (kv=32), QKV bias]."""

import dataclasses
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=32, head_dim=128, d_ff=13440, vocab=92416, qkv_bias=True,
    rope_theta=1_000_000.0)


def smoke_config() -> TransformerConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, remat=False, dtype=torch.float32,
        attn_chunk_q=16, attn_chunk_kv=16, xent_chunk=16)


ARCH = ArchSpec(name="codeqwen1.5-7b", kind="lm", config=CONFIG,
                optimizer="adamw", shapes=lm_shapes(full_attention=True),
                smoke_config=smoke_config)
