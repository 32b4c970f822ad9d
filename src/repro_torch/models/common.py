"""Shared building blocks of the LM family (port of
``repro.models.common``): dense layers, RMSNorm, rotary embeddings,
SwiGLU and the two attention entry points.

The reference's ``chunked_attention`` (an XLA online softmax over KV
chunks) is what its Pallas flash kernel replaces on the chip ("same math,
same oracle"); here both ``chunked_attention`` and ``decode_attention``
route through ``repro_torch.kernels.flash_attention``: the CUDA kernel on
a CUDA tensor, its plain version on a CPU tensor or when the caller
passes ``use_kernel=False``.  There is no sharding context: the port runs
at world size 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)

__all__ = ["NEG_INF", "dense", "rmsnorm", "rope_freqs", "apply_rope",
           "chunked_attention", "decode_attention", "swiglu",
           "count_params"]


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ p["w"] (+ p["b"])`` (reference ``common.py:52``)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype (reference ``common.py:85``).
    ``torch.rsqrt`` on the CPU may differ from XLA's by an ulp; the parity
    tests hold the result within their stated tolerance."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * p["scale"]).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in f32 (reference ``common.py:107``)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (..., S) int (reference
    ``common.py:112``): the two halves rotated in f32, cast back."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: float | None = None,
                      chunk_q: int = 1024, chunk_kv: int = 1024,
                      use_kernel: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Skv, d|dv) → (B, Hq, Sq, dv),
    queries aligned to the end of the keys (reference ``common.py:126``).
    ``chunk_q`` / ``chunk_kv`` are the plain version's query chunk and KV
    block, as they are the reference's XLA path's; the kernel tiles on its
    own, as the reference's Pallas kernel does."""
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 block_q=chunk_q, block_kv=chunk_kv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: float | None = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """Single-token decode (reference ``common.py:200``).  q: (B, Hq, 1, d);
    caches (B, Hkv, S, d); positions ≥ ``cache_len[b]`` are masked — the
    flash kernel with ``kv_len=cache_len``."""
    fn = flash_attention if use_kernel else flash_attention_plain
    return fn(q, k_cache, v_cache, causal=True, scale=scale,
              kv_len=cache_len.to(torch.int32).contiguous())


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def count_params(params) -> int:
    """Parameter count of a nested dict of tensors or of an ``nn.Module``."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())
