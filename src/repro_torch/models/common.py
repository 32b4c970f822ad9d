"""Shared building blocks (port of ``repro.models.common``): dense layers
and MLPs (with their initialisers, for the recsys family), RMSNorm,
rotary embeddings, SwiGLU and the two attention entry points.

The reference's ``chunked_attention`` (an XLA online softmax over KV
chunks) is what its Pallas flash kernel replaces on the chip ("same math,
same oracle"); here both ``chunked_attention`` and ``decode_attention``
route through ``repro_torch.kernels.flash_attention``: the CUDA kernel on
a CUDA tensor, its plain version on a CPU tensor or when the caller
passes ``use_kernel=False``.  There is no sharding context: the port runs
at world size 1.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)

__all__ = ["NEG_INF", "ParamTree", "CTRModel", "dense_init", "dense", "mlp_init", "mlp", "rmsnorm", "rope_freqs", "apply_rope",
           "chunked_attention", "decode_attention", "swiglu",
           "count_params"]


class ParamTree(nn.Module):
    """A nested dict (or list) of tensors as submodules and parameters, so
    that ``named_parameters()`` gives the reference's dotted pytree paths
    (a list's items under "0", "1", ...).  The tensors are held as they
    are, without a copy; ``tree()`` gives the nested dict / list back."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        for name, val in (enumerate(tree) if self._is_list
                          else tree.items()):
            if isinstance(val, (dict, list, tuple)):
                self.add_module(str(name), ParamTree(val))
            else:
                self.register_parameter(
                    str(name), nn.Parameter(val, requires_grad=False))

    def tree(self):
        out: Dict[str, Any] = dict(self._parameters)
        for name, mod in self._modules.items():
            out[name] = mod.tree()
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


class CTRModel(ParamTree):
    """A recsys CTR model for serving: the reference's parameter tree as
    parameters, ``forward`` and ``retrieval_score`` on a batch of numpy
    arrays or tensors (moved to the parameters' device) under
    ``torch.inference_mode()``.  A subclass names its module's functions
    as ``forward_fn`` and ``retrieval_fn`` (``fn(cfg, params, batch)``)."""

    forward_fn = None
    retrieval_fn = None

    def __init__(self, cfg, params: Dict[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {key: torch.as_tensor(val, device=self.device)
                for key, val in batch.items()}

    @torch.inference_mode()
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.forward_fn(self.cfg, self.tree(), self._batch(batch))

    @torch.inference_mode()
    def retrieval_score(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.retrieval_fn(self.cfg, self.tree(), self._batch(batch))


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               scale: float | None = None, device=None):
    """{"w": (d_in, d_out) normal · scale (default 1/√d_in)[, "b": zeros]}
    (reference ``common.py:31``), drawn from ``generator`` on its device
    unless ``device`` says otherwise.  Same shapes and scales as the
    reference; not its numbers (a ``torch.Generator`` is not a JAX key)."""
    device = torch.device(device if device is not None
                          else generator.device)
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=generator, device=device,
                          dtype=dtype) * std}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ p["w"] (+ p["b"])`` (reference ``common.py:52``)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(generator: torch.Generator, dims: Sequence[int], *,
             bias: bool = True, dtype=torch.float32, device=None):
    """{"l0": dense, "l1": dense, ...} for ``dims[i] → dims[i + 1]``
    (reference ``common.py:56``)."""
    return {f"l{i}": dense_init(generator, dims[i], dims[i + 1], bias=bias,
                                dtype=dtype, device=device)
            for i in range(len(dims) - 1)}


def mlp(p, x: torch.Tensor, *, act=F.relu, final_act=None) -> torch.Tensor:
    """Dense layers ``l0 .. l{n−1}`` with ``act`` between them and
    ``final_act`` (if any) after the last (reference ``common.py:69``)."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


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
    """Parameter count of a nested dict / list of tensors or of an
    ``nn.Module``."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel())
