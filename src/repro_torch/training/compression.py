"""Gradient compression: int8 quantised all-reduce with error feedback
(port of ``repro.training.compression``).

Per-tensor-scaled int8 cuts an all-reduce's bytes 4× (f32) / 2× (bf16);
error feedback keeps the quantisation residual in param-shaped f32
buffers and adds it back before the next quantisation, which restores
convergence to within noise of the uncompressed run.

Usage: wrap grads between the backward and ``optimizer.update``::

    residual = init_compression(params)
    grads, residual = compress_decompress(grads, residual)

``compressed_psum`` is the collective itself over ``torch.distributed``:
an int32 SUM ``all_reduce`` of the int8 codes and a MAX ``all_reduce`` of
the scale.  Rounding is half to even, as ``jnp.round`` and
``torch.round`` both do.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.checkpoint import tree_flatten, tree_unflatten


def init_compression(params: Any) -> Any:
    """Error-feedback residual buffers (zero-init, param-shaped, f32)."""
    return tree_unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                   for p in tree_flatten(params)])


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_decompress(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Simulate the int8 all-reduce path with error feedback: returns
    (decompressed grads to feed the optimizer, new residuals), new
    tensors in the trees' structure.  The quantise / dequantise pair is
    what each participant applies around the int8 collective; the
    residual keeps what int8 lost."""
    new_g, new_r = [], []
    for g, r in zip(tree_flatten(grads), tree_flatten(residual)):
        g32 = g.to(torch.float32) + r
        deq = _dequantize(*_quantize(g32))
        new_g.append(deq.to(g.dtype))
        new_r.append(g32 - deq)
    return tree_unflatten(grads, new_g), tree_unflatten(residual, new_r)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 quantised sum of ``x`` over ``group`` (default: the default
    process group): every rank's int8 codes summed as int32 and scaled by
    the largest rank's scale (a shared conservative scale)."""
    q, scale = _quantize(x.to(torch.float32))
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    return (qsum.to(torch.float32) * smax).to(x.dtype)
