"""Shared building blocks (port of ``repro.models.common``): dense layers
and MLPs (with their initialisers, for the recsys family), RMSNorm and
LayerNorm, rotary embeddings, SwiGLU and GELU, the two attention entry
points and the chunked cross-entropy of LM training.

The reference's ``chunked_attention`` (an XLA online softmax over KV
chunks) is what its Pallas flash kernel replaces on the chip ("same math,
same oracle"); here both ``chunked_attention`` and ``decode_attention``
route through ``repro_torch.kernels.flash_attention``: the CUDA kernel on
a CUDA tensor, its plain version on a CPU tensor or when the caller
passes ``use_kernel=False``.  When a gradient is needed,
``chunked_attention`` goes through ``FlashAttentionFn``, whose backward is
the hand-written backward kernel on the card.

``ShardingCtx`` is the reference's logical-axis → mesh-axis map that the
models thread through their forwards, holding a ``DeviceMesh``;
``NO_SHARDING`` turns it off.  ``dense_specs`` / ``mlp_specs`` give the
``PartitionSpec`` trees of ``dense_init`` / ``mlp_init``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import P
from repro_torch.kernels.flash_attention import (NEG_INF, FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_plain)

__all__ = ["NEG_INF", "Initializer", "ParamTree", "CTRModel", "dense_init",
           "dense_specs", "dense", "mlp_init", "mlp_specs", "mlp",
           "rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm",
           "rope_freqs", "apply_rope", "chunked_attention",
           "decode_attention", "merge_by_lse", "merge_by_lse_parts",
           "chunked_softmax_xent", "order_slots",
           "global_mean", "bce_with_logits", "swiglu", "gelu",
           "count_params", "ShardingCtx", "NO_SHARDING"]

# an initializer, as ``jax.nn.initializers.Initializer``: (generator,
# shape, dtype) → tensor
Initializer = Callable[..., torch.Tensor]


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
    """A recsys CTR model: the reference's parameter tree as parameters,
    ``forward`` and ``retrieval_score`` on a batch of numpy arrays or
    tensors (moved to the parameters' device) under
    ``torch.inference_mode()``, and ``loss`` with grad enabled (the
    training steps take the gradient of the parameter tree).  A subclass
    names its module's functions as ``forward_fn``, ``retrieval_fn`` and
    ``loss_fn`` (``fn(cfg, params, batch)``)."""

    forward_fn = None
    retrieval_fn = None
    loss_fn = None

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

    @torch.enable_grad()
    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The training loss (a 0-d f32 tensor) on the parameters as they
        are; a gradient reaches the leaves that require one."""
        return self.loss_fn(self.cfg, self.tree(), self._batch(batch))


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


def dense_specs(*, bias: bool = False, w_spec=P(None, None)):
    """The spec tree of ``dense_init`` (reference ``common.py:41``): the
    bias follows the weight's output dimension."""
    p = {"w": w_spec}
    if bias:
        p["b"] = P(w_spec[-1])
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


def mlp_specs(n_layers: int, *, bias: bool = True, w_spec=P(None, None)):
    """The spec tree of ``mlp_init`` (reference ``common.py:64``)."""
    return {f"l{i}": dense_specs(bias=bias, w_spec=w_spec)
            for i in range(n_layers)}


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


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    """{"scale": ones (d,)} (reference ``common.py:82``)."""
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype (reference ``common.py:85``).
    ``torch.rsqrt`` on the CPU may differ from XLA's by an ulp; the parity
    tests hold the result within their stated tolerance."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * p["scale"]).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    """{"scale": ones (d,), "bias": zeros (d,)} (reference ``common.py:93``)."""
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 with the reference's eps 1e-6 (torch's default is
    1e-5), cast back to x's dtype (reference ``common.py:97``)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


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
    own, as the reference's Pallas kernel does.  When a gradient is
    needed (grad enabled and q, k or v requiring one) the kernel goes
    through ``FlashAttentionFn``, whose backward is the backward kernel;
    the plain version is differentiated by autograd."""
    if use_kernel:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal, scale)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 block_q=chunk_q, block_kv=chunk_kv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: float | None = None, use_kernel: bool = True,
                     offset: int = 0, return_lse: bool = False):
    """Single-token decode (reference ``common.py:200``).  q: (B, Hq, 1, d);
    caches (B, Hkv, S, d); positions ≥ ``cache_len[b]`` are masked — the
    flash kernel with ``kv_len=cache_len``.

    The sequence-shard form: the caches hold positions ``offset`` …
    ``offset + S − 1`` of a longer cache (one shard of flash-decoding's
    split over the sequence), so the kernel's ``kv_len`` is the shard's
    own count of visible keys, clamp(cache_len − offset, 0, S) — a
    one-row query sees every key below its ``kv_len``, so no other
    alignment enters.  A shard with no visible key gives 0 and an lse of
    ``NEG_INF``.  With ``return_lse`` it returns (out, lse (B, Hq, 1)
    f32), the pieces :func:`merge_by_lse` combines."""
    fn = flash_attention if use_kernel else flash_attention_plain
    kv_len = cache_len
    if offset:
        kv_len = (cache_len.long() - offset).clamp(0, k_cache.shape[2])
    return fn(q, k_cache, v_cache, causal=True, scale=scale,
              kv_len=kv_len.to(torch.int32).contiguous(),
              return_lse=return_lse)


def _merge(outs: torch.Tensor, lses: torch.Tensor, reduce_max,
           reduce_sum) -> torch.Tensor:
    """The weighted mean of partial outputs by exp(lse − max lse): ``outs``
    (..., dv) and ``lses`` (...) summed over the shards by the two
    reductions; f32 throughout.  A shard with no visible key (lse at
    ``NEG_INF``, its output 0) weighs 0; where every shard is empty, each
    weighs 1 and the mean is 0."""
    m = reduce_max(lses)
    w = torch.where(lses == m, 1.0, torch.exp(lses - m))
    return reduce_sum(outs.float() * w[..., None]) / reduce_sum(w)[..., None]


def merge_by_lse(out: torch.Tensor, lse: torch.Tensor, mesh,
                 axis) -> torch.Tensor:
    """The attention output of the whole sequence from this rank's
    partial one, ``out`` (..., dv) over its shard of the keys with its
    log-sum-exp ``lse`` (...) (:func:`decode_attention` with
    ``return_lse``), merged over the ranks of ``axis`` of ``mesh``: the
    max lse and the weighted sums all-reduced over the axis, in f32, and
    cast to ``out``'s dtype once, after the merge.  On an axis of one
    rank, ``out`` itself."""
    if coll.axis_size(mesh, axis) == 1:
        return out
    merged = _merge(out, lse, lambda t: coll.all_reduce_max(t, mesh, axis),
                    lambda t: coll.all_reduce_sum(t, mesh, axis))
    return merged.to(out.dtype)


def merge_by_lse_parts(outs: Sequence[torch.Tensor],
                       lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`merge_by_lse` on one rank: the partial outputs of a list of
    sequence shards, with their lses, merged in list order."""
    merged = _merge(torch.stack([o.float() for o in outs]),
                    torch.stack(list(lses)),
                    lambda t: t.amax(0), lambda t: t.sum(0))
    return merged.to(outs[0].dtype)


def _xent_chunk(hh: torch.Tensor, w32: torch.Tensor, ll: torch.Tensor,
                mesh=None, axis=None):
    """(Σ NLL, count) of one chunk: f32 logits, labels −1 ignored.  With
    ``axis`` (a mesh axis of several ranks) ``w32`` is this rank's slice
    of the vocabulary and the log-sum-exp and the gold logit are summed
    over the axis: the vocab-parallel cross-entropy."""
    logits = hh.float() @ w32
    valid = (ll >= 0).float()
    if axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            ll.clamp_min(0).long()[..., None])[..., 0]
        return torch.sum((lse - gold) * valid), torch.sum(valid)
    v_loc = logits.shape[-1]
    m = coll.all_reduce_max(logits.detach().amax(-1), mesh, axis)
    sumexp = coll.reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                              mesh, axis)
    lse = torch.log(sumexp) + m
    lab = ll.long() - coll.axis_rank(mesh, axis) * v_loc
    mine = (lab >= 0) & (lab < v_loc)
    gold = torch.gather(logits, -1, lab.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = coll.reduce_from(torch.where(mine, gold, 0.0), mesh, axis)
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_softmax_xent(h: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 256,
                         spec=None, sc=None) -> torch.Tensor:
    """Mean token NLL without materialising (B, S, V) logits (reference
    ``common.py:227``).  ``h``: (B, S, D) final hidden states; ``w_out``:
    (D, V); ``labels``: (B, S) int with −1 = ignore.  S is taken in
    chunks of ``chunk`` positions, each with f32 logits (TF32 off, as the
    package pins it) under ``torch.utils.checkpoint``, so a chunk's
    logits are recomputed in the backward and never stored, as the
    reference's ``jax.checkpoint`` ensures.

    With an enabled ``sc`` (a ``ShardingCtx``) the inputs are this rank's
    shards: ``h`` its batch rows, ``w_out`` its slice of the vocabulary
    along the mesh axis that ``spec``'s last entry names (the reference's
    vocab-sharded logits), and the mean is over every rank's valid tokens
    (:func:`global_mean` over ``sc.batch``)."""
    b, s, _ = h.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"S={s} must divide chunk={c}")
    mesh = axis = None
    if sc is not None and sc.enabled:
        mesh = sc.mesh
        if spec is not None and sc.size(spec[-1]) > 1:
            axis = spec[-1]
            h = coll.copy_to(h, mesh, axis)
    w32 = w_out.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, s, c):
        hh, ll = h[:, s0:s0 + c], labels[:, s0:s0 + c]
        if torch.is_grad_enabled():
            part, n = checkpoint(_xent_chunk, hh, w32, ll, mesh, axis,
                                 use_reentrant=False)
        else:
            part, n = _xent_chunk(hh, w32, ll, mesh, axis)
        tot = tot + part
        cnt = cnt + n
    if mesh is None:
        return tot / torch.clamp_min(cnt, 1.0)
    return global_mean(tot, cnt, mesh, sc.batch)


def order_slots(keys: torch.Tensor) -> torch.Tensor:
    """Each entry's slot among the entries of equal key: the number of
    earlier entries with its key — the reference's one-hot cumsum,
    ``(cumsum(onehot, 0) * onehot).sum(-1) - 1``, as a stable sort: an
    entry's rank among equal keys is its index in the sorted order less
    the first index of its key.  The same integers, without the (N, K)
    scan (the MoE's expert slots, the exchange's bucket slots)."""
    sorted_k, order = torch.sort(keys, stable=True)
    rank = torch.arange(keys.shape[0], device=keys.device) \
        - torch.searchsorted(sorted_k, sorted_k)
    return torch.empty_like(rank).scatter_(0, order, rank)


def global_mean(total: torch.Tensor, count: torch.Tensor, mesh,
                axes) -> torch.Tensor:
    """The mean over every rank's rows along ``axes`` of ``mesh``:
    ``total`` is this rank's (differentiable) sum and ``count`` its number
    of rows.  The value is the global mean on every rank; the gradient is
    this rank's share, total / (count summed over the ranks), so that the
    ranks' gradients summed over ``axes`` are the global mean's.  On one
    rank it is ``total / max(count, 1)``."""
    count_all = coll.all_reduce_sum(count.detach(), mesh, axes)
    share = total / torch.clamp_min(count_all, 1.0)
    value = coll.all_reduce_sum(share.detach(), mesh, axes)
    return share + (value - share.detach())


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy in the recsys models' stable form,
    max(z, 0) − z·y + log1p(exp(−|z|)) (reference ``dlrm.py:112``), not
    ``F.binary_cross_entropy_with_logits``, whose rounding differs.  With
    ``mesh`` the rows are this rank's batch shard and the mean is over
    every rank's (:func:`global_mean` over all mesh axes)."""
    y = labels.float()
    loss = torch.clamp_min(logits, 0) - logits * y \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    if mesh is None:
        return torch.mean(loss)
    n = torch.tensor(float(loss.numel()), device=loss.device)
    return global_mean(loss.sum(), n, mesh, mesh.mesh_dim_names)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (not torch's
    default erf form)."""
    return F.gelu(x, approximate="tanh")


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


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Logical-axis → mesh-axis mapping threaded through the models
    (reference ``common.py:275``): ``batch`` the data-parallel axes of
    activations, ``model`` the tensor / expert / vocab axis, ``fsdp`` the
    axis parameters are split over, ``mesh`` the ``DeviceMesh``.  The
    models run on each rank's local shards with the collectives of
    ``repro_torch.distributed.collectives`` over these axes (the reference
    states layouts and lets GSPMD insert them); ``constrain`` is the
    reference's layout hint for a DTensor."""
    batch: tuple | str | None = ("pod", "data")
    model: str | None = "model"
    fsdp: str | None = "data"
    enabled: bool = True
    mesh: object | None = None

    def constrain(self, x, *axes):
        """``x`` redistributed to ``P(*axes)`` when sharding is enabled and
        ``x`` is a DTensor; else ``x`` (the reference's
        ``with_sharding_constraint``, which changes no number)."""
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed.sharding import _sanitize, placements
        if not self.enabled or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(
            self.mesh, _sanitize(self.mesh, P(*axes))))

    def size(self, axes) -> int:
        """Ranks along ``axes`` (1 when not enabled)."""
        from repro_torch.distributed import collectives as coll
        return coll.axis_size(self.mesh, axes) if self.enabled else 1

    def rank(self, axes) -> int:
        """This rank's index along ``axes`` (0 when not enabled)."""
        from repro_torch.distributed import collectives as coll
        return coll.axis_rank(self.mesh, axes) if self.enabled else 0


NO_SHARDING = ShardingCtx(batch=None, model=None, fsdp=None, enabled=False)
