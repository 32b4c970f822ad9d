"""LM-family transformer, dense GQA path: prefill → decode serving and
training (port of ``repro.models.transformer``).

``Transformer`` is an ``nn.Module`` whose parameter names are the
reference's pytree paths (``embed``, ``final_norm.scale``, ``w_out`` when
untied, ``dense_layers.attn.wq.w``, ... with the layers stacked on axis
0), stored in f32 as the reference stores them, so a reference parameter
tree carries across as a flat map (``repro_torch.state.
transformer_from_reference``).

Serving (``prefill``, ``decode_step``) runs under
``torch.inference_mode()`` on a compute copy of the weights that the
module casts to ``cfg.dtype`` once, when it is built, and again on
``refresh()`` (the training steps call it after each update): the same
values as the reference's cast at every use (``_bf16``, reference
``transformer.py:334``).  ``final_norm.scale`` stays f32 and the logits
are ``last.f32 @ embed.T.to(cfg.dtype).f32`` as in the reference.
``decode_step`` returns an updated copy of the cache and leaves the one
it was given as it was, as the reference does (its decode step donates
nothing), so two decodes from one cache branch.

Training (``loss_fn``, ``backward``) is functional on the parameter tree
and casts the f32 parameters to ``cfg.dtype`` at each use, as the
reference does, so a gradient reaches every f32 leaf (the tied
embedding's two uses sum into one).  ``cfg.remat`` runs each layer
under ``torch.utils.checkpoint``; ``cfg.microbatch`` splits the batch
and accumulates the mean gradient; ``cfg.xent_chunk`` is the chunk of
``models.common.chunked_softmax_xent``.

Attention runs through ``models.common.chunked_attention`` /
``decode_attention``, i.e. the flash-attention kernel on the card (its
plain version on the CPU, or everywhere with ``use_kernel=False``); with
a gradient, through ``FlashAttentionFn`` and the backward kernel.  MoE
and MLA configs raise ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.checkpoint import tree_flatten
from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's ``TransformerConfig`` (same fields; ``dtype`` is a
    torch dtype).  The port runs the dense GQA path only: ``moe`` /
    ``mla`` raise.  ``attn_chunk_q`` / ``attn_chunk_kv`` are the plain
    attention's query chunk and KV block (``models.common.
    chunked_attention``).  Training reads ``microbatch`` (µbatches whose
    mean gradient a step takes), ``remat`` (each layer recomputed in the
    backward) and ``xent_chunk`` (the loss's chunk of positions).
    ``remat_policy`` names what a remat'd layer may keep: ``"nothing"``,
    or the reference's ``"offload_psum"``, which offloads the layers'
    tensor-parallel psum outputs to the host; at world size 1 there is no
    psum to name, so it is taken as ``"nothing"``.  ``first_k_dense``
    counts dense layers before MoE ones and ``gather_weights_at_use``
    gathers sharded weights (world size 1 has none): read by no step."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    first_k_dense: int = 0
    gather_weights_at_use: bool = False
    microbatch: int = 1
    remat: bool = True
    remat_policy: str = "nothing"
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    xent_chunk: int = 256
    dtype: Any = torch.bfloat16

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count of the dense GQA model (the reference's
        ``param_count`` for ``moe is None and mla is None``)."""
        _require_dense(self)
        d, v, dh = self.d_model, self.vocab, self.dh
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * dh
        if self.qk_norm:
            attn += 2 * dh
        total = v * d * (1 if self.tie_embeddings else 2) + d
        total += self.n_layers * (2 * d + attn + 3 * d * self.d_ff)
        return int(total)


def _require_dense(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP Queue 1 "
            f"item 11: MoE and MLA)")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP Queue 1 "
            f"item 11: MoE and MLA)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """The reference's parameter tree (``init_params``, reference
    ``transformer.py:285``) in f32, drawn from ``generator`` (whose device
    is where the tensors are made unless ``device`` says otherwise): normal
    weights scaled by 1/√d_in, the embedding by 0.02, zero biases, unit
    norm scales, layers stacked on axis 0.  Same shapes and scales as the
    reference; not its numbers (a ``torch.Generator`` is not a JAX key)."""
    _require_dense(cfg)
    device = torch.device(device if device is not None
                          else generator.device)
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.dh

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std

    def dense_p(d_in, d_out, bias=False):
        p = {"w": normal(L, d_in, d_out, std=1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = torch.zeros((L, d_out), device=device)
        return p

    def ones(n):
        return {"scale": torch.ones((L, n), device=device)}

    attn = {"wq": dense_p(d, cfg.n_heads * dh, cfg.qkv_bias),
            "wk": dense_p(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
            "wv": dense_p(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
            "wo": dense_p(cfg.n_heads * dh, d)}
    if cfg.qk_norm:
        attn["q_norm"] = ones(dh)
        attn["k_norm"] = ones(dh)
    params: Dict[str, Any] = {
        "embed": normal(cfg.vocab, d, std=0.02),
        "final_norm": {"scale": torch.ones((d,), device=device)},
    }
    if not cfg.tie_embeddings:
        params["w_out"] = normal(d, cfg.vocab, std=1.0 / math.sqrt(d))
    params["dense_layers"] = {
        "ln1": ones(d), "ln2": ones(d), "attn": attn,
        "ffn": {"w_gate": dense_p(d, cfg.d_ff), "w_up": dense_p(d, cfg.d_ff),
                "w_down": dense_p(cfg.d_ff, d)}}
    return params


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """The decode cache, layer-major (reference ``transformer.py:628``):
    k / v (L, B, Hkv, max_len, dh) zeros and ``len`` (B,) int32."""
    _require_dense(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _dense_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN (reference ``transformer.py:434``)."""
    return cm.dense(p["w_down"],
                    cm.swiglu(cm.dense(p["w_gate"], x), cm.dense(p["w_up"], x)))


def _cache_insert(cache: torch.Tensor, new: torch.Tensor,
                  cache_len: torch.Tensor) -> torch.Tensor:
    """cache (B, H, S, D) ← new (B, H, 1, D) at each row's own position
    ``cache_len[b]``, in place (reference ``transformer.py:761``: a one-hot
    blend, which writes nothing for a row whose position is ≥ S — kept
    here by writing that row's old value back)."""
    s = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = cache_len.long().clamp(max=s - 1)
    val = torch.where((cache_len < s)[:, None, None],
                      new[:, :, 0].to(cache.dtype), cache[rows, :, pos])
    cache[rows, :, pos] = val
    return cache


def _gqa_qkv(cfg: TransformerConfig, p, x: torch.Tensor,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Hq, S, dh) and k (B, Hkv, S, dh) after RoPE, v (B, Hkv, S,
    dh): the first half of the reference's ``_gqa_attention``."""
    b, s, _ = x.shape
    dh = cfg.dh
    q = cm.dense(p["wq"], x).reshape(b, s, cfg.n_heads, dh)
    k = cm.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, dh)
    v = cm.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = cm.rmsnorm(p["q_norm"], q)
        k = cm.rmsnorm(p["k_norm"], k)
    q = cm.apply_rope(q.transpose(1, 2), positions[:, None, :],
                      cfg.rope_theta)
    k = cm.apply_rope(k.transpose(1, 2), positions[:, None, :],
                      cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _gqa_attention(cfg: TransformerConfig, p, x: torch.Tensor,
                   positions: torch.Tensor, use_kernel: bool
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill attention (reference ``transformer.py:362``):
    returns (out, {"k", "v"}) with the kv for the cache."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    out = cm.chunked_attention(q, k, v, causal=True,
                               chunk_q=min(cfg.attn_chunk_q, s),
                               chunk_kv=min(cfg.attn_chunk_kv, s),
                               use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return cm.dense(p["wo"], out), {"k": k, "v": v}


def _layer_fwd(cfg: TransformerConfig, p, x: torch.Tensor,
               positions: torch.Tensor, use_kernel: bool):
    """One pre-norm layer (reference ``transformer.py:535``)."""
    h, kv = _gqa_attention(cfg, p["attn"], cm.rmsnorm(p["ln1"], x),
                           positions, use_kernel)
    x = x + h
    x = x + _dense_ffn(p["ffn"], cm.rmsnorm(p["ln2"], x))
    return x, kv


def _layer_train(cfg: TransformerConfig, p, x: torch.Tensor,
                 positions: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    return _layer_fwd(cfg, p, x, positions, use_kernel)[0]


def hidden(cfg: TransformerConfig, params, tokens: torch.Tensor, *,
           use_kernel: bool = True) -> torch.Tensor:
    """The training forward (reference ``transformer.py:578`` without the
    cache): tokens (B, S) → final hidden (B, S, D) in ``cfg.dtype``, the
    f32 parameters cast to ``cfg.dtype`` at each use (one cast of the
    stacked layers, unbound into per-layer views), each layer under
    ``torch.utils.checkpoint`` when ``cfg.remat``."""
    _require_dense(cfg)
    dt = cfg.dtype
    b, s = tokens.shape
    x = params["embed"].to(dt)[tokens.long()]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layers = _map(lambda t: t.to(dt).unbind(0), params["dense_layers"])
    for i in range(cfg.n_layers):
        p = _map(lambda t, i=i: t[i], layers)
        if cfg.remat:
            x = checkpoint(_layer_train, cfg, p, x, positions, use_kernel,
                           use_reentrant=False)
        else:
            x = _layer_train(cfg, p, x, positions, use_kernel)
    return cm.rmsnorm(params["final_norm"], x)


def _output_weights(cfg: TransformerConfig, params) -> torch.Tensor:
    """(D, V) output weights in ``cfg.dtype`` (reference
    ``transformer.py:605``)."""
    w = params["embed"].T if cfg.tie_embeddings else params["w_out"]
    return w.to(cfg.dtype)


def loss_fn(cfg: TransformerConfig, params, batch, *,
            use_kernel: bool = True) -> torch.Tensor:
    """Mean token NLL (reference ``transformer.py:614``): batch {"tokens":
    (B, S), "labels": (B, S) with −1 ignored}."""
    h = hidden(cfg, params, batch["tokens"], use_kernel=use_kernel)
    return cm.chunked_softmax_xent(h, _output_weights(cfg, params),
                                   batch["labels"], chunk=cfg.xent_chunk)


def backward(cfg: TransformerConfig, params, batch, *,
             use_kernel: bool = True) -> torch.Tensor:
    """The loss of a train step, its gradient left in the leaves' ``.grad``
    (added to what they hold): with ``cfg.microbatch`` = m > 1 the batch
    is split into m µbatches, each one's gradient accumulated, and the
    sum and the loss divided by m (reference ``steps.py:77-101``)."""
    mb = cfg.microbatch
    with torch.enable_grad():
        if mb == 1:
            loss = loss_fn(cfg, params, batch, use_kernel=use_kernel)
            loss.backward()
            return loss.detach()
        bsz, seq = batch["tokens"].shape
        toks = batch["tokens"].reshape(mb, bsz // mb, seq)
        labs = batch["labels"].reshape(mb, bsz // mb, seq)
        total = torch.zeros((), dtype=torch.float32,
                            device=params["embed"].device)
        for t, lab in zip(toks, labs):
            loss = loss_fn(cfg, params, {"tokens": t, "labels": lab},
                           use_kernel=use_kernel)
            loss.backward()
            total = total + loss.detach()
    with torch.no_grad():
        for leaf in tree_flatten(params):
            if leaf.grad is not None:
                leaf.grad.div_(mb)
    return total / mb


class Transformer(cm.ParamTree):
    """The dense GQA transformer for serving: ``prefill`` and
    ``decode_step`` (see the module docstring)."""

    def __init__(self, cfg: TransformerConfig, params: Dict[str, Any],
                 use_kernel: bool = True):
        _require_dense(cfg)
        super().__init__(params)
        self.cfg = cfg
        self.use_kernel = use_kernel
        self._cast_weights()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def refresh(self) -> None:
        """Cast the compute copy again from the parameters (after a
        training update)."""
        self._cast_weights()

    @torch.no_grad()
    def _cast_weights(self) -> None:
        """The compute-dtype copy of the weights: the embedding and every
        layer leaf in ``cfg.dtype`` (per-layer views of the stacked copy),
        the output weights as the f32 image of their ``cfg.dtype``
        rounding."""
        dt = self.cfg.dtype
        # detached: with dtype f32 ``.to`` would hand back the Parameter
        # itself, which assigning here would register a second time
        self._embed = self.embed.detach().to(dt)
        w_out = self.embed.T if self.cfg.tie_embeddings else self.w_out
        self._w_out = w_out.detach().to(dt).float()
        stacked = _map(lambda t: t.detach().to(dt), self.dense_layers.tree())
        self._layers = [_map(lambda t, i=i: t[i], stacked)
                        for i in range(self.cfg.n_layers)]

    def output_weights(self) -> torch.Tensor:
        """(D, V) output weights in ``cfg.dtype`` (reference
        ``transformer.py:605``), here as their f32 image."""
        return self._w_out

    def forward(self, tokens: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """tokens (B, S) → final hidden (B, S, D) (reference
        ``transformer.py:578``); with ``cache`` each layer's k / v go to
        ``cache[...][layer, :, :, :S]`` (the reference collects them and
        ``prefill`` copies them in: the same values)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        x = self._embed[tokens.long()]
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        for i, p in enumerate(self._layers):
            x, kv = _layer_fwd(self.cfg, p, x, positions, self.use_kernel)
            if cache is not None:
                cache["k"][i, :, :, :s] = kv["k"]
                cache["v"][i, :, :, :s] = kv["v"]
        return cm.rmsnorm({"scale": self.final_norm.scale}, x)

    # -- serving -----------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """Run the prompt; return (last-position logits (B, V) f32, the
        populated cache) (reference ``transformer.py:658``)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        max_len = max_len or s
        cache = init_cache(self.cfg, b, max_len, self.cfg.dtype, self.device)
        h = self.forward(tokens, cache)
        logits = h[:, -1].float() @ self.output_weights()
        cache["len"].fill_(s)
        return logits, cache

    def _gqa_decode_layer(self, p, x: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor
                          ) -> torch.Tensor:
        """One token's attention against the layer's cache (reference
        ``transformer.py:693``); writes the token's k / v into the cache."""
        cfg = self.cfg
        b = x.shape[0]
        dh = cfg.dh
        pos = cache_len[:, None]                                  # (B, 1)
        q = cm.dense(p["wq"], x).reshape(b, 1, cfg.n_heads, dh)
        k = cm.dense(p["wk"], x).reshape(b, 1, cfg.n_kv_heads, dh)
        v = cm.dense(p["wv"], x).reshape(b, 1, cfg.n_kv_heads, dh)
        if cfg.qk_norm:
            q = cm.rmsnorm(p["q_norm"], q)
            k = cm.rmsnorm(p["k_norm"], k)
        q = cm.apply_rope(q.transpose(1, 2), pos[:, None, :], cfg.rope_theta)
        k = cm.apply_rope(k.transpose(1, 2), pos[:, None, :], cfg.rope_theta)
        _cache_insert(k_cache, k, cache_len)
        _cache_insert(v_cache, v.transpose(1, 2), cache_len)
        out = cm.decode_attention(q, k_cache, v_cache, cache_len + 1,
                                  use_kernel=self.use_kernel)
        return cm.dense(p["wo"], out.transpose(1, 2).reshape(b, 1, -1))

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict[str, torch.Tensor]):
        """One token for every sequence: tokens (B, 1) → (logits (B, V) f32,
        a new cache holding the tokens' k / v with ``len`` advanced)
        (reference ``transformer.py:776``).  ``cache`` is left as it was."""
        tokens = torch.as_tensor(tokens, device=self.device)
        cache_len = cache["len"]
        new_cache = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                     "len": cache_len + 1}
        x = self._embed[tokens.long()]
        for i, p in enumerate(self._layers):
            att = self._gqa_decode_layer(p["attn"], cm.rmsnorm(p["ln1"], x),
                                         new_cache["k"][i],
                                         new_cache["v"][i], cache_len)
            x = x + att
            x = x + _dense_ffn(p["ffn"], cm.rmsnorm(p["ln2"], x))
        x = cm.rmsnorm({"scale": self.final_norm.scale}, x)
        logits = x[:, 0].float() @ self.output_weights()
        return logits, new_cache
