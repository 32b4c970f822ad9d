"""LM-family transformer: GQA / MLA attention, dense / MoE FFN, RoPE;
prefill → decode serving and training (port of
``repro.models.transformer``).

``Transformer`` is an ``nn.Module`` whose parameter names are the
reference's pytree paths (``embed``, ``final_norm.scale``, ``w_out`` when
untied, ``dense_layers.attn.wq.w``, ``moe_layers.ffn.w_gate``, ... with
the layers of each stack on axis 0), stored in f32 as the reference
stores them, so a reference parameter tree carries across as a flat map
(``repro_torch.state.transformer_from_reference``).  A MoE model has two
stacks, ``dense_layers`` (the first ``first_k_dense``) and
``moe_layers``, run in that order.

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
a gradient, through ``FlashAttentionFn`` and the backward kernel.  MLA
(DeepSeek-V2) runs the full-rank form through that kernel in prefill and
training (q·k width ``qk_dim``, v width ``v_head_dim``) and decodes in
the absorbed form, whose cache is the (c_kv, k_rope) latent and whose
f32 products are plain torch, as the reference's are.  The MoE FFN has
the reference's two branches (unsharded, and expert-parallel under a
``ShardingCtx``): the router's top-k on the selection kernel
(``kernels.select.router_topk``), capacity slotting in flat (token, k)
order, the experts as batched matmuls and each token's contributions
combined in k order.

Model parallelism (``hidden``, ``loss_fn``, ``backward`` with an enabled
``sc``): the leaves are each rank's shards by :func:`param_specs` (the
reference's: FSDP over ``data``, heads, FFN columns, experts and the
vocabulary over ``model``), the batch is sharded over the batch axes, and
the forward runs on local tensors with the collectives of
``repro_torch.distributed.collectives`` written out where the
reference's GSPMD partitioner inserts them: FSDP gathers over ``data``,
Megatron's column / row split with a sum over ``model``, the
vocab-parallel embedding and cross-entropy, the MoE combine summed over
``model``.  A model whose parameters are DTensors (``meshed``) trains
through ``launch.steps``' mesh step.

Serving on a mesh (``prefill``, ``decode_step`` of a meshed model, every
rank calling): each rank runs its batch rows, and its compute copy holds
its ``model`` shards with their FSDP shards gathered over ``data`` once,
at the first serving call after a build or ``refresh()``.  Prefill is the
meshed forward above; the logits are the rank's (B_loc, V/M) vocabulary
slice.  The decode cache is placed by :func:`cache_specs`: its sequence
axis over ``model``, so ``model`` rank m of M holds positions
[m·L/M, (m+1)·L/M) of every kv head (or of the whole MLA latent).  A
decode step is flash-decoding's split over the sequence: each rank
gathers the q heads over ``model`` (one token's), attends to its own
positions (kernel 8's split decode with its log-sum-exp; MLA's absorbed
form in plain f32) and merges the ranks' partial outputs by their
log-sum-exp (``common.merge_by_lse``), then keeps its own heads for
``wo``, whose partial sums are summed over ``model``.  The new token's kv
is written by the one rank whose slice holds its position.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.checkpoint import tree_flatten
from repro_torch.distributed.sharding import (P, batch_axes, distribute,
                                              make_ctx, reduce_gradients,
                                              to_shardings)
from repro_torch.kernels.select import router_topk
from repro_torch.models import common as cm
from repro_torch.models.common import NO_SHARDING, ShardingCtx


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``: ``n_experts`` routed experts of
    hidden ``d_ff``, ``top_k`` a token, ``n_shared`` always-on experts
    (one dense FFN of hidden ``d_ff · n_shared``)."""
    n_experts: int
    top_k: int
    d_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The reference's ``MLAConfig`` (DeepSeek-V2's multi-head latent
    attention)."""
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's ``TransformerConfig`` (same fields; ``dtype`` is a
    torch dtype).  ``attn_chunk_q`` / ``attn_chunk_kv`` are the plain
    attention's query chunk and KV block (``models.common.
    chunked_attention``).  Training reads ``microbatch`` (µbatches whose
    mean gradient a step takes), ``remat`` (each layer recomputed in the
    backward) and ``xent_chunk`` (the loss's chunk of positions).
    ``remat_policy`` names what a remat'd layer may keep: ``"nothing"``,
    or the reference's ``"offload_psum"``, which offloads the layers'
    tensor-parallel psum outputs to the host; the port keeps nothing
    either way.  ``first_k_dense`` counts dense layers before MoE ones;
    ``gather_weights_at_use`` gathers a layer's FSDP shards at its use,
    inside the remat'd layer (ZeRO-3), where without it each stack's
    shards are gathered once a forward."""
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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
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

    def layer_counts(self) -> Tuple[int, int]:
        """(n_dense_layers, n_moe_layers)."""
        if self.moe is None:
            return self.n_layers, 0
        return self.first_k_dense, self.n_layers - self.first_k_dense

    def param_count(self) -> int:
        """Analytic parameter count (reference ``transformer.py:104``)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2) + d
        n_dense, n_moe = self.layer_counts()
        total += self.n_layers * 2 * d
        total += self.n_layers * self._attn_params()
        total += n_dense * 3 * d * self.d_ff
        if self.moe is not None:
            m = self.moe
            per_moe = d * m.n_experts + m.n_experts * 3 * d * m.d_ff \
                + (3 * d * (m.d_ff * m.n_shared) if m.n_shared else 0)
            total += n_moe * per_moe
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: its top-k experts and the
        shared ones only; reference ``transformer.py:121``)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        _, n_moe = self.layer_counts()
        routed_all = n_moe * m.n_experts * 3 * self.d_model * m.d_ff
        routed_act = n_moe * m.top_k * 3 * self.d_model * m.d_ff
        return int(self.param_count() - routed_all + routed_act)

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            a = self.mla
            n = 0
            if a.q_lora_rank:
                n += d * a.q_lora_rank + a.q_lora_rank
            n += (a.q_lora_rank or d) * self.n_heads * a.qk_dim
            n += d * (a.kv_lora_rank + a.qk_rope_dim) + a.kv_lora_rank
            n += a.kv_lora_rank * self.n_heads * (a.qk_nope_dim
                                                  + a.v_head_dim)
            n += self.n_heads * a.v_head_dim * d
            return n
        dh = self.dh
        n = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        if self.qkv_bias:
            n += (self.n_heads + 2 * self.n_kv_heads) * dh
        if self.qk_norm:
            n += 2 * dh
        return n


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

# (kind, parameter field) of the layer stacks, in the order they run
STACKS = (("dense", "dense_layers"), ("moe", "moe_layers"))


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """The reference's parameter tree (``init_params``, reference
    ``transformer.py:285``) in f32, drawn from ``generator`` (whose device
    is where the tensors are made unless ``device`` says otherwise): normal
    weights scaled by 1/√d_in (a MoE router and its experts' gate / up by
    1/√d_model, their down by 1/√d_ff), the embedding by 0.02, zero biases,
    unit norm scales, the layers of each stack on axis 0.  Same shapes and
    scales as the reference; not its numbers (a ``torch.Generator`` is not
    a JAX key)."""
    device = torch.device(device if device is not None
                          else generator.device)
    d = cfg.d_model

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std

    def stack(n, kind):
        def dense_p(d_in, d_out, bias=False):
            p = {"w": normal(n, d_in, d_out, std=1.0 / math.sqrt(d_in))}
            if bias:
                p["b"] = torch.zeros((n, d_out), device=device)
            return p

        def ones(width):
            return {"scale": torch.ones((n, width), device=device)}

        def ffn(d_ff):
            return {"w_gate": dense_p(d, d_ff), "w_up": dense_p(d, d_ff),
                    "w_down": dense_p(d_ff, d)}

        if cfg.mla is not None:
            a = cfg.mla
            attn = {}
            if a.q_lora_rank:
                attn["wq_a"] = dense_p(d, a.q_lora_rank)
                attn["q_a_norm"] = ones(a.q_lora_rank)
            attn["wq_b"] = dense_p(a.q_lora_rank or d, cfg.n_heads * a.qk_dim)
            attn["wkv_a"] = dense_p(d, a.kv_lora_rank + a.qk_rope_dim)
            attn["kv_a_norm"] = ones(a.kv_lora_rank)
            attn["wkv_b"] = dense_p(a.kv_lora_rank, cfg.n_heads
                                    * (a.qk_nope_dim + a.v_head_dim))
            attn["wo"] = dense_p(cfg.n_heads * a.v_head_dim, d)
        else:
            dh = cfg.dh
            attn = {"wq": dense_p(d, cfg.n_heads * dh, cfg.qkv_bias),
                    "wk": dense_p(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
                    "wv": dense_p(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
                    "wo": dense_p(cfg.n_heads * dh, d)}
            if cfg.qk_norm:
                attn["q_norm"] = ones(dh)
                attn["k_norm"] = ones(dh)
        if kind == "moe":
            m = cfg.moe
            std = 1.0 / math.sqrt(d)
            layer_ffn = {
                "router": {"w": normal(n, d, m.n_experts, std=std)},
                "w_gate": normal(n, m.n_experts, d, m.d_ff, std=std),
                "w_up": normal(n, m.n_experts, d, m.d_ff, std=std),
                "w_down": normal(n, m.n_experts, m.d_ff, d,
                                 std=1.0 / math.sqrt(m.d_ff))}
            if m.n_shared:
                layer_ffn["shared"] = ffn(m.d_ff * m.n_shared)
        else:
            layer_ffn = ffn(cfg.d_ff)
        return {"ln1": ones(d), "ln2": ones(d), "attn": attn,
                "ffn": layer_ffn}

    params: Dict[str, Any] = {
        "embed": normal(cfg.vocab, d, std=0.02),
        "final_norm": {"scale": torch.ones((d,), device=device)},
    }
    if not cfg.tie_embeddings:
        params["w_out"] = normal(d, cfg.vocab, std=1.0 / math.sqrt(d))
    for (kind, field), n in zip(STACKS, cfg.layer_counts()):
        if n:
            params[field] = stack(n, kind)
    return params


def _attn_specs(cfg: TransformerConfig):
    """Attention specs (reference ``transformer.py:189``): the input
    dimension over ``data`` (FSDP), the heads over ``model``; k and v keep
    their heads whole unless ``n_kv_heads`` divides by 16."""
    if cfg.mla is not None:
        a = cfg.mla
        p = {}
        if a.q_lora_rank:
            p["wq_a"] = {"w": P("data", None)}
            p["q_a_norm"] = {"scale": P(None)}
        p["wq_b"] = {"w": P("data", "model")}
        p["wkv_a"] = {"w": P("data", None)}
        p["kv_a_norm"] = {"scale": P(None)}
        p["wkv_b"] = {"w": P("data", "model")}
        p["wo"] = {"w": P("model", "data")}
        return p
    kv_spec = P("data", "model") if _kv_tp(cfg) else P("data", None)
    p = {"wq": cm.dense_specs(bias=cfg.qkv_bias, w_spec=P("data", "model")),
         "wk": cm.dense_specs(bias=cfg.qkv_bias, w_spec=kv_spec),
         "wv": cm.dense_specs(bias=cfg.qkv_bias, w_spec=kv_spec),
         "wo": cm.dense_specs(w_spec=P("model", "data"))}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": P(None)}
        p["k_norm"] = {"scale": P(None)}
    return p


def _dense_ffn_specs():
    """(reference ``transformer.py:224``) Megatron's column / row split."""
    return {"w_gate": {"w": P("data", "model")},
            "w_up": {"w": P("data", "model")},
            "w_down": {"w": P("model", "data")}}


def _moe_ffn_specs(cfg: TransformerConfig):
    """(reference ``transformer.py:250``) experts over ``model``, their
    hidden dimension over ``data``, the router whole."""
    p = {"router": {"w": P(None, None)},
         "w_gate": P("model", None, "data"),
         "w_up": P("model", None, "data"),
         "w_down": P("model", "data", None)}
    if cfg.moe.n_shared:
        p["shared"] = _dense_ffn_specs()
    return p


def _layer_specs(cfg: TransformerConfig, kind: str):
    """One layer's specs (reference ``transformer.py:274``)."""
    return {"ln1": {"scale": P(None)}, "ln2": {"scale": P(None)},
            "attn": _attn_specs(cfg),
            "ffn": _moe_ffn_specs(cfg) if kind == "moe"
            else _dense_ffn_specs()}


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts), with the
    matching leaves of the trees ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's specs (reference ``transformer.py:307``): the
    embedding's vocabulary over ``model`` and width over ``data``, the
    layer stacks' specs with the layer axis whole."""
    specs: Dict[str, Any] = {"embed": P("model", "data"),
                             "final_norm": {"scale": P(None)}}
    if not cfg.tie_embeddings:
        specs["w_out"] = P("data", "model")
    for (kind, field), n in zip(STACKS, cfg.layer_counts()):
        if n:
            specs[field] = _map(lambda sp: P(None, *sp),
                                _layer_specs(cfg, kind))
    return specs


def cache_specs(cfg: TransformerConfig, batch_axes=("pod", "data")
                ) -> Dict[str, Any]:
    """The decode cache's specs (reference ``transformer.py:646``): the
    batch over ``batch_axes``, the sequence axis over ``model``
    (flash-decoding's split over the sequence; :func:`place_cache`)."""
    if cfg.mla is not None:
        return {"c_kv": P(None, batch_axes, "model", None),
                "k_rope": P(None, batch_axes, "model", None),
                "len": P(batch_axes)}
    return {"k": P(None, batch_axes, None, "model", None),
            "v": P(None, batch_axes, None, "model", None),
            "len": P(batch_axes)}


def _per_layer(cfg: TransformerConfig, params,
               cast) -> List[Tuple[str, Dict[str, Any]]]:
    """[(kind, layer parameters)] for every layer, the dense stack then
    the MoE stack, each leaf ``cast`` once a stack (``cast(t, spec)``
    with the leaf's spec) and unbound into per-layer views."""
    specs = param_specs(cfg)
    out = []
    for (kind, field), n in zip(STACKS, cfg.layer_counts()):
        if n:
            stacked = _map(lambda t, sp: cast(t, sp).unbind(0),
                           params[field], specs[field])
            out += [(kind, _map(lambda t, i=i: t[i], stacked))
                    for i in range(n)]
    return out


def _seq_slice(sc: ShardingCtx, max_len: int) -> int:
    """The positions a ``model`` rank holds of a cache of ``max_len``
    (rank m the m-th run of them): ``max_len`` without sharding.  A
    ``max_len`` that does not split evenly raises, as the reference's
    sharding of its cache does."""
    n = sc.size(sc.model)
    if max_len % n:
        raise ValueError(f"a cache of {max_len} positions does not split "
                         f"over the {n} ranks of mesh axis {sc.model!r}")
    return max_len // n


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               sc: ShardingCtx = NO_SHARDING) -> Dict[str, torch.Tensor]:
    """The decode cache, layer-major (reference ``transformer.py:628``):
    GQA k / v (L, B, Hkv, max_len, dh); MLA the latent c_kv (L, B,
    max_len, kv_lora_rank) and k_rope (L, B, max_len, qk_rope_dim); all
    zeros, and ``len`` (B,) int32.  Under an enabled ``sc`` the mesh-local
    form: ``batch`` is the rank's rows and the sequence axis its
    max_len / M positions (:func:`cache_specs`)."""
    L = cfg.n_layers
    seq = _seq_slice(sc, max_len)
    if cfg.mla is not None:
        a = cfg.mla
        shapes = {"c_kv": (L, batch, seq, a.kv_lora_rank),
                  "k_rope": (L, batch, seq, a.qk_rope_dim)}
    else:
        kv = (L, batch, cfg.n_kv_heads, seq, cfg.dh)
        shapes = {"k": kv, "v": kv}
    cache = {key: torch.zeros(shape, dtype=dtype, device=device)
             for key, shape in shapes.items()}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def place_cache(cfg: TransformerConfig, cache: Dict[str, torch.Tensor],
                mesh) -> Dict[str, Any]:
    """A whole cache (the same on every rank) as DTensors placed by
    :func:`cache_specs` on ``mesh``, each rank keeping its rows and its
    ``model`` rank's positions; no collective runs.  A batch or a
    ``max_len`` that does not split evenly over its mesh axes raises
    ``ValueError`` naming them (the reference's jit refuses such a
    sharding).  :func:`gather_cache` brings it back whole."""
    baxes = batch_axes(mesh)
    sc = make_ctx(mesh)
    seq = cache["c_kv"].shape[2] if cfg.mla is not None \
        else cache["k"].shape[3]
    _seq_slice(sc, seq)
    n = sc.size(baxes)
    if cache["len"].shape[0] % n:
        raise ValueError(f"{cache['len'].shape[0]} cache rows do not split "
                         f"over the {n} ranks of mesh axes {baxes}")
    return distribute(cache, to_shardings(mesh, cache_specs(cfg, baxes)))


def gather_cache(cache: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A cache of DTensors (:func:`place_cache`, a mesh plan's output)
    gathered whole on every rank (a collective: every rank calls)."""
    from torch.distributed.tensor import DTensor
    return {key: val.full_tensor() if isinstance(val, DTensor) else val
            for key, val in cache.items()}


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _kv_tp(cfg: TransformerConfig) -> bool:
    """k / v split their heads over ``model`` (reference
    ``transformer.py:202``: only when the kv heads divide by 16)."""
    return cfg.n_kv_heads % 16 == 0


def _gather_fsdp(sc: ShardingCtx, tree, specs):
    """Each leaf's FSDP shards gathered over ``sc.fsdp`` along the
    dimension its spec names that axis on (reference ``_gw`` and
    ``local_moe``'s all-gathers); the backward sums the leaf's gradient
    over the axis.  The identity without an FSDP axis of several ranks."""
    def gather(t, spec):
        for dim, entry in enumerate(spec):
            if entry == sc.fsdp:
                return coll.gather(t, sc.mesh, sc.fsdp, dim)
        return t
    if not sc.enabled or sc.size(sc.fsdp) == 1:
        return tree
    return _map(gather, tree, specs)


def _dense_ffn(p, x: torch.Tensor,
               sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """SwiGLU FFN (reference ``transformer.py:434``); under ``sc`` the
    gate / up columns and the down rows are this rank's ``model`` slice
    (Megatron's column / row split: the partial outputs summed over
    ``model``)."""
    if sc.enabled:
        x = coll.copy_to(x, sc.mesh, sc.model)
    y = cm.dense(p["w_down"],
                 cm.swiglu(cm.dense(p["w_gate"], x), cm.dense(p["w_up"], x)))
    return coll.reduce_from(y, sc.mesh, sc.model) if sc.enabled else y


# each assignment's slot in its expert, in flat (token, k) order
_expert_slots = cm.order_slots


def _moe_ffn(cfg: TransformerConfig, p, x: torch.Tensor, *,
             use_kernel: bool = True, capacity_factor: float | None = None,
             sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """The MoE FFN (reference ``transformer.py:444``): x (B, S, D) →
    (B, S, D), in one of the reference's two branches.

    Without sharding (``sc`` not enabled) it is the unsharded branch:
    every expert on every token.  Under ``sc`` it is the expert-parallel
    branch (reference ``:459-529``, its ``shard_map`` body on this rank's
    tensors): ``x`` is the rank's token shard, replicated over ``model``;
    ``p``'s expert tensors hold the rank's E/M local experts (their FSDP
    shards already gathered over ``data``); the router runs on the
    rank's tokens, capacity comes from the local token count, and an
    assignment to an expert of another ``model`` rank takes the pad row;
    the combine is summed over ``model``.  With one ``model`` rank the
    two branches compute the same numbers.

    In both, the router's f32 softmax probabilities go through
    ``kernels.select.router_topk`` (kernel 5 on the card with
    ``use_kernel``, its plain version otherwise: ``lax.top_k``'s ids, ties
    to the lower expert).  Each (token, k) assignment, in flat order,
    takes the next slot of its expert (:func:`_expert_slots`); those past
    ``capacity`` = max(int(T·K / E · cf), 4) are dropped.  The experts'
    SwiGLU runs as batched matmuls over an (E_loc, C, D) buffer, and each
    token's K gated outputs are added in k order, ((0 + c₀) + c₁) + …,
    as the reference's scatter-add on its host, so that no atomic order
    enters the result.  Shared experts add a dense FFN."""
    m = cfg.moe
    b, s, d = x.shape
    cf = capacity_factor or m.capacity_factor
    t = b * s
    e = p["w_gate"].shape[0]                     # local experts
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]["w"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gate_vals, exp_idx = router_topk(probs, m.top_k, use_kernel=use_kernel)
    if m.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    gate_vals = gate_vals * m.routed_scaling_factor

    flat_e = exp_idx.reshape(-1).long()                          # (T·K,)
    flat_g = gate_vals.reshape(-1)
    if sc.enabled:
        # keep only the experts of this model rank; the others → pad row
        local = (flat_e // e) == sc.rank(sc.model)
        flat_e = torch.where(local, flat_e % e, e)
        flat_g = coll.copy_to(flat_g, sc.mesh, sc.model)
        xt = coll.copy_to(xt, sc.mesh, sc.model)
    pos = _expert_slots(flat_e)
    capacity = max(int(t * m.top_k / m.n_experts * cf), 4)
    keep = pos < capacity
    if sc.enabled:
        keep = keep & local
    slot_e = torch.where(keep, flat_e, e)                 # drop → pad row
    slot_p = torch.where(keep, pos, 0)

    buf = xt.new_zeros((e + 1, capacity, d)).index_put(
        (slot_e, slot_p), xt.repeat_interleave(m.top_k, dim=0))[:e]
    hh = cm.swiglu(torch.bmm(buf, p["w_gate"].to(xt.dtype)),
                   torch.bmm(buf, p["w_up"].to(xt.dtype)))
    out = torch.bmm(hh, p["w_down"].to(xt.dtype))                # (E, C, D)

    contrib = out[slot_e.clamp(0, e - 1), slot_p] \
        * flat_g[:, None].to(out.dtype)
    contrib = torch.where(keep[:, None], contrib, 0.0).reshape(t, m.top_k, d)
    y = torch.zeros((t, d), dtype=out.dtype, device=x.device)
    for k in range(m.top_k):
        y = y + contrib[:, k]
    if sc.enabled:
        y = coll.reduce_from(y, sc.mesh, sc.model)
    y = y.reshape(b, s, d)
    if m.n_shared:
        y = y + _dense_ffn(p["shared"], x, sc)
    return y


def _cache_insert(cache: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """cache (B, H, S, D) ← new (B, H, 1, D) at each row's own position
    ``pos[b]``, in place (reference ``transformer.py:761``: a one-hot
    blend, which writes nothing for a row whose position is outside
    [0, S) — kept here by writing that row's old value back; a sequence
    shard of the cache takes the positions less its first one, so only
    the shard that holds a position writes it)."""
    s = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.long().clamp(0, s - 1)
    inside = (pos >= 0) & (pos < s)
    val = torch.where(inside[:, None, None], new[:, :, 0].to(cache.dtype),
                      cache[rows, :, at])
    cache[rows, :, at] = val
    return cache


def _cache_insert_2d(cache: torch.Tensor, new: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """cache (B, S, D) ← new (B, D) at each row's position, in place, as
    :func:`_cache_insert` (reference ``transformer.py:769``)."""
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.long().clamp(0, s - 1)
    inside = (pos >= 0) & (pos < s)
    val = torch.where(inside[:, None], new.to(cache.dtype), cache[rows, at])
    cache[rows, at] = val
    return cache


def _kv_heads(cfg: TransformerConfig, sc: ShardingCtx) -> slice:
    """The kv heads this ``model`` rank's q heads read when k and v keep
    their heads whole: its q heads are global heads m·Hq/M onwards, and
    head i reads kv head i // g (g = Hq / Hkv), so the rank takes kv heads
    m·Hq/(M·g) onwards, or the one it shares with other ranks when
    Hq/M < g.  Kernel 8 then maps local q head j to local kv head j // g'
    with g' its local group."""
    n_m, m = sc.size(sc.model), sc.rank(sc.model)
    hq, g = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    if hq % n_m:
        raise ValueError(f"{hq} heads do not split over {n_m} model ranks")
    hq_loc = hq // n_m
    if hq_loc % g and g % hq_loc:
        raise ValueError(f"{hq_loc} q heads a rank straddle kv groups of "
                         f"{g}")
    first = m * hq_loc // g
    return slice(first, first + max(hq_loc // g, 1))


def _gqa_qkv(cfg: TransformerConfig, p, x: torch.Tensor,
             positions: torch.Tensor, sc: ShardingCtx = NO_SHARDING
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Hq, S, dh) and k (B, Hkv, S, dh) after RoPE, v (B, Hkv, S,
    dh): the first half of the reference's ``_gqa_attention``.  Under
    ``sc`` q's heads are this ``model`` rank's (its column slice of wq);
    k's and v's are the rank's slice when they are split (``_kv_tp``),
    else all Hkv heads, computed whole from the replicated wk and wv (the
    attention takes the ones its q heads read, :func:`_kv_heads`)."""
    b, s, _ = x.shape
    dh = cfg.dh
    tp = sc.enabled and sc.size(sc.model) > 1
    xq = coll.copy_to(x, sc.mesh, sc.model) if tp else x
    xk = xq if _kv_tp(cfg) else x
    q = cm.dense(p["wq"], xq).reshape(b, s, -1, dh)
    k = cm.dense(p["wk"], xk).reshape(b, s, -1, dh)
    v = cm.dense(p["wv"], xk).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if tp:       # replicated scales applied to this rank's heads only
            qn = {"scale": coll.copy_to(qn["scale"], sc.mesh, sc.model)}
            if _kv_tp(cfg):
                kn = {"scale": coll.copy_to(kn["scale"], sc.mesh,
                                            sc.model)}
        q = cm.rmsnorm(qn, q)
        k = cm.rmsnorm(kn, k)
    q = cm.apply_rope(q.transpose(1, 2), positions[:, None, :],
                      cfg.rope_theta)
    k = cm.apply_rope(k.transpose(1, 2), positions[:, None, :],
                      cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _gqa_attention(cfg: TransformerConfig, p, x: torch.Tensor,
                   positions: torch.Tensor, use_kernel: bool,
                   sc: ShardingCtx = NO_SHARDING
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill attention (reference ``transformer.py:362``):
    returns (out, {"k", "v"}) with the kv for the cache.  Under ``sc``
    the rank's heads, and wo's rows of them, summed over ``model``; the
    cache's kv are as :func:`_gqa_qkv` gives them (all heads, or the
    rank's slice when k and v split their heads)."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(cfg, p, x, positions, sc)
    kv = {"k": k, "v": v}
    if sc.enabled and sc.size(sc.model) > 1 and not _kv_tp(cfg):
        heads = _kv_heads(cfg, sc)
        k = coll.copy_to(k, sc.mesh, sc.model)[:, heads]
        v = coll.copy_to(v, sc.mesh, sc.model)[:, heads]
    out = cm.chunked_attention(q, k, v, causal=True,
                               chunk_q=min(cfg.attn_chunk_q, s),
                               chunk_kv=min(cfg.attn_chunk_kv, s),
                               use_kernel=use_kernel)
    out = cm.dense(p["wo"], out.transpose(1, 2).reshape(b, s, -1))
    if sc.enabled:
        out = coll.reduce_from(out, sc.mesh, sc.model)
    return out, kv


def _mla_qkv(cfg: TransformerConfig, p, x: torch.Tensor,
             positions: torch.Tensor, sc: ShardingCtx = NO_SHARDING):
    """MLA's full-rank q (B, H, S, qk_dim), k (B, H, S, qk_dim) and v (B,
    H, S, v_head_dim), and the cache's latent {"c_kv" (B, S, rank),
    "k_rope" (B, S, rope)}: the first half of the reference's
    ``_mla_attention``.  k is [k_nope | the one k_rope of all heads].
    Under ``sc`` the heads are this ``model`` rank's (wq_b's and wkv_b's
    column slices); the low-rank projections run whole on every rank."""
    a = cfg.mla
    b, s, _ = x.shape
    tp = sc.enabled and sc.size(sc.model) > 1

    def split(t):            # a replicated tensor entering the rank's heads
        return coll.copy_to(t, sc.mesh, sc.model) if tp else t

    if a.q_lora_rank:
        q_in = cm.rmsnorm(p["q_a_norm"], cm.dense(p["wq_a"], x))
    else:
        q_in = x
    q = cm.dense(p["wq_b"], split(q_in)).reshape(b, s, -1, a.qk_dim)
    h = q.shape[2]
    q_nope, q_rope = q.split([a.qk_nope_dim, a.qk_rope_dim], dim=-1)
    q_rope = cm.apply_rope(q_rope.transpose(1, 2), positions[:, None, :],
                           cfg.rope_theta).transpose(1, 2)
    c_kv, k_rope = cm.dense(p["wkv_a"], x).split(
        [a.kv_lora_rank, a.qk_rope_dim], dim=-1)
    c_kv = cm.rmsnorm(p["kv_a_norm"], c_kv)
    k_rope = cm.apply_rope(k_rope[:, None], positions[:, None, :],
                           cfg.rope_theta)                     # (B, 1, S, r)
    kv = cm.dense(p["wkv_b"], split(c_kv)).reshape(
        b, s, h, a.qk_nope_dim + a.v_head_dim)
    k_nope, v = kv.split([a.qk_nope_dim, a.v_head_dim], dim=-1)
    k = torch.cat([k_nope, split(k_rope).transpose(1, 2).expand(
        b, s, h, a.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            {"c_kv": c_kv, "k_rope": k_rope[:, 0]})


def _mla_attention(cfg: TransformerConfig, p, x: torch.Tensor,
                   positions: torch.Tensor, use_kernel: bool,
                   sc: ShardingCtx = NO_SHARDING
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLA training / prefill attention in the full-rank form (reference
    ``transformer.py:391``), scale 1/√qk_dim: returns (out, {"c_kv",
    "k_rope"}) for the cache.  Under ``sc`` the rank's heads, summed over
    ``model`` after wo."""
    a = cfg.mla
    b, s, _ = x.shape
    q, k, v, latent = _mla_qkv(cfg, p, x, positions, sc)
    out = cm.chunked_attention(q, k, v, causal=True,
                               scale=1.0 / (a.qk_dim ** 0.5),
                               chunk_q=min(cfg.attn_chunk_q, s),
                               chunk_kv=min(cfg.attn_chunk_kv, s),
                               use_kernel=use_kernel)
    out = cm.dense(p["wo"], out.transpose(1, 2).reshape(b, s, -1))
    if sc.enabled:
        out = coll.reduce_from(out, sc.mesh, sc.model)
    return out, latent


def _mla_decode_layer(cfg: TransformerConfig, p, x: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor,
                      cache_len: torch.Tensor,
                      sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """One token's MLA attention in the absorbed form (reference
    ``transformer.py:715``): x (B, 1, D) → (B, 1, D); the token's latent
    goes into the layer's caches c_kv (B, S, rank) and k_rope (B, S, rope)
    in place.  W_kv_b's key half is absorbed into the query, so the
    scores and the output stay in the 576-wide latent space; the products
    are f32 (TF32 off), as the reference's, and no kernel runs here.

    Under ``sc`` the caches are this ``model`` rank's sequence slice and
    ``p`` holds its heads (wq_b's and wkv_b's columns, wo's rows): the
    absorbed queries of every head are gathered over ``model``, scored
    against the rank's positions, and the ranks' latent outputs merged by
    their log-sum-exp (``common.merge_by_lse``) before the rank applies
    wv_b and wo to its own heads; wo's partial sums are summed over
    ``model``.  On one ``model`` rank that is the unsharded arithmetic."""
    a = cfg.mla
    b = x.shape[0]
    pos = cache_len[:, None]                                      # (B, 1)
    if a.q_lora_rank:
        q_in = cm.rmsnorm(p["q_a_norm"], cm.dense(p["wq_a"], x))
    else:
        q_in = x
    q = cm.dense(p["wq_b"], q_in).reshape(b, -1, a.qk_dim)
    h = q.shape[1]                                  # the rank's heads
    q_nope, q_rope = q.split([a.qk_nope_dim, a.qk_rope_dim], dim=-1)
    q_rope = cm.apply_rope(q_rope[:, :, None, :], pos[:, None, :],
                           cfg.rope_theta)[:, :, 0]
    c_new, r_new = cm.dense(p["wkv_a"], x)[:, 0].split(
        [a.kv_lora_rank, a.qk_rope_dim], dim=-1)
    c_new = cm.rmsnorm(p["kv_a_norm"], c_new)
    r_new = cm.apply_rope(r_new[:, None], pos, cfg.rope_theta)[:, 0]
    off = sc.rank(sc.model) * c_kv.shape[1]
    _cache_insert_2d(c_kv, c_new, cache_len - off)
    _cache_insert_2d(k_rope, r_new, cache_len - off)

    wkv_b = p["wkv_b"]["w"].reshape(a.kv_lora_rank, h,
                                    a.qk_nope_dim + a.v_head_dim).float()
    wk_b, wv_b = wkv_b[..., :a.qk_nope_dim], wkv_b[..., a.qk_nope_dim:]
    ckv = c_kv.float()
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope.float(), wk_b)
    q_rope = q_rope.float()
    tp = sc.enabled and sc.size(sc.model) > 1
    if tp:                                          # every head's query
        q_lat = coll.gather(q_lat, sc.mesh, sc.model, 1)
        q_rope = coll.gather(q_rope, sc.mesh, sc.model, 1)
    scores = torch.einsum("bhl,bsl->bhs", q_lat, ckv) \
        + torch.einsum("bhr,bsr->bhs", q_rope, k_rope.float())
    scores = scores / (a.qk_dim ** 0.5)
    mask = torch.arange(ckv.shape[1], device=x.device)[None] \
        < (cache_len + 1 - off)[:, None]
    scores = torch.where(mask[:, None], scores, cm.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", w, ckv)
    if tp:
        o_lat = cm.merge_by_lse(o_lat, torch.logsumexp(scores, dim=-1),
                                sc.mesh, sc.model)
        o_lat = o_lat[:, sc.rank(sc.model) * h:][:, :h]
    out = torch.einsum("bhl,lhv->bhv", o_lat, wv_b)
    out = cm.dense(p["wo"], out.reshape(b, 1, h * a.v_head_dim).to(x.dtype))
    return coll.reduce_from(out, sc.mesh, sc.model) if sc.enabled else out


def _gqa_decode_layer(cfg: TransformerConfig, p, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len: torch.Tensor, use_kernel: bool = True,
                      sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """One token's attention against the layer's cache (reference
    ``transformer.py:693``); writes the token's k / v into the cache.

    Under ``sc`` the caches (B, Hkv, S/M, dh) are this ``model`` rank's
    sequence slice of every kv head, and ``p`` holds the rank's q heads
    (wq's columns, wo's rows): the token's q heads are gathered over
    ``model`` (and its k / v heads, when they split), kernel 8's decode
    runs on the rank's slice with the slice's own ``kv_len`` and returns
    its log-sum-exp, the ranks' partial outputs are merged by it
    (``common.merge_by_lse``), and the rank keeps its own heads for wo,
    whose partial sums are summed over ``model``."""
    b = x.shape[0]
    dh = cfg.dh
    pos = cache_len[:, None]                                      # (B, 1)
    q = cm.dense(p["wq"], x).reshape(b, 1, -1, dh)
    k = cm.dense(p["wk"], x).reshape(b, 1, -1, dh)
    v = cm.dense(p["wv"], x).reshape(b, 1, -1, dh)
    if cfg.qk_norm:
        q = cm.rmsnorm(p["q_norm"], q)
        k = cm.rmsnorm(p["k_norm"], k)
    q = cm.apply_rope(q.transpose(1, 2), pos[:, None, :], cfg.rope_theta)
    k = cm.apply_rope(k.transpose(1, 2), pos[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2)
    tp = sc.enabled and sc.size(sc.model) > 1
    hq = q.shape[1]                                 # the rank's q heads
    if tp:
        q = coll.gather(q, sc.mesh, sc.model, 1)
        if _kv_tp(cfg):
            k = coll.gather(k, sc.mesh, sc.model, 1)
            v = coll.gather(v, sc.mesh, sc.model, 1)
    off = sc.rank(sc.model) * k_cache.shape[2]
    _cache_insert(k_cache, k, cache_len - off)
    _cache_insert(v_cache, v, cache_len - off)
    if tp:
        out, lse = cm.decode_attention(q, k_cache, v_cache, cache_len + 1,
                                       use_kernel=use_kernel, offset=off,
                                       return_lse=True)
        out = cm.merge_by_lse(out, lse, sc.mesh, sc.model)
        out = out[:, sc.rank(sc.model) * hq:][:, :hq]
    else:
        out = cm.decode_attention(q, k_cache, v_cache, cache_len + 1,
                                  use_kernel=use_kernel)
    out = cm.dense(p["wo"], out.transpose(1, 2).reshape(b, 1, -1))
    return coll.reduce_from(out, sc.mesh, sc.model) if sc.enabled else out


def _layer_fwd(cfg: TransformerConfig, kind: str, p, x: torch.Tensor,
               positions: torch.Tensor, use_kernel: bool,
               sc: ShardingCtx = NO_SHARDING):
    """One pre-norm layer (reference ``transformer.py:535``).  Under
    ``sc`` with ``cfg.gather_weights_at_use`` the layer's FSDP shards are
    gathered here, at their use (ZeRO-3: inside the remat'd layer, so
    the backward gathers them again)."""
    if sc.enabled and cfg.gather_weights_at_use:
        p = _gather_fsdp(sc, p, _layer_specs(cfg, kind))
    attn = _mla_attention if cfg.mla is not None else _gqa_attention
    h, kv = attn(cfg, p["attn"], cm.rmsnorm(p["ln1"], x), positions,
                 use_kernel, sc)
    x = x + h
    ffn_in = cm.rmsnorm(p["ln2"], x)
    if kind == "moe":
        x = x + _moe_ffn(cfg, p["ffn"], ffn_in, use_kernel=use_kernel,
                         sc=sc)
    else:
        x = x + _dense_ffn(p["ffn"], ffn_in, sc)
    return x, kv


def _layer_train(cfg: TransformerConfig, kind: str, p, x: torch.Tensor,
                 positions: torch.Tensor, use_kernel: bool,
                 sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    return _layer_fwd(cfg, kind, p, x, positions, use_kernel, sc)[0]


def _check_split(cfg: TransformerConfig, sc: ShardingCtx) -> None:
    """The vocabulary, the heads and the experts split evenly over
    ``model`` (the vocab-parallel offsets and the head and expert slices
    assume it, as the reference's shardings do)."""
    n = sc.size(sc.model)
    counts = {"vocab": cfg.vocab, "n_heads": cfg.n_heads}
    if cfg.moe is not None:
        counts["n_experts"] = cfg.moe.n_experts
    bad = {k: v for k, v in counts.items() if v % n}
    if bad:
        raise ValueError(f"{bad} do not split over {n} model ranks")


def _embed(params, tokens: torch.Tensor, dt,
           sc: ShardingCtx) -> torch.Tensor:
    """The token embeddings (B, S, D) in ``dt``.  Under ``sc`` the table
    is this rank's (V/M, D/F) block: gathered over ``data``, each
    ``model`` rank looks up the tokens of its vocabulary slice (zeros for
    the others) and the ranks' rows are summed over ``model``."""
    if not sc.enabled:
        return params["embed"].to(dt)[tokens.long()]
    w = coll.gather(params["embed"].to(dt), sc.mesh, sc.fsdp, 1)
    if sc.size(sc.model) == 1:
        return w[tokens.long()]
    v_loc = w.shape[0]
    ids = tokens.long() - sc.rank(sc.model) * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    x = torch.nn.functional.embedding(ids.clamp(0, v_loc - 1), w)
    return coll.reduce_from(torch.where(mine[..., None], x, 0.0), sc.mesh,
                            sc.model)


def hidden(cfg: TransformerConfig, params, tokens: torch.Tensor, *,
           use_kernel: bool = True,
           sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """The training forward (reference ``transformer.py:578`` without the
    cache): tokens (B, S) → final hidden (B, S, D) in ``cfg.dtype``, the
    f32 parameters cast to ``cfg.dtype`` at each use (one cast of each
    stack, unbound into per-layer views), the dense stack then the MoE
    stack, each layer under ``torch.utils.checkpoint`` when
    ``cfg.remat``.

    Under an enabled ``sc`` (``distributed.sharding.make_ctx``) the
    leaves of ``params`` are this rank's shards by :func:`param_specs`,
    ``tokens`` its batch rows, and the layers run tensor-parallel over
    ``model`` (heads, FFN columns, experts, vocabulary) with their FSDP
    shards gathered over ``data``: once a stack here, or at each layer's
    use with ``cfg.gather_weights_at_use``."""
    dt = cfg.dtype
    b, s = tokens.shape
    if sc.enabled:
        _check_split(cfg, sc)
    x = _embed(params, tokens, dt, sc)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if sc.enabled and not cfg.gather_weights_at_use:
        def cast(t, spec):
            return _gather_fsdp(sc, t.to(dt), spec)
    else:
        def cast(t, spec):
            return t.to(dt)
    for kind, p in _per_layer(cfg, params, cast):
        if cfg.remat:
            x = checkpoint(_layer_train, cfg, kind, p, x, positions,
                           use_kernel, sc, use_reentrant=False)
        else:
            x = _layer_train(cfg, kind, p, x, positions, use_kernel, sc)
    return cm.rmsnorm(params["final_norm"], x)


def _output_weights(cfg: TransformerConfig, params,
                    sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """(D, V) output weights in ``cfg.dtype`` (reference
    ``transformer.py:605``); under ``sc`` (D, V/M), the rank's vocabulary
    slice gathered over ``data``."""
    if cfg.tie_embeddings:
        w = coll.gather(params["embed"].to(cfg.dtype), sc.mesh, sc.fsdp,
                        1).T
    else:
        w = coll.gather(params["w_out"].to(cfg.dtype), sc.mesh, sc.fsdp, 0)
    return w


def loss_fn(cfg: TransformerConfig, params, batch, *,
            use_kernel: bool = True,
            sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """Mean token NLL (reference ``transformer.py:614``): batch {"tokens":
    (B, S), "labels": (B, S) with −1 ignored}.  Under ``sc`` the batch is
    this rank's rows and the logits are vocab-sharded over ``model``; the
    value is the mean over every rank's tokens (``common.global_mean``)."""
    h = hidden(cfg, params, batch["tokens"], use_kernel=use_kernel, sc=sc)
    spec = P(sc.batch, None, sc.model) if sc.enabled else None
    return cm.chunked_softmax_xent(h, _output_weights(cfg, params, sc),
                                   batch["labels"], chunk=cfg.xent_chunk,
                                   spec=spec, sc=sc)


def backward(cfg: TransformerConfig, params, batch, *,
             use_kernel: bool = True,
             sc: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """The loss of a train step, its gradient left in the leaves' ``.grad``
    (added to what they hold): with ``cfg.microbatch`` = m > 1 the batch
    is split into m µbatches, each one's gradient accumulated, and the
    sum and the loss divided by m (reference ``steps.py:77-101``).  Under
    ``sc`` the leaves are this rank's shards and the batch its rows of
    each µbatch (µbatch-major: ``launch.steps`` slices it so); the
    gradients end reduced to the leaves' own placements
    (``distributed.sharding.reduce_gradients``: a leaf replicated over
    ``model`` gets its whole gradient on every rank, since
    ``collectives.copy_to`` sums the parts where a replicated tensor
    enters a split computation)."""
    mb = cfg.microbatch
    with torch.enable_grad():
        if mb == 1:
            loss = loss_fn(cfg, params, batch, use_kernel=use_kernel, sc=sc)
            loss.backward()
            total = loss.detach()
        else:
            bsz, seq = batch["tokens"].shape
            toks = batch["tokens"].reshape(mb, bsz // mb, seq)
            labs = batch["labels"].reshape(mb, bsz // mb, seq)
            total = torch.zeros((), dtype=torch.float32,
                                device=params["embed"].device)
            for t, lab in zip(toks, labs):
                loss = loss_fn(cfg, params, {"tokens": t, "labels": lab},
                               use_kernel=use_kernel, sc=sc)
                loss.backward()
                total = total + loss.detach()
    if mb > 1:
        with torch.no_grad():
            for leaf in tree_flatten(params):
                if leaf.grad is not None:
                    leaf.grad.div_(mb)
        total = total / mb
    if sc.enabled:
        reduce_gradients(params, to_shardings(sc.mesh, param_specs(cfg)),
                         sc.batch)
    return total


class Transformer(cm.ParamTree):
    """The transformer for serving: ``prefill`` and ``decode_step`` (see
    the module docstring), on one device or, with DTensor parameters
    (``launch.steps.place_model``), on their mesh."""

    def __init__(self, cfg: TransformerConfig, params: Dict[str, Any],
                 use_kernel: bool = True):
        super().__init__(params)
        self.cfg = cfg
        self.use_kernel = use_kernel
        self._cast_weights()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def meshed(self) -> bool:
        """Whether the parameters are DTensors on a mesh (placed by
        :func:`param_specs`): such a model trains through the mesh step
        and serves on its mesh, each rank its batch rows."""
        from torch.distributed.tensor import DTensor
        return isinstance(self.embed, DTensor)

    def refresh(self) -> None:
        """Cast the compute copy again from the parameters (after a
        training update)."""
        self._cast_weights()

    @torch.no_grad()
    def _cast_weights(self) -> None:
        """The compute-dtype copy of the weights: the embedding and every
        layer leaf (the MoE layers' 3-D expert tensors too) in
        ``cfg.dtype`` (per-layer views of each stack's copy), the output
        weights as the f32 image of their ``cfg.dtype`` rounding.  A
        meshed model's copy holds the rank's shards with their FSDP shards
        gathered over ``data``, a collective: it is made at the first
        serving call, which every rank makes (:meth:`_ready`)."""
        self._layers = None
        if self.meshed:
            return
        dt = self.cfg.dtype
        # detached: with dtype f32 ``.to`` would hand back the Parameter
        # itself, which assigning here would register a second time
        self._embed = self.embed.detach().to(dt)
        w_out = self.embed.T if self.cfg.tie_embeddings else self.w_out
        self._w_out = w_out.detach().to(dt).float()
        self._final_scale = self.final_norm.scale.detach()
        self._sc = NO_SHARDING
        self._set_layers(_per_layer(self.cfg, self.tree(),
                                    lambda t, spec: t.detach().to(dt)))

    def _set_layers(self, layers) -> None:
        self._kinds = [kind for kind, _ in layers]
        self._layers = [p for _, p in layers]

    @torch.no_grad()
    def _ready(self) -> None:
        """A meshed model's compute copy, made if it is not there: each
        leaf's local shard cast to ``cfg.dtype`` and gathered over
        ``data`` by its spec, once; the serving context is ``make_ctx``'s
        with no FSDP axis left to gather."""
        if self._layers is not None:
            return
        cfg, dt = self.cfg, self.cfg.dtype
        sc = make_ctx(self.embed.device_mesh)
        _check_split(cfg, sc)
        tree = self.tree()
        local = _map(lambda t: t.to_local().detach(), tree)
        self._embed = coll.gather(local["embed"].to(dt), sc.mesh, sc.fsdp, 1)
        self._w_out = _output_weights(cfg, local, sc).float()
        self._final_scale = local["final_norm"]["scale"]
        self._sc = dataclasses.replace(sc, fsdp=None)
        self._set_layers(_per_layer(cfg, local, lambda t, spec: _gather_fsdp(
            sc, t.to(dt), spec)))

    def output_weights(self) -> torch.Tensor:
        """(D, V) output weights in ``cfg.dtype`` (reference
        ``transformer.py:605``), here as their f32 image; on a mesh the
        rank's (D, V/M) vocabulary slice."""
        self._ready()
        return self._w_out

    def forward(self, tokens: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """tokens (B, S) → final hidden (B, S, D) (reference
        ``transformer.py:578``); with ``cache`` each layer's kv (GQA k / v,
        MLA c_kv / k_rope) goes to its first S positions, the layers in
        stack order (the reference collects them per stack and
        ``prefill`` concatenates the stacks on the layer axis: the same
        values).  On a mesh ``tokens`` are the rank's rows, the layers run
        tensor- and expert-parallel over ``model``, and ``cache`` is the
        rank's slice (:func:`init_cache` under the model's context): it
        takes the positions of its slice, every kv head's (gathered over
        ``model`` when k and v split their heads)."""
        self._ready()
        cfg, sc = self.cfg, self._sc
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        x = _embed({"embed": self._embed}, tokens, cfg.dtype, sc)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        gather_heads = _kv_tp(cfg) and sc.size(sc.model) > 1
        for i, (kind, p) in enumerate(zip(self._kinds, self._layers)):
            x, kv = _layer_fwd(cfg, kind, p, x, positions, self.use_kernel,
                               sc)
            if cache is None:
                continue
            for key, val in kv.items():
                dst = cache[key][i]
                off = sc.rank(sc.model) * dst.shape[-2]
                n = min(max(s - off, 0), dst.shape[-2])
                if gather_heads and key in ("k", "v"):
                    val = coll.gather(val, sc.mesh, sc.model, 1)
                if n:
                    dst.narrow(-2, 0, n).copy_(val.narrow(-2, off, n))
        return cm.rmsnorm({"scale": self._final_scale}, x)

    # -- serving -----------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """Run the prompt; return (last-position logits (B, V) f32, the
        populated cache) (reference ``transformer.py:658``).  On a mesh:
        the rank's rows in, its (B_loc, V/M) slice of the logits and its
        slice of the cache (its rows, its ``model`` rank's positions of
        ``max_len``, which must split evenly) out."""
        self._ready()
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        max_len = max_len or s
        cache = init_cache(self.cfg, b, max_len, self.cfg.dtype, self.device,
                           self._sc)
        h = self.forward(tokens, cache)
        logits = h[:, -1].float() @ self._w_out
        cache["len"].fill_(s)
        return logits, cache

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict[str, torch.Tensor]):
        """One token for every sequence: tokens (B, 1) → (logits (B, V) f32,
        a new cache holding the tokens' kv with ``len`` advanced)
        (reference ``transformer.py:776``).  ``cache`` is left as it was.
        On a mesh: the rank's rows and its cache slice in, its logits slice
        and new cache slice out (see the module docstring)."""
        self._ready()
        cfg, sc = self.cfg, self._sc
        tokens = torch.as_tensor(tokens, device=self.device)
        cache_len = cache["len"]
        new_cache = {key: val.clone() for key, val in cache.items()
                     if key != "len"}
        new_cache["len"] = cache_len + 1
        x = _embed({"embed": self._embed}, tokens, cfg.dtype, sc)
        for i, (kind, p) in enumerate(zip(self._kinds, self._layers)):
            h = cm.rmsnorm(p["ln1"], x)
            if cfg.mla is not None:
                att = _mla_decode_layer(cfg, p["attn"], h,
                                        new_cache["c_kv"][i],
                                        new_cache["k_rope"][i], cache_len,
                                        sc)
            else:
                att = _gqa_decode_layer(cfg, p["attn"], h, new_cache["k"][i],
                                        new_cache["v"][i], cache_len,
                                        self.use_kernel, sc)
            x = x + att
            ffn_in = cm.rmsnorm(p["ln2"], x)
            if kind == "moe":
                x = x + _moe_ffn(cfg, p["ffn"], ffn_in,
                                 use_kernel=self.use_kernel, sc=sc)
            else:
                x = x + _dense_ffn(p["ffn"], ffn_in, sc)
        x = cm.rmsnorm({"scale": self._final_scale}, x)
        logits = x[:, 0].float() @ self._w_out
        return logits, new_cache
