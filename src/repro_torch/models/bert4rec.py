"""BERT4Rec (Sun et al., arXiv:1904.06690), the bidirectional sequential
recommender (port of ``repro.models.bert4rec``): ``encode``, the tied
output head ``logits_fn``, the masked-item ``loss_fn`` and the serving
``serve_scores`` / ``retrieval_score``.

Learned positions, post-LN blocks (LayerNorm at eps 1e-6) with a GELU
FFN (the tanh form, ``jax.nn.gelu``'s default), and a dense padded
bidirectional attention: logits at padded keys (item id 0) are the finite
``NEG_INF``, so an all-padding row gets uniform weights, not NaN.  The
attention stays plain ``torch.matmul`` / softmax, as the reference
computes it outside any Pallas kernel (kernel 8 is causal).  ``BERT4Rec``
is an ``nn.Module`` holding the reference's parameter tree
(``item_embed``, ``pos_embed``, ``ln_in``, ``blocks.<i>.{wq,wk,wv,wo,ln1,
w1,w2,ln2}``, ``out_bias``) in f32; the functions take that tree.  Every
parameter is replicated on a mesh (``param_specs``); with a ``mesh`` the
functions take this rank's batch rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm
from repro_torch.models import embedding as emb


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    n_items: int = 3706             # ML-1M catalogue
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff_mult: int = 4
    mask_token: int = 3706          # == n_items (vocab = n_items + 2)

    @property
    def vocab(self) -> int:
        return self.n_items + 2     # + mask + padding

    @property
    def d_ff(self) -> int:
        return self.embed_dim * self.d_ff_mult

    def param_count(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 4 * d + 2 * d * self.d_ff + self.d_ff + d \
            + 4 * d
        return self.vocab * d + self.seq_len * d \
            + self.n_blocks * per_block + 2 * d + self.vocab


def init_params(cfg: BERT4RecConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's tree (``init_params``, reference ``bert4rec.py:66``)
    from ``generator``: embeddings at 0.02, dense weights at 1/√d_in with
    zero biases, unit LayerNorms.  Same shapes and scales as the
    reference; not its numbers (a ``torch.Generator`` is not a JAX key)."""
    device = torch.device(device if device is not None
                          else generator.device)
    d = cfg.embed_dim

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * 0.02

    def dense(d_in, d_out):
        return cm.dense_init(generator, d_in, d_out, bias=True,
                             device=device)

    item_embed = normal(cfg.vocab, d)
    pos_embed = normal(cfg.seq_len, d)
    blocks = [{"wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
               "wo": dense(d, d), "ln1": cm.layernorm_init(d, device=device),
               "w1": dense(d, cfg.d_ff), "w2": dense(cfg.d_ff, d),
               "ln2": cm.layernorm_init(d, device=device)}
              for _ in range(cfg.n_blocks)]
    return {"item_embed": item_embed, "pos_embed": pos_embed,
            "ln_in": cm.layernorm_init(d, device=device), "blocks": blocks,
            "out_bias": torch.zeros((cfg.vocab,), device=device)}


def param_specs(cfg: BERT4RecConfig,
                batch_axes=("pod", "data", "model")) -> Dict:
    """(reference ``bert4rec.py:80``) every leaf replicated."""
    rep2 = P(None, None)
    ln = {"scale": P(None), "bias": P(None)}
    blk = {"wq": cm.dense_specs(bias=True, w_spec=rep2),
           "wk": cm.dense_specs(bias=True, w_spec=rep2),
           "wv": cm.dense_specs(bias=True, w_spec=rep2),
           "wo": cm.dense_specs(bias=True, w_spec=rep2),
           "ln1": ln,
           "w1": cm.dense_specs(bias=True, w_spec=rep2),
           "w2": cm.dense_specs(bias=True, w_spec=rep2),
           "ln2": ln}
    return {"item_embed": rep2, "pos_embed": rep2, "ln_in": ln,
            "blocks": [blk for _ in range(cfg.n_blocks)],
            "out_bias": P(None)}


def encode(cfg: BERT4RecConfig, params, items: torch.Tensor) -> torch.Tensor:
    """items (B, S) int (0 = padding) → hidden (B, S, D) (reference
    ``bert4rec.py:101``)."""
    b, s = items.shape
    d = cfg.embed_dim
    h = emb._take(params["item_embed"], items) + params["pos_embed"][None, :s]
    h = cm.layernorm(params["ln_in"], h)
    pad_mask = items > 0                                       # (B, S)
    for blk in params["blocks"]:
        q = cm.dense(blk["wq"], h).reshape(b, s, cfg.n_heads, -1)
        k = cm.dense(blk["wk"], h).reshape(b, s, cfg.n_heads, -1)
        v = cm.dense(blk["wv"], h).reshape(b, s, cfg.n_heads, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
            / math.sqrt(q.shape[-1])
        logits = torch.where(pad_mask[:, None, None, :], logits, cm.NEG_INF)
        w = torch.softmax(logits, dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, d)
        h = cm.layernorm(blk["ln1"], h + cm.dense(blk["wo"], att))
        ff = cm.dense(blk["w2"], cm.gelu(cm.dense(blk["w1"], h)))
        h = cm.layernorm(blk["ln2"], h + ff)
    return h


def logits_fn(cfg: BERT4RecConfig, params, hidden: torch.Tensor):
    """The tied output head: ``hidden @ item_embed.T + out_bias``."""
    return hidden @ params["item_embed"].T + params["out_bias"]


def loss_fn(cfg: BERT4RecConfig, params, batch: Dict,
            mesh=None) -> torch.Tensor:
    """Masked-item NLL (reference ``bert4rec.py:129``): batch {items
    (B, S), labels (B, S) with −1 ignored}; f32 log-softmax over the
    vocabulary, the mean over the labelled positions (with ``mesh``,
    over every rank's)."""
    h = encode(cfg, params, batch["items"])
    labels = batch["labels"]
    logp = torch.log_softmax(logits_fn(cfg, params, h).float(), dim=-1)
    lab = labels.clamp_min(0).long()
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    valid = (labels >= 0).float()
    if mesh is not None:            # the mean over every rank's labels
        return cm.global_mean(torch.sum(nll * valid), torch.sum(valid),
                              mesh, mesh.mesh_dim_names)
    return torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1.0)


def serve_scores(cfg: BERT4RecConfig, params, batch: Dict,
                 mesh=None) -> torch.Tensor:
    """Next-item scores at the final position: (B, vocab) (reference
    ``bert4rec.py:143``)."""
    h = encode(cfg, params, batch["items"])
    return logits_fn(cfg, params, h[:, -1])


def retrieval_score(cfg: BERT4RecConfig, params, batch: Dict,
                    mesh=None) -> torch.Tensor:
    """One user's final hidden state dotted with N candidate item ids
    (reference ``bert4rec.py:151``): batch {items (1, S), candidates
    (N,)} → (N,)."""
    h = encode(cfg, params, batch["items"])[0, -1]             # (D,)
    cand = batch["candidates"]
    cand_vecs = emb._take(params["item_embed"], cand)
    return cand_vecs @ h + params["out_bias"][cand.long()]


class BERT4Rec(cm.CTRModel):
    """BERT4Rec: ``forward`` is ``serve_scores``, ``retrieval_score`` and
    the training ``loss``."""

    forward_fn = staticmethod(serve_scores)
    retrieval_fn = staticmethod(retrieval_score)
    loss_fn = staticmethod(loss_fn)
