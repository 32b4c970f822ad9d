"""xDeepFM (Lian et al., arXiv:1803.05170) — CIN + DNN + linear (port of
``repro.models.xdeepfm``): the serving ``forward``, the chunked
``retrieval_score`` and the training ``loss_fn``.

CIN layer:  x^{k+1}_h = Σ_{i,j} W^{k,h}_{ij} (x^k_i ∘ x^0_j) + b_h, ReLU;
each layer's feature map is sum-pooled over the embedding dim into the
final logit.  The outer product is formed as (B, D, Hk, F) so that the
compression is one (B·D, Hk·F) × (Hk·F, H) product (the reference's two
einsums; same terms, summed in another order).  ``XDeepFM`` is an
``nn.Module`` holding the reference's parameter tree (``linear``,
``factors``, ``cin`` — a list of {w, b} — ``cin_out``, ``dnn``) in f32.
With a ``mesh`` the functions take this rank's shards (``param_specs``:
each sharded table's block) and batch rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm
from repro_torch.models import embedding as emb
from repro_torch.models.fm import CRITEO_39_SIZES


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    field_sizes: Tuple[int, ...] = CRITEO_39_SIZES
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)
    n_shards: int = 512
    candidate_field: int = 15
    retrieval_chunk: int = 8192

    @property
    def n_sparse(self) -> int:
        return len(self.field_sizes)

    def layout(self) -> emb.TableLayout:
        return emb.TableLayout(field_sizes=self.field_sizes,
                               embed_dim=self.embed_dim,
                               n_shards=self.n_shards)

    def linear_layout(self) -> emb.TableLayout:
        return emb.TableLayout(field_sizes=self.field_sizes, embed_dim=1,
                               n_shards=self.n_shards)

    def param_count(self) -> int:
        n = self.layout().total_params() + self.linear_layout().total_params()
        h_prev = self.n_sparse
        for h in self.cin_layers:
            n += h_prev * self.n_sparse * h + h
            h_prev = h
        n += sum(self.cin_layers)                      # pooled → logit
        dims = (self.n_sparse * self.embed_dim,) + self.mlp + (1,)
        n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                 for i in range(len(dims) - 1))
        return int(n + 1)


def init_params(cfg: XDeepFMConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's tree (``init_params``, reference ``xdeepfm.py:62``)
    from ``generator``: CIN weights normal · 0.01 with zero biases."""
    device = torch.device(device if device is not None
                          else generator.device)
    linear = emb.init_tables(cfg.linear_layout(), generator, device=device)
    factors = emb.init_tables(cfg.layout(), generator, device=device)
    cin = []
    h_prev = cfg.n_sparse
    for h in cfg.cin_layers:
        w = torch.randn((h_prev * cfg.n_sparse, h), generator=generator,
                        device=device, dtype=torch.float32) * 0.01
        cin.append({"w": w, "b": torch.zeros((h,), device=device)})
        h_prev = h
    return {
        "linear": linear, "factors": factors, "cin": cin,
        "cin_out": cm.dense_init(generator, sum(cfg.cin_layers), 1,
                                 bias=True, device=device),
        "dnn": cm.mlp_init(generator, (cfg.n_sparse * cfg.embed_dim,)
                           + cfg.mlp + (1,), device=device),
    }


def param_specs(cfg: XDeepFMConfig,
                batch_axes=("pod", "data", "model")) -> Dict:
    """(reference ``xdeepfm.py:84``) the tables by ``table_specs``, the
    CIN and the DNN replicated."""
    rep = P(None, None)
    return {"linear": emb.table_specs(batch_axes),
            "factors": emb.table_specs(batch_axes),
            "cin": [{"w": rep, "b": P(None)} for _ in cfg.cin_layers],
            "cin_out": cm.dense_specs(bias=True, w_spec=rep),
            "dnn": cm.mlp_specs(len(cfg.mlp) + 1, w_spec=rep)}


def _cin(cfg: XDeepFMConfig, params, z0: torch.Tensor) -> torch.Tensor:
    """z0: (B, F, D) → (B, Σ cin_layers) pooled feature maps (reference
    ``xdeepfm.py:96``)."""
    b, f, d = z0.shape
    z0_t = z0.transpose(1, 2)                                    # (B, D, F)
    zk_t = z0_t
    pooled = []
    for lp in params["cin"]:
        hk = zk_t.shape[2]
        outer = zk_t[..., :, None] * z0_t[..., None, :]          # (B, D, Hk, F)
        nxt = (outer.reshape(b * d, hk * f) @ lp["w"]).reshape(b, d, -1)
        zk_t = F.relu(nxt + lp["b"])                             # (B, D, H)
        pooled.append(zk_t.sum(dim=1))                           # (B, H)
    return torch.cat(pooled, dim=-1)


def forward(cfg: XDeepFMConfig, params, batch: Dict,
            mesh=None) -> torch.Tensor:
    """batch: {sparse (B, F) int} → logits (B,) (reference
    ``xdeepfm.py:110``)."""
    idx = batch["sparse"]
    lin = emb.sharded_lookup(cfg.linear_layout(), params["linear"], idx,
                             mesh)[..., 0]
    v = emb.sharded_lookup(cfg.layout(), params["factors"], idx, mesh)
    cin_feat = _cin(cfg, params, v)
    return lin.sum(dim=-1) \
        + cm.dense(params["cin_out"], cin_feat)[:, 0] \
        + cm.mlp(params["dnn"], v.reshape(v.shape[0], -1), act=F.relu)[:, 0]


def retrieval_score(cfg: XDeepFMConfig, params, batch: Dict,
                    mesh=None) -> torch.Tensor:
    """CIN is not factorisable: ``forward`` over candidate chunks of
    ``retrieval_chunk`` (reference ``xdeepfm.py:135``, whose ``lax.map``
    becomes a loop).  N ≤ chunk runs as one chunk; a larger N must be a
    multiple of the chunk, as the reference's reshape requires.  With
    ``mesh`` the candidates are this rank's and a chunk is its share of
    the reference's, ``retrieval_chunk`` / P rows."""
    cand = batch["candidates"]
    n = cand.shape[0]
    chunk = cfg.retrieval_chunk if mesh is None \
        else max(cfg.retrieval_chunk // mesh.size(), 1)
    c = min(chunk, n)
    idx = batch["sparse"]                                        # (1, F)
    if n > c and n % c:
        raise ValueError(f"{n} candidates do not split into chunks of {c}")

    def score_chunk(cand_chunk):
        sparse = idx.expand(cand_chunk.shape[0], cfg.n_sparse).clone()
        sparse[:, cfg.candidate_field] = cand_chunk.to(sparse.dtype)
        return forward(cfg, params, {"sparse": sparse}, mesh)

    if n <= c:
        return score_chunk(cand)
    return torch.cat([score_chunk(chunk) for chunk in cand.split(c)])



def loss_fn(cfg, params, batch: Dict, mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["labels"]``
    (reference ``xdeepfm.py:125``), in the reference's own stable
    form max(z, 0) − z·y + log1p(exp(−|z|)); with ``mesh``, the mean
    over every rank's rows."""
    return cm.bce_with_logits(forward(cfg, params, batch, mesh),
                              batch["labels"], mesh)

class XDeepFM(cm.CTRModel):
    """xDeepFM (``forward``, ``retrieval_score``, ``loss``)."""

    forward_fn = staticmethod(forward)
    retrieval_fn = staticmethod(retrieval_score)
    loss_fn = staticmethod(loss_fn)
