"""Factorization Machines (Rendle, ICDM 2010), 2-way interactions (port of
``repro.models.fm``): the serving ``forward``, the factorised
``retrieval_score`` and the training ``loss_fn``.

The O(nk) sum-square identity  Σᵢ<ⱼ⟨vᵢ,vⱼ⟩ = ½‖Σᵢvᵢ‖² − ½Σᵢ‖vᵢ‖²  gives
the pairwise term; ``retrieval_score`` splits it over the user fields and
the candidate field, so scoring N candidates is one (N, k) · (k,) product.
``FM`` is an ``nn.Module`` holding the reference's parameter tree (``w0``,
``linear.{sharded,replicated}``, ``factors.{sharded,replicated}``) in
f32; the functions take that tree as the reference's do.  With a
``mesh`` they take this rank's shards (``param_specs``: each sharded
table's block) and batch rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm
from repro_torch.models import embedding as emb

# Criteo-Kaggle-scale per-field vocabularies (39 fields, ~1M features);
# dense fields are bucketised into small vocabularies (standard practice).
CRITEO_39_SIZES = tuple([64] * 13) + (
    1461, 584, 1000000, 800000, 306, 25, 12518, 634, 4, 93146,
    5684, 900000, 3194, 28, 14993, 700000, 11, 5653, 2173, 4,
    7046547 % 1000000, 19, 16, 200000, 105, 150000)


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    field_sizes: Tuple[int, ...] = CRITEO_39_SIZES
    embed_dim: int = 10
    n_shards: int = 512
    candidate_field: int = 15       # a large "item-like" field

    @property
    def n_sparse(self) -> int:
        return len(self.field_sizes)

    @property
    def total_vocab(self) -> int:
        return sum(self.field_sizes)

    def layout(self) -> emb.TableLayout:
        return emb.TableLayout(field_sizes=self.field_sizes,
                               embed_dim=self.embed_dim,
                               n_shards=self.n_shards)

    def linear_layout(self) -> emb.TableLayout:
        return emb.TableLayout(field_sizes=self.field_sizes, embed_dim=1,
                               n_shards=self.n_shards)

    def param_count(self) -> int:
        return 1 + self.layout().total_params() \
            + self.linear_layout().total_params()


def init_params(cfg: FMConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's tree (``init_params``, reference ``fm.py:61``) from
    ``generator``: ``w0`` zero, linear then factor tables."""
    device = torch.device(device if device is not None
                          else generator.device)
    return {
        "w0": torch.zeros((1,), dtype=torch.float32, device=device),
        "linear": emb.init_tables(cfg.linear_layout(), generator,
                                  device=device),
        "factors": emb.init_tables(cfg.layout(), generator, device=device),
    }


def param_specs(cfg: FMConfig, batch_axes=("pod", "data", "model")) -> Dict:
    """(reference ``fm.py:70``) both tables by ``table_specs``."""
    return {"w0": P(None),
            "linear": emb.table_specs(batch_axes),
            "factors": emb.table_specs(batch_axes)}


def _fm_terms(v: torch.Tensor) -> torch.Tensor:
    """v: (B, F, k) → (B,) pairwise-interaction term via sum-square trick."""
    s = v.sum(dim=1)                             # (B, k)
    s2 = (v * v).sum(dim=1)                      # (B, k)
    return 0.5 * (s * s - s2).sum(dim=-1)


def forward(cfg: FMConfig, params, batch: Dict, mesh=None) -> torch.Tensor:
    """batch: {sparse (B, F) int} → logits (B,) (reference ``fm.py:85``)."""
    idx = batch["sparse"]
    lin = emb.sharded_lookup(cfg.linear_layout(), params["linear"], idx,
                             mesh)[..., 0]       # (B, F)
    v = emb.sharded_lookup(cfg.layout(), params["factors"], idx, mesh)
    return params["w0"][0] + lin.sum(dim=-1) + _fm_terms(v)


def retrieval_score(cfg: FMConfig, params, batch: Dict,
                    mesh=None) -> torch.Tensor:
    """FM-factorised retrieval (reference ``fm.py:104``):

    score(c) = const(user) + w_c + ⟨Σᵤvᵤ, v_c⟩   for each candidate c.

    batch: {sparse (1, F), candidates (N,)}.  Returns (N,).  With
    ``mesh`` the candidates are this rank's and the user's context (the
    same on every rank) is looked up through the exchange as well, the
    reference's whole-table take: its F − 1 ≤ 64 lookups a rank never
    overflow a bucket (capacity ≥ min(lookups, 64))."""
    idx = batch["sparse"]
    cand = batch["candidates"]                                  # (N,)
    f = cfg.candidate_field
    user_fields = [i for i in range(cfg.n_sparse) if i != f]

    lin_u = emb.sharded_lookup(cfg.linear_layout(), params["linear"],
                               idx[:, user_fields], mesh,
                               fields=user_fields)[..., 0]
    v_u = emb.sharded_lookup(cfg.layout(), params["factors"],
                             idx[:, user_fields], mesh,
                             fields=user_fields)[0]              # (F-1, k)
    user_const = params["w0"][0] + lin_u.sum() + _fm_terms(v_u[None])[0]
    v_sum_u = v_u.sum(dim=0)                                    # (k,)

    lin_c = emb.sharded_lookup(cfg.linear_layout(), params["linear"],
                               cand[:, None], mesh,
                               fields=[f])[..., 0, 0]            # (N,)
    v_c = emb.sharded_lookup(cfg.layout(), params["factors"],
                             cand[:, None], mesh, fields=[f])[:, 0]  # (N, k)
    return user_const + lin_c + v_c @ v_sum_u



def loss_fn(cfg, params, batch: Dict, mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["labels"]``
    (reference ``fm.py:95``), in the reference's own stable
    form max(z, 0) − z·y + log1p(exp(−|z|)); with ``mesh``, the mean
    over every rank's rows."""
    return cm.bce_with_logits(forward(cfg, params, batch, mesh),
                              batch["labels"], mesh)

class FM(cm.CTRModel):
    """The FM (``forward``, ``retrieval_score``, ``loss``)."""

    forward_fn = staticmethod(forward)
    retrieval_fn = staticmethod(retrieval_score)
    loss_fn = staticmethod(loss_fn)
