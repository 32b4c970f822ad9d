"""DLRM (Naumov et al., arXiv:1906.00091), MLPerf Criteo-1TB config (port
of ``repro.models.dlrm``): the serving ``forward``, the batched
``retrieval_score`` and the training ``loss_fn``.

bottom-MLP(dense 13) ∥ 26 embedding lookups → dot interaction → top-MLP.
``DLRM`` is an ``nn.Module`` holding the reference's parameter tree
(``tables.{sharded,replicated}``, ``bot.l{i}.{w,b}``, ``top.l{i}.{w,b}``)
in f32; the functions take that tree as the reference's do.  With a
``mesh`` they take this rank's shards (``param_specs``: the sharded
table's block, everything else whole) and batch rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm
from repro_torch.models import embedding as emb

# MLPerf DLRM v1 Criteo Terabyte per-field vocabulary sizes (26 fields)
MLPERF_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    field_sizes: Tuple[int, ...] = MLPERF_TABLE_SIZES
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    n_shards: int = 512
    candidate_field: int = 0        # field whose ids are retrieval candidates

    @property
    def n_sparse(self) -> int:
        return len(self.field_sizes)

    def layout(self) -> emb.TableLayout:
        return emb.TableLayout(field_sizes=self.field_sizes,
                               embed_dim=self.embed_dim,
                               n_shards=self.n_shards)

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    def param_count(self) -> int:
        n = self.layout().total_params()
        dims = (self.n_dense,) + self.bot_mlp
        n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                 for i in range(len(dims) - 1))
        top_in = self.n_interact + self.bot_mlp[-1]
        dims = (top_in,) + self.top_mlp
        n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                 for i in range(len(dims) - 1))
        return int(n)


def init_params(cfg: DLRMConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's tree (``init_params``, reference ``dlrm.py:67``)
    from ``generator``: tables, then the bottom and top MLPs."""
    return {
        "tables": emb.init_tables(cfg.layout(), generator, device=device),
        "bot": cm.mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp,
                           device=device),
        "top": cm.mlp_init(
            generator, (cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp,
            device=device),
    }


def param_specs(cfg: DLRMConfig, batch_axes=("pod", "data", "model")
                ) -> Dict:
    """(reference ``dlrm.py:77``) the tables by ``table_specs``, the MLPs
    replicated: the dense nets are data-parallel over every axis."""
    rep = P(None, None)
    return {"tables": emb.table_specs(batch_axes),
            "bot": cm.mlp_specs(len(cfg.bot_mlp), w_spec=rep),
            "top": cm.mlp_specs(len(cfg.top_mlp), w_spec=rep)}


def _interact(bot_out: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
    """Dot interaction.  bot_out (B, D); sparse (B, F, D) → (B, F*(F+1)/2):
    the Gram matrix of the F + 1 vectors, strict upper triangle in
    row-major order (``torch.triu_indices`` gives ``jnp.triu_indices``'
    order)."""
    z = torch.cat([bot_out[:, None], sparse], dim=1)             # (B, F+1, D)
    zz = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=z.device)
    return zz[:, iu, ju]                                         # (B, nC2)


def forward(cfg: DLRMConfig, params, batch: Dict, mesh=None) -> torch.Tensor:
    """batch: {dense (B, 13) f32, sparse (B, 26) int} → logits (B,)
    (reference ``dlrm.py:95``)."""
    dense, sparse_idx = batch["dense"], batch["sparse"]
    bot = cm.mlp(params["bot"], dense, act=F.relu, final_act=F.relu)
    vecs = emb.sharded_lookup(cfg.layout(), params["tables"], sparse_idx,
                              mesh)
    feats = torch.cat([_interact(bot, vecs), bot], dim=-1)
    logit = cm.mlp(params["top"], feats, act=F.relu)
    return logit[:, 0]


def retrieval_score(cfg: DLRMConfig, params, batch: Dict,
                    mesh=None) -> torch.Tensor:
    """Score 1 user context against N candidates, batched (reference
    ``dlrm.py:117``): the context broadcast to N rows with the candidate
    ids in ``candidate_field``, through ``forward``.

    batch: {dense (1, 13), sparse (1, 26), candidates (N,)}.  Returns (N,).
    """
    cand = batch["candidates"]
    n = cand.shape[0]
    dense = batch["dense"].expand(n, cfg.n_dense)
    sparse = batch["sparse"].expand(n, cfg.n_sparse).clone()
    sparse[:, cfg.candidate_field] = cand.to(sparse.dtype)
    return forward(cfg, params, {"dense": dense, "sparse": sparse}, mesh)



def loss_fn(cfg, params, batch: Dict, mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["labels"]``
    (reference ``dlrm.py:108``), in the reference's own stable
    form max(z, 0) − z·y + log1p(exp(−|z|)); with ``mesh``, the mean
    over every rank's rows."""
    return cm.bce_with_logits(forward(cfg, params, batch, mesh),
                              batch["labels"], mesh)

class DLRM(cm.CTRModel):
    """DLRM (``forward``, ``retrieval_score``, ``loss``)."""

    forward_fn = staticmethod(forward)
    retrieval_fn = staticmethod(retrieval_score)
    loss_fn = staticmethod(loss_fn)
