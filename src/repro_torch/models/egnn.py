"""EGNN — E(n)-equivariant graph network (Satorras et al., arXiv:2102.09844),
port of ``repro.models.egnn``.

Message passing over an explicit edge list: gathers of the node
tensors at the edges' ends, small dense MLPs on the edges and nodes, and
segment sums of the edge messages into their destination nodes.  Three
regimes, as in the reference:

  * a flat graph (full batch: Cora-size through ogbn-products-size), its
    edges optionally split over the ranks of a mesh;
  * a sampled minibatch (``repro_torch.data.graph.NeighborSampler``'s
    padded subgraph) through the same flat path;
  * batched small graphs (molecules): the B graphs flattened into one
    graph with node ids offset by b·n, in place of the reference's
    ``vmap`` (the same sums in the same order; the products differ from
    the reference's only in rounding).

Layer (paper eqs. 3-6):
    m_ij = φ_e(h_i, h_j, ‖x_i − x_j‖², e_ij)
    x_i' = x_i + (1/|N(i)|) Σ_j (x_i − x_j) · φ_x(m_ij)
    h_i' = φ_h(h_i, Σ_j m_ij)

The segment sums run in a fixed order on every device: the edges are
sorted stably by their destination (and, for a gather's backward, by
their source) once per forward, and ``torch.segment_reduce`` adds each
segment's rows in that order — each node's edges in edge order, as the
reference's scatter adds them on the CPU.  A gather's backward is such a
segment sum, and a segment sum's backward is a gather, so the gradients
are deterministic too.  No atomic add is used.

The reference's numerics are kept as they are: an edge with
``src == dst`` has ‖x_i − x_j‖ = 0, where the gradient of the norm is
0 · ∞ = NaN, so at three or more layers the gradients of a graph with a
self-loop are NaN; a label at or above ``d_out`` makes the loss NaN (the
gold log-probability is read at a clamped index and replaced by NaN,
as the reference's out-of-range ``take_along_axis`` fills it).

On a mesh (``sc.enabled`` with ``shard_edges``) each rank passes its own
slice of the edge list and the whole node tensors: the node-side work
(``embed_in``, ``phi_h``, ``readout``, the loss) is whole on every rank,
the edge-side work (the gathers, ``phi_e``, ``phi_x``) covers this
rank's edges.  The segment sums are summed over ``sc.batch``
(``collectives.reduce_from``: all-reduce forward, identity backward),
and the node tensors and edge-MLP weights that enter the edge work pass
through ``collectives.copy_to`` (identity forward, all-reduce backward),
so every rank ends with the whole gradient of every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm
from repro_torch.models.common import NO_SHARDING, ShardingCtx


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 1433              # input node features (set per shape)
    d_edge: int = 0                 # optional edge features
    d_out: int = 7                  # classes / regression dim
    n_coord_dims: int = 3
    residual: bool = True
    normalize_agg: bool = True

    def param_count(self) -> int:
        h = self.d_hidden
        d_msg_in = 2 * h + 1 + self.d_edge
        per_layer = (d_msg_in * h + h) + (h * h + h) \
            + (h * h + h) + (h * 1 + 1) \
            + ((2 * h) * h + h) + (h * h + h)
        return (self.d_feat * h + h) + self.n_layers * per_layer \
            + (h * self.d_out + self.d_out)


def _layer_init(cfg: EGNNConfig, generator, device):
    h = cfg.d_hidden
    d_msg_in = 2 * h + 1 + cfg.d_edge
    return {
        "phi_e": cm.mlp_init(generator, [d_msg_in, h, h], device=device),
        "phi_x": cm.mlp_init(generator, [h, h, 1], device=device),
        "phi_h": cm.mlp_init(generator, [2 * h, h, h], device=device),
    }


def init_params(cfg: EGNNConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's tree (``init_params``, reference ``egnn.py:66``)
    from ``generator``: the same shapes and scales (``dense_init`` /
    ``mlp_init``), not its numbers."""
    device = torch.device(device if device is not None
                          else generator.device)
    return {
        "embed_in": cm.dense_init(generator, cfg.d_feat, cfg.d_hidden,
                                  bias=True, device=device),
        "layers": [_layer_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
        "readout": cm.dense_init(generator, cfg.d_hidden, cfg.d_out,
                                 bias=True, device=device),
    }


def param_specs(cfg: EGNNConfig) -> Dict:
    """Every leaf replicated (reference ``egnn.py:76``)."""
    rep = P(None, None)
    layer = {
        "phi_e": cm.mlp_specs(2, w_spec=rep),
        "phi_x": cm.mlp_specs(2, w_spec=rep),
        "phi_h": cm.mlp_specs(2, w_spec=rep),
    }
    return {
        "embed_in": cm.dense_specs(bias=True, w_spec=rep),
        "layers": [layer for _ in range(cfg.n_layers)],
        "readout": cm.dense_specs(bias=True, w_spec=rep),
    }


# -- fixed-order segment sums ------------------------------------------------

class Segments(NamedTuple):
    """An edge-end index ``idx`` (E,) over ``n`` nodes with its stable
    sort ``order`` (E,) and the segment ``lengths`` (n,): each node's
    edges in edge order."""
    idx: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor


def segments(idx: torch.Tensor, n: int) -> Segments:
    idx = idx.long()
    order = torch.sort(idx, stable=True).indices
    if idx.device.type == "meta":
        # a dry run's: no data to count, and bincount has no meta kernel;
        # the n segment lengths have their shape without a host read
        return Segments(idx, order, torch.empty((n,), dtype=torch.int64,
                                                device=idx.device))
    return Segments(idx, order, torch.bincount(idx, minlength=n))


def _segment_rows(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(n, ...) sums of ``data`` (E, ...)'s rows by ``seg``, each
    segment's rows added in edge order."""
    return torch.segment_reduce(data.index_select(0, seg.order), "sum",
                                lengths=seg.lengths, axis=0, unsafe=True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg):
        ctx.seg = seg
        return _segment_rows(data, seg)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.seg.idx), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, seg):
        ctx.seg = seg
        return table.index_select(0, seg.idx)

    @staticmethod
    def backward(ctx, g):
        return _segment_rows(g, ctx.seg), None


def segment_sum(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``jax.ops.segment_sum(data, seg.idx, n)`` in a fixed order; its
    gradient is a gather."""
    return _SegmentSum.apply(data, seg)


def gather(table: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``table[seg.idx]``; its gradient is a fixed-order segment sum."""
    return _Gather.apply(table, seg)


# -- the model ---------------------------------------------------------------

def _egnn_layer(cfg: EGNNConfig, p, h, x, segs, edge_feat,
                sc: ShardingCtx, shard_edges: bool):
    """h: (N, d_hidden); x: (N, 3); ``segs``: the (src, dst) segments of
    this rank's edges (reference ``egnn.py:89``)."""
    src, dst = segs
    mesh = sc.mesh
    axes = sc.batch if shard_edges and sc.enabled else None
    he, xe = coll.copy_to(h, mesh, axes), coll.copy_to(x, mesh, axes)
    phi_e, phi_x = ({name: {k: coll.copy_to(v, mesh, axes)
                            for k, v in lp.items()}
                     for name, lp in p[key].items()}
                    for key in ("phi_e", "phi_x"))
    h_src, h_dst = gather(he, src), gather(he, dst)
    x_src, x_dst = gather(xe, src), gather(xe, dst)
    diff = x_dst - x_src                                        # (E, 3)
    dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
    # official EGNN `normalize_diff`: keeps coordinate updates O(1)
    diff = diff / (torch.sqrt(dist2) + 1.0)
    msg_in = [h_dst, h_src, dist2]
    if edge_feat is not None:
        msg_in.append(edge_feat)
    m = cm.mlp(phi_e, torch.cat(msg_in, dim=-1), act=F.silu,
               final_act=F.silu)                                # (E, h)
    coef = cm.mlp(phi_x, m, act=F.silu)                         # (E, 1)
    coord_msg = diff * coef                                     # (E, 3)

    agg_m = coll.reduce_from(segment_sum(m, dst), mesh, axes)
    agg_x = coll.reduce_from(segment_sum(coord_msg, dst), mesh, axes)
    if cfg.normalize_agg:
        deg = coll.all_reduce_sum(dst.lengths.to(agg_x.dtype), mesh, axes)
        agg_x = agg_x / torch.clamp_min(deg, 1.0)[:, None]

    x_new = x + agg_x
    h_upd = cm.mlp(p["phi_h"], torch.cat([h, agg_m], dim=-1), act=F.silu)
    h_new = h + h_upd if cfg.residual else h_upd
    return h_new, x_new


def forward(cfg: EGNNConfig, params, batch: Dict,
            sc: ShardingCtx = NO_SHARDING, shard_edges: bool = False):
    """batch: {feat (N, d_feat), coord (N, 3), edges (2, E)[, edge_feat
    (E, d_edge)]} (reference ``egnn.py:128``); on a mesh with
    ``shard_edges``, ``edges`` and ``edge_feat`` are this rank's slice.

    Returns per-node logits (N, d_out) and final coordinates (N, 3)."""
    feat, coord, edges = batch["feat"], batch["coord"], batch["edges"]
    n_nodes = feat.shape[0]
    segs = (segments(edges[0], n_nodes), segments(edges[1], n_nodes))
    edge_feat = batch.get("edge_feat")
    h = cm.dense(params["embed_in"], feat)
    x = coord
    for lp in params["layers"]:
        h, x = _egnn_layer(cfg, lp, h, x, segs, edge_feat, sc, shard_edges)
    return cm.dense(params["readout"], h), x


def forward_batched(cfg: EGNNConfig, params, batch: Dict,
                    sc: ShardingCtx = NO_SHARDING):
    """Batched small graphs, leaves with a leading (B,) axis (reference
    ``egnn.py:149``): the B graphs as one graph of B·n nodes, graph b's
    node ids offset by b·n.  Returns (B, n, d_out) and (B, n, 3)."""
    feat, coord = batch["feat"], batch["coord"]
    b, n = feat.shape[:2]
    offs = torch.arange(b, device=feat.device).view(b, 1, 1) * n
    edges = (batch["edges"].long() + offs).transpose(0, 1).reshape(2, -1)
    logits, x = forward(cfg, params, {
        "feat": feat.reshape(b * n, -1), "coord": coord.reshape(b * n, -1),
        "edges": edges})
    return logits.reshape(b, n, -1), x.reshape(b, n, -1)


def nll_terms(cfg: EGNNConfig, params, batch: Dict,
              sc: ShardingCtx = NO_SHARDING, shard_edges: bool = False):
    """(Σ NLL over the labelled nodes, their count): the two terms of
    :func:`loss_fn`, which a mesh step sums over its batch ranks."""
    if batch["feat"].dim() == 3:
        logits, _ = forward_batched(cfg, params, batch, sc)
    else:
        logits, _ = forward(cfg, params, batch, sc, shard_edges=shard_edges)
    labels = batch["labels"].long()
    valid = labels >= 0
    lab = torch.clamp_min(labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    d = logp.shape[-1]
    gold = torch.gather(logp, -1, torch.clamp_max(lab, d - 1)[..., None])
    nll = torch.where(lab < d, -gold[..., 0], float("nan"))
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll), torch.sum(valid)


def loss_fn(cfg: EGNNConfig, params, batch: Dict,
            sc: ShardingCtx = NO_SHARDING, shard_edges: bool = False):
    """Masked node-classification cross-entropy, labels −1 unlabelled
    (reference ``egnn.py:158``)."""
    total, count = nll_terms(cfg, params, batch, sc, shard_edges)
    return total / torch.clamp_min(count, 1)


class EGNN(cm.ParamTree):
    """EGNN: the reference's parameter tree (``embed_in``, ``layers.<i>.
    {phi_e, phi_x, phi_h}``, ``readout``) as parameters; ``forward`` and
    ``forward_batched`` on a batch of numpy arrays or tensors (moved to
    the parameters' device) under ``torch.inference_mode()``, ``loss``
    with grad enabled (the train steps take the gradient of the tree)."""

    def __init__(self, cfg: EGNNConfig, params: Dict):
        super().__init__(params)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {key: torch.as_tensor(val, device=self.device)
                for key, val in batch.items()}

    @torch.inference_mode()
    def forward(self, batch: Dict):
        """(logits (N, d_out), coordinates (N, 3)) of a flat graph."""
        return forward(self.cfg, self.tree(), self._batch(batch))

    @torch.inference_mode()
    def forward_batched(self, batch: Dict):
        """(logits (B, n, d_out), coordinates (B, n, 3)) of B graphs."""
        return forward_batched(self.cfg, self.tree(), self._batch(batch))

    @torch.enable_grad()
    def loss(self, batch: Dict) -> torch.Tensor:
        """The training loss (a 0-d f32 tensor) of a flat or batched
        graph; a gradient reaches the leaves that require one."""
        return loss_fn(self.cfg, self.tree(), self._batch(batch))
