"""Graph substrate of the port (counterpart of ``repro.data.graph``):
synthetic graphs, batched molecules and a layered neighbor sampler.

Host-side numpy, byte-identical to the reference's generators at the
same seed: the same ``np.random.default_rng`` calls in the same order,
and for :class:`NeighborSampler` the same draws across the successive
``sample`` calls of one instance.

The ``minibatch_lg`` cell (Reddit scale: 233k nodes / 115M edges, batch
1024, fanout 15·10) samples a fixed-fanout layered subgraph per
minibatch from a CSR graph, padded to a static node / edge budget.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 16
    seed: int = 0


def synthetic_graph(spec: GraphSpec) -> Dict[str, np.ndarray]:
    """Power-law-ish random graph: {"edges" (2, E) int32 [src, dst],
    "feat" (N, d_feat), "coord" (N, 3) f32 normals, "labels" (N,) int32
    in [0, n_classes)}.  Sources are drawn by pareto(1.5) weights
    (power-law degrees), destinations uniformly; both independently, so
    a graph holds self-loops."""
    rng = np.random.default_rng(spec.seed)
    n, e = spec.n_nodes, spec.n_edges
    w = rng.pareto(1.5, n) + 1.0
    p = w / w.sum()
    src = rng.choice(n, e, p=p)
    dst = rng.integers(0, n, e)
    edges = np.stack([src, dst]).astype(np.int32)
    return {
        "edges": edges,
        "feat": rng.normal(0, 1, (n, spec.d_feat)).astype(np.float32),
        "coord": rng.normal(0, 1, (n, 3)).astype(np.float32),
        "labels": rng.integers(0, spec.n_classes, n).astype(np.int32),
    }


def molecules_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Batched small graphs (a leading B axis) for the molecule cell.
    The labels are drawn in [0, 16) whatever the model's output width."""
    rng = np.random.default_rng(seed)
    return {
        "feat": rng.normal(0, 1, (batch, n_nodes, d_feat)).astype(np.float32),
        "coord": rng.normal(0, 1, (batch, n_nodes, 3)).astype(np.float32),
        "edges": rng.integers(0, n_nodes,
                              (batch, 2, n_edges)).astype(np.int32),
        "labels": rng.integers(0, 16, (batch, n_nodes)).astype(np.int32),
    }


def _to_csr(edges: np.ndarray, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(2, E) [src, dst] → CSR over *incoming* edges per node (dst-major):
    (indptr (N + 1,) int64, the sources in stable dst order (E,) int32)."""
    dst = edges[1]
    order = np.argsort(dst, kind="stable")
    sorted_src = edges[0][order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, sorted_src.astype(np.int32)


class NeighborSampler:
    """Layered uniform neighbor sampling (GraphSAGE, arXiv:1706.02216).

    For seed nodes B and fanouts (f1, f2, …): layer l draws up to f_l
    incoming neighbors per frontier node, without replacement.  The
    subgraph is padded to a fixed node budget (``node_budget``) and edge
    budget (B·f1 + B·f1·f2 + …).  Only the seeds carry labels; the other
    nodes are −1.  The padding edges are ``0 → 0``: a self-loop on the
    subgraph's node 0, which is the first seed, so they add messages to
    a labelled node.
    """

    def __init__(self, edges: np.ndarray, n_nodes: int,
                 fanouts: Tuple[int, ...], seed: int = 0):
        self.indptr, self.neighbors = _to_csr(edges, n_nodes)
        self.n_nodes = n_nodes
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def node_budget(self, batch_nodes: int) -> int:
        total = batch_nodes
        cur = batch_nodes
        for f in self.fanouts:
            cur = cur * f
            total += cur
        return total

    def sample(self, seeds: np.ndarray,
               feat: np.ndarray, coord: np.ndarray, labels: np.ndarray
               ) -> Dict[str, np.ndarray]:
        """The padded subgraph batch {feat, coord, edges, labels} of
        ``seeds`` for ``repro_torch.models.egnn``."""
        b = len(seeds)
        budget = self.node_budget(b)
        nodes = list(seeds)
        node_pos = {int(s): i for i, s in enumerate(seeds)}
        edge_src, edge_dst = [], []
        frontier = list(seeds)
        for f in self.fanouts:
            nxt = []
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                k = min(f, deg)
                picks = self.neighbors[
                    lo + self.rng.choice(deg, size=k, replace=False)]
                for v in picks:
                    v = int(v)
                    if v not in node_pos:
                        if len(nodes) >= budget:
                            continue
                        node_pos[v] = len(nodes)
                        nodes.append(v)
                    edge_src.append(node_pos[v])
                    edge_dst.append(node_pos[u])
                    nxt.append(v)
            frontier = nxt
        n_sub = len(nodes)
        e_sub = len(edge_src)
        e_budget = sum(b * int(np.prod(self.fanouts[:i + 1]))
                       for i in range(len(self.fanouts)))
        nodes_arr = np.asarray(nodes, np.int64)

        sub_feat = np.zeros((budget, feat.shape[1]), np.float32)
        sub_feat[:n_sub] = feat[nodes_arr]
        sub_coord = np.zeros((budget, 3), np.float32)
        sub_coord[:n_sub] = coord[nodes_arr]
        sub_labels = np.full((budget,), -1, np.int32)
        sub_labels[:b] = labels[seeds]                 # only seeds are trained
        edges = np.zeros((2, e_budget), np.int32)      # padding: 0 → 0
        edges[0, :e_sub] = edge_src
        edges[1, :e_sub] = edge_dst
        return {"feat": sub_feat, "coord": sub_coord, "edges": edges,
                "labels": sub_labels}
