"""Blocked mini-batch k-means over (mean-centered) rating rows (port of
``repro.index.kmeans``).

The clustered index partitions users by taste: each user's dense rating
row is mean-centered over its *rated* entries (``z = (r − mean_u) ·
1[r > 0]``, so a zero stays "no information"), normalised, and Lloyd
iterations run over fixed-order row blocks — assignment on the device
through the centroid-distance kernel, the per-cluster fold on the host.
The result is deterministic per ``(seed, shape)``: same centroids, same
assignments, bit for bit.

* Distances come from :func:`repro_torch.kernels.cluster.centroid_distances`
  (the CUDA kernel, or its plain version with ``use_kernel=False``); both
  sum in one fixed order, so a row's distances do not depend on its block.
* Assignment ties go to the lowest cluster id (``torch.min`` returns the
  first minimum).
* The fold is ``np.add.at`` on host copies, in row order — the order of
  the reference's scatter, and the same on every run (a CUDA
  ``index_add_`` folds with atomics in an order that changes between
  runs).
* Empty clusters are re-seeded to the rows *farthest* from their
  centroid, lowest row id on ties.

Row norms are summed in one fixed order too (``normalize_rows``), so a
row's feature vector is the same whether it is computed alone or with
the whole matrix — the index's refold relies on that.

Sharded fit
-----------
With ``mesh=`` the rows shard over a mesh axis of P ranks (SPMD: every
rank passes the whole ``z``): the rows are padded to a multiple of P
blocks, each rank sweeps its contiguous row shard (the CUDA kernel on the
card) and folds its partial cluster sums and counts, the partials are
``all_gather``ed and added in rank order on every rank — so the fit is
deterministic and the same on every rank — and assignments and distances
are gathered to the global arrays.  The centroid update and the reseed
run on the gathered state, unchanged.  At P = 1 the shard is every row
and the fold order is the unsharded one: the fit is bit-identical to the
unsharded fit.  At P > 1 the partial sums add in another order, so
centroids agree to float rounding (deterministic per ``(seed, shape,
P)``), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import all_gather_rows, mesh_axis
from repro_torch.core.similarity import _sqrt
from repro_torch.kernels.cluster import centroid_distances
# the one definition, shared with the support scorer's deviation tables
from repro_torch.kernels.support import center_rows  # noqa: F401


def _row_sumsq(z: torch.Tensor) -> torch.Tensor:
    """Σ_d z[:, d]² in order d = 0..D−1 with separately rounded products:
    a row's sum does not depend on the rows beside it (a library
    reduction picks its order by shape)."""
    zt = z.T.contiguous()
    s = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    for d in range(zt.shape[0]):
        s = s + zt[d] * zt[d]
    return s


def normalize_rows(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalize rows (spherical k-means feature map): the norm summed
    in fixed order, its square root correctly rounded."""
    n = _sqrt(_row_sumsq(z))
    return z / n.clamp_min(eps)[:, None]


@dataclasses.dataclass
class KMeansStats:
    """What one ``kmeans`` run did (the re-seed count drives a test)."""
    iters: int
    n_reseeds: int
    inertia: float          # sum of squared distances to assigned centroids


def _pad_rows(z: torch.Tensor, block_size: int):
    """Rows padded with zeros to a multiple of ``block_size`` (the block
    times the shard count), and the (padded length,) validity mask."""
    n = z.shape[0]
    rem = n % block_size
    valid = np.zeros((n + (block_size - rem if rem else 0),), bool)
    valid[:n] = True
    if rem:
        z = torch.cat([z, z.new_zeros(block_size - rem, z.shape[1])])
    return z, valid


def _sweep(z, valid, centroids, *, block_size, n_clusters, use_kernel,
           z_host):
    """One blocked Lloyd sweep over the rows of ``z`` (a row shard of the
    padded matrix): assign every row on the device, fold the valid rows'
    cluster sums (f32) and counts (int32) on the host in row order.
    ``z_host`` holds the valid rows, a prefix of ``z``'s.  Returns
    ``(sums, counts, assign, best_d)``, host arrays over ``z``'s rows for
    the last two."""
    assign, best_d = [], []
    for b0 in range(0, z.shape[0], block_size):
        d = centroid_distances(z[b0:b0 + block_size], centroids,
                               use_kernel=use_kernel)
        bd, a = torch.min(d, dim=1)            # ties → lowest cluster id
        assign.append(a.to(torch.int32))
        best_d.append(bd)
    assign = torch.cat(assign).cpu().numpy()
    best_d = torch.cat(best_d).cpu().numpy()
    a = assign[valid]
    sums = np.zeros((n_clusters, z.shape[1]), np.float32)
    np.add.at(sums, a, z_host)
    counts = np.bincount(a, minlength=n_clusters).astype(np.int32)
    return sums, counts, assign, best_d


def _gather_sweep(out, group, n: int, device):
    """The global sweep from every rank's ``_sweep`` output: the partial
    sums and counts added in rank order (the same order, so the same
    bits, on every rank), assignments and distances concatenated in rank
    order.  Collectives run on ``device`` tensors."""
    sums, counts, assign, best_d = (
        all_gather_rows(torch.from_numpy(x).to(device), group, n).cpu()
        .numpy() for x in out)
    sums = sums.reshape((n,) + out[0].shape)
    counts = counts.reshape(n, -1)
    total, n_tot = sums[0], counts[0]
    for part, cnt in zip(sums[1:], counts[1:]):
        total, n_tot = total + part, n_tot + cnt
    return total, n_tot, assign, best_d


def kmeans(z: torch.Tensor, n_clusters: int, *, seed: int = 0,
           iters: int = 8, block_size: int = 2048, use_kernel: bool = True,
           mesh=None, axis: str = "data"
           ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, KMeansStats]:
    """Deterministic blocked k-means, optionally sharded over a mesh.

    Returns ``(centroids (C, D) on z's device, assign (U,), best_dist
    (U,), stats)`` where ``assign[u]`` is the canonical nearest centroid
    of row ``u`` (ties → lowest cluster id) and ``best_dist[u]`` its
    squared distance.  With ``mesh`` the rows shard over ``axis`` (see
    the module docstring): bit-identical on one rank, deterministic and
    equal to float rounding beyond.
    """
    n_rows, _ = z.shape
    if not 1 <= n_clusters <= n_rows:
        raise ValueError(f"need 1 <= n_clusters <= {n_rows}, "
                         f"got {n_clusters}")
    z = z.float().contiguous()
    group, index, n = ((None, 0, 1) if mesh is None
                       else mesh_axis(mesh, axis, z))
    block_size = min(block_size, max(n_rows // n, 1))
    rng = np.random.default_rng(seed)
    init_rows = np.sort(rng.choice(n_rows, size=n_clusters, replace=False))
    centroids = z[torch.as_tensor(init_rows, device=z.device)]
    z_host = z.cpu().numpy()

    z_p, valid = _pad_rows(z, block_size * n)
    span = z_p.shape[0] // n                  # rows of one shard
    r0 = index * span
    z_s, valid_s = z_p[r0:r0 + span], valid[r0:r0 + span]
    z_host_s = z_host[r0:r0 + span]           # the shard's valid rows

    def sweep(cents):
        out = _sweep(z_s, valid_s, cents, block_size=block_size,
                     n_clusters=n_clusters, use_kernel=use_kernel,
                     z_host=z_host_s)
        return out if group is None else _gather_sweep(out, group, n,
                                                       z.device)

    n_reseeds = 0
    with obs.span("kmeans.fit", n_rows=n_rows, n_clusters=n_clusters,
                  iters=iters, n_shards=n) as sp:
        for _ in range(iters):
            sums, counts, _, best_d = sweep(centroids)
            new_c = sums / np.maximum(counts, 1)[:, None]
            empty = np.nonzero(counts == 0)[0]
            if len(empty):
                # farthest-point re-seed: rows worst-served by their
                # centroid, lowest row id on ties — deterministic
                bd = best_d[:n_rows]
                donors = np.lexsort((np.arange(n_rows), -bd))[:len(empty)]
                new_c[empty] = z_host[donors]
                n_reseeds += len(empty)
            centroids = torch.as_tensor(new_c.astype(np.float32),
                                        device=z.device)

        # final canonical assignment against the converged centroids
        _, _, assign, best_d = sweep(centroids)
        assign = np.array(assign[:n_rows])
        best_d = np.array(best_d[:n_rows])
        sp.set_attr("n_reseeds", n_reseeds)
    stats = KMeansStats(iters=iters, n_reseeds=n_reseeds,
                        inertia=float(best_d.sum()))
    reg = obs.registry()
    reg.histogram("kmeans.fit.seconds").observe(sp.duration)
    reg.gauge("kmeans.inertia").set(stats.inertia)
    reg.gauge("kmeans.reseeds").set(n_reseeds)
    return centroids, assign, best_d, stats
