"""Port parity: the centroid-distance kernel's plain path and the blocked
k-means against the JAX reference, on the CPU.

Distances: the plain path against ``ref.centroid_distances_ref`` and the
Pallas kernel in interpret mode (atol 1e-5: the reference sums in XLA's
order, the port in fixed feature order); a row subset bit for bit equal to
the full call (batch invariance, which the index's refold check needs).
k-means: assignments equal to the reference's at the same seed, centroids
within 1e-6, the same re-seed count, deterministic per seed, canonical
argmin on duplicated rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from repro.index import kmeans as ref_kmeans
from repro.index.kmeans import normalize_rows as ref_normalize
from repro.kernels.cluster import fused_centroid_distances as ref_fused
from repro.kernels.ref import centroid_distances_ref as ref_dist
from repro_torch.index import kmeans
from repro_torch.index.kmeans import center_rows, normalize_rows
from repro_torch.kernels import ref
from repro_torch.kernels.cluster import (centroid_distances,
                                         fused_centroid_distances)


@pytest.mark.parametrize("m,n,d", [(8, 4, 16), (100, 7, 130), (33, 9, 5),
                                   (1, 33, 17)])
def test_centroid_distances_match_reference(m, n, d):
    rng = np.random.default_rng(m * n + d)
    # unit rows, as the index's proxies and centroids are (distances ≤ 4)
    x = normalize_rows(torch.from_numpy(
        rng.normal(size=(m, d)).astype(np.float32))).numpy()
    c = normalize_rows(torch.from_numpy(
        rng.normal(size=(n, d)).astype(np.float32))).numpy()
    got = fused_centroid_distances(torch.from_numpy(x), torch.from_numpy(c))
    before = fused_centroid_distances.launches
    assert_parity(f"cluster.plain_vs_ref.{m}x{n}x{d}", got,
                  ref_dist(jnp.asarray(x), jnp.asarray(c)), atol=1e-5)
    assert_parity(f"cluster.plain_vs_pallas.{m}x{n}x{d}", got,
                  ref_fused(jnp.asarray(x), jnp.asarray(c), bm=32, bn=16,
                            bk=64, interpret=True), atol=1e-5)
    assert fused_centroid_distances.launches == before   # CPU: no launch
    assert (got.numpy() >= 0).all()


def test_centroid_distances_are_batch_invariant():
    """A row's distances are the same bits whatever rows share its call."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(257, 64)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(78, 64)).astype(np.float32))
    full = centroid_distances(x, c)
    for rows in ([5], [0, 3, 256], list(range(100, 164))):
        sub = centroid_distances(x[rows], c)
        assert_parity(f"cluster.subset.{len(rows)}", sub, full[rows])
    padded = torch.cat([x[[7]].repeat(8, 1)])
    assert torch.equal(centroid_distances(padded, c)[0], full[7])
    assert torch.equal(centroid_distances(x, c, use_kernel=False), full)


def test_normalize_rows_matches_reference():
    rng = np.random.default_rng(2)
    r = int_ratings(rng, 64, 40)
    means = r.sum(1) / np.maximum((r > 0).sum(1), 1)
    z = center_rows(torch.from_numpy(r), torch.from_numpy(
        means.astype(np.float32)))
    got = normalize_rows(z)
    want = ref_normalize(jnp.asarray(z.numpy()))
    assert_parity("cluster.normalize_rows", got, want, atol=1e-6)
    assert torch.equal(normalize_rows(z[:5]), got[:5])


def _unit_rows(rng, u, d):
    return normalize_rows(torch.from_numpy(int_ratings(rng, u, d)))


@pytest.mark.parametrize("u,d,c,iters", [(96, 40, 12, 5), (80, 32, 10, 4),
                                         (64, 32, 8, 3)])
def test_kmeans_matches_reference(u, d, c, iters):
    z = _unit_rows(np.random.default_rng(u), u, d)
    cents, assign, best_d, stats = kmeans(z, c, seed=7, iters=iters,
                                          block_size=32)
    r_c, r_a, r_d, r_st = ref_kmeans(jnp.asarray(z.numpy()), c, seed=7,
                                     iters=iters, block_size=32)
    assert_parity(f"kmeans.assign.{u}", assign, r_a)
    assert_parity(f"kmeans.centroids.{u}", cents, r_c, atol=1e-6)
    assert_parity(f"kmeans.best_dist.{u}", best_d, r_d, atol=1e-5)
    assert stats.n_reseeds == r_st.n_reseeds
    # canonical argmin against the port's own distances, bit for bit
    d_all = centroid_distances(z, cents)
    assert_parity(f"kmeans.argmin.{u}", assign, d_all.argmin(1))
    assert_parity(f"kmeans.best_d.{u}", best_d, d_all.min(1).values)


def test_kmeans_deterministic_per_seed_and_shape():
    z = _unit_rows(np.random.default_rng(0), 96, 40)
    a = kmeans(z, 12, seed=7, iters=5)
    b = kmeans(z, 12, seed=7, iters=5)
    assert torch.equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    c = kmeans(z, 12, seed=8, iters=5)
    assert not np.array_equal(a[1], c[1])
    d = kmeans(z, 12, seed=7, iters=5, use_kernel=False)
    assert torch.equal(a[0], d[0])


def test_kmeans_empty_cluster_reseed():
    """3 distinct points, 8 clusters: duplicated initial centroids lose
    every canonical tie, go empty and are re-seeded — as many times as in
    the reference, into the same partition.  (Which row donates a re-seed
    is decided by rounding noise on exact duplicates — each package's own
    summation order — so cluster labels may differ.)"""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(3, 16)).astype(np.float32)
    z = normalize_rows(torch.from_numpy(
        np.vstack([base[i % 3] for i in range(24)])))
    cents, assign, _, stats = kmeans(z, 8, seed=0, iters=6)
    r_c, r_a, _, r_st = ref_kmeans(jnp.asarray(z.numpy()), 8, seed=0,
                                   iters=6)
    assert stats.n_reseeds > 0
    assert stats.n_reseeds == r_st.n_reseeds
    r_a = np.asarray(r_a)
    np.testing.assert_array_equal(assign[:, None] == assign[None, :],
                                  r_a[:, None] == r_a[None, :])
    cents2, _, _, stats2 = kmeans(z, 8, seed=0, iters=6)
    assert torch.equal(cents, cents2) and stats.n_reseeds == stats2.n_reseeds


def test_kmeans_argmin_ties_go_to_lowest_cluster():
    """Duplicated rows as initial centroids: exact distance ties, which
    must resolve to the lowest cluster id."""
    z = normalize_rows(torch.from_numpy(
        np.repeat(np.eye(4, 8, dtype=np.float32), 4, axis=0)))
    _, assign, _, _ = kmeans(z, 6, seed=3, iters=1)
    d = centroid_distances(z, kmeans(z, 6, seed=3, iters=1)[0])
    first = (d == d.min(1, keepdim=True).values).int().argmax(1)
    np.testing.assert_array_equal(assign, first.numpy())


def test_kmeans_rejects_bad_input():
    z = _unit_rows(np.random.default_rng(0), 16, 8)
    with pytest.raises(ValueError):
        kmeans(z, 0)
    with pytest.raises(ValueError):
        kmeans(z, 17)
    # a mesh whose collectives take another device type than z's
    from types import SimpleNamespace
    with pytest.raises(ValueError, match="collectives"):
        kmeans(z, 4, mesh=SimpleNamespace(device_type="cuda"))


def test_ref_oracle_is_the_plain_version():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    assert torch.equal(ref.centroid_distances_ref(x, c),
                       centroid_distances(x, c))
