"""Port parity: the sharded k-means fit (``kmeans(mesh=)``) and an index
fitted through a mesh, as the reference's ``tests/test_sharded_kmeans.py``
holds its own.

* One rank (the default one-rank gloo mesh, in this process): the fit is
  bit-identical to the unsharded fit — centroids, assignments, distances
  — and so is an index fit (centroids, spill lists and distances).
* 2 and 4 gloo ranks on the reference's blob case: two runs are bitwise
  equal and the same on every rank; the assignments equal the unsharded
  ones (the port's and the reference's); centroids are within 1e-5 and
  the inertia within 1e-3 relative (the partial sums add in another
  order); an index fitted through the mesh queries end to end.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import assert_parity, int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.index.kmeans import kmeans as ref_kmeans
from repro.index.kmeans import normalize_rows as ref_normalize
from repro_torch.core import engine as E
from repro_torch.core import similarity as sim
from repro_torch.index import ClusteredIndex, IndexConfig, ItemClusteredIndex
from repro_torch.index import ItemIndexConfig
from repro_torch.index.kmeans import kmeans, normalize_rows


def _blobs():
    rng = np.random.default_rng(0)
    cents = rng.normal(size=(8, 32)).astype(np.float32) * 10
    return np.stack([cents[i % 8]
                     + 0.05 * rng.normal(size=(32,)).astype(np.float32)
                     for i in range(256)]), rng


@pytest.fixture(scope="module")
def blobs():
    z, rng = _blobs()
    z = np.array(ref_normalize(jnp.asarray(z)))
    return z, int_ratings(rng, 256, 96, density=0.3)


@pytest.fixture(scope="module")
def ranks(blobs, tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = td.launch(
                "kmeans", world, tmp_path_factory.mktemp(f"kmeans{world}"),
                {"z": blobs[0], "ratings": blobs[1]})
        return cache[world]
    return get


def test_one_rank_mesh_is_bit_identical():
    rng = np.random.default_rng(3)
    z = normalize_rows(torch.from_numpy(
        rng.normal(size=(200, 32)).astype(np.float32)))
    c0, a0, d0, s0 = kmeans(z, 8, seed=0, iters=4, block_size=48)
    c1, a1, d1, s1 = kmeans(z, 8, seed=0, iters=4, block_size=48,
                            mesh=E.default_mesh("cpu"))
    assert torch.equal(c0, c1)
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_array_equal(d0, d1)
    assert s0.inertia == s1.inertia


@pytest.mark.parametrize("cls,cfg", [
    (ClusteredIndex, IndexConfig(n_clusters=8, seed=0, features="raw")),
    (ItemClusteredIndex, ItemIndexConfig(n_clusters=8, seed=0))])
def test_index_fit_through_one_rank_mesh(cls, cfg):
    r = torch.from_numpy(int_ratings(np.random.default_rng(4), 128, 96,
                                     density=0.3))
    means = sim.user_stats(r)[2]
    ix0 = cls(cfg).fit(r, means)
    ix1 = cls(cfg, mesh=E.default_mesh("cpu")).fit(r, means)
    assert torch.equal(ix0.centroids, ix1.centroids)
    np.testing.assert_array_equal(ix0.spill_ids, ix1.spill_ids)
    np.testing.assert_array_equal(ix0.spill_dist, ix1.spill_dist)


def test_mesh_on_another_device_type_is_refused():
    z = torch.ones((16, 4))
    with pytest.raises(ValueError, match="collectives"):
        kmeans(z, 2, mesh=types.SimpleNamespace(device_type="cuda"))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fit_matches_unsharded(blobs, ranks, world):
    z = blobs[0]
    c0, a0, d0, s0 = kmeans(torch.from_numpy(z), 8, seed=0, iters=5,
                            block_size=16)
    rc, ra, _, rs = ref_kmeans(jnp.asarray(z), 8, seed=0, iters=5,
                               block_size=16)
    np.testing.assert_array_equal(a0, ra)
    outs = ranks(world)
    for rank, out in enumerate(outs):
        (c1, a1, d1, in1), (c2, a2, d2, in2) = out["runs"]
        # determinism: two runs, and every rank, bit for bit
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(d1, d2)
        assert in1 == in2
        np.testing.assert_array_equal(c1, outs[0]["runs"][0][0])
        # blob agreement with the unsharded fits
        np.testing.assert_array_equal(a1, a0)
        assert_parity(f"kmeans.P{world}.rank{rank}.centroids", c1, c0,
                      atol=1e-5)
        assert_parity(f"kmeans.P{world}.rank{rank}.centroids_vs_ref", c1,
                      rc, atol=1e-5)
        assert abs(in1 - s0.inertia) <= 1e-3 * max(s0.inertia, 1e-9)


@pytest.mark.parametrize("world", [2, 4])
def test_index_through_mesh_queries(blobs, ranks, world):
    outs = ranks(world)
    for rank, out in enumerate(outs):
        s, i = out["query"]
        assert i.shape == (256, 5) and s.shape == (256, 5)
        assert ((i >= 0) & (i < 256)).all()
        assert (i != np.arange(256)[:, None]).all()     # no self pair
        np.testing.assert_array_equal(i, outs[0]["query"][1])
        np.testing.assert_array_equal(out["spill_ids"], outs[0]["spill_ids"])
