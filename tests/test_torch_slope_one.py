"""Port parity: Slope One (``repro_torch.core.slope_one``, the paper's
ref. [12] baseline) against the JAX reference, on the CPU.

* ``deviation_matrix``: ``dev`` and ``counts`` bit for bit the
  reference's on integer ratings (every Gram product is an exact f32
  integer), ``dev`` exactly antisymmetric and ``counts`` symmetric, and
  both equal to a brute-force loop;
* ``predict`` and ``SlopeOne.evaluate`` within 2e-6 of the reference;
  the reference's fitted ``dev`` / ``counts`` carried across as numpy;
* ``sharded_deviation`` on 2 and 4 gloo ranks (``_torch_dist.py``) bit
  for bit ``deviation_matrix``, and ``ValueError`` when I does not divide
  over the axis; the reference's ``test_slope_one.py`` on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import assert_parity, int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core import slope_one as ref_so
from repro_torch.core import engine as E
from repro_torch.core import slope_one as so

SHAPES = [(30, 12, 0.5), (97, 41, 0.3), (256, 200, 0.1)]


def _ratings(u, i, density, seed=0):
    return int_ratings(np.random.default_rng(seed + u), u, i, density)


def brute_force_dev(r):
    u, i = r.shape
    dev = np.zeros((i, i))
    cnt = np.zeros((i, i))
    for a in range(i):
        for b in range(i):
            both = (r[:, a] > 0) & (r[:, b] > 0)
            c = both.sum()
            cnt[a, b] = c
            if c:
                dev[a, b] = np.mean(r[both, a] - r[both, b])
    return dev, cnt


@pytest.mark.parametrize("u,i,density", SHAPES)
def test_deviation_matrix_bitwise(u, i, density):
    r = _ratings(u, i, density)
    d, c = so.deviation_matrix(torch.from_numpy(r))
    rd, rc = ref_so.deviation_matrix(jnp.asarray(r))
    assert_parity(f"slope_one.dev.{u}x{i}", d, rd)
    assert_parity(f"slope_one.counts.{u}x{i}", c, rc)
    assert torch.equal(d, -d.T) and torch.equal(c, c.T)


def test_deviation_matches_brute_force():
    r = _ratings(30, 12, 0.5, seed=5)
    d, c = so.deviation_matrix(torch.from_numpy(r))
    bd, bc = brute_force_dev(r)
    np.testing.assert_array_equal(c.numpy(), bc)
    np.testing.assert_allclose(d.numpy(), bd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("u,i,density", SHAPES)
def test_predict_matches_reference(u, i, density):
    r = _ratings(u, i, density, seed=1)
    rd, rc = ref_so.deviation_matrix(jnp.asarray(r))
    want = ref_so.predict(jnp.asarray(r), rd, rc)
    d, c = so.deviation_matrix(torch.from_numpy(r))
    assert_parity(f"slope_one.predict.{u}x{i}",
                  so.predict(torch.from_numpy(r), d, c), want, atol=2e-6)
    # the reference's dev / counts carried across
    carried = so.predict(torch.from_numpy(r), torch.from_numpy(np.array(rd)),
                         torch.from_numpy(np.array(rc)))
    assert_parity(f"slope_one.carried.{u}x{i}", carried, want, atol=2e-6)


def test_evaluate_matches_reference(ml_small):
    train, test, _ = ml_small
    want = ref_so.SlopeOne().fit(jnp.asarray(train)).evaluate(
        jnp.asarray(train), jnp.asarray(test))
    model = so.SlopeOne(device="cpu").fit(train)
    got = model.evaluate(train, test)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 2e-6, (key, got[key], want[key])


def test_slope_one_end_to_end(ml_small):
    """The reference's ``test_slope_one_end_to_end`` on the port."""
    train, test, _ = ml_small
    model = so.SlopeOne(device="cpu").fit(train)
    ev = model.evaluate(train, test)
    assert 0.5 < ev["mae"] < 1.2
    pred = model.predict(train)
    assert bool(torch.isfinite(pred).all())
    assert float(pred.min()) >= 1.0 and float(pred.max()) <= 5.0


def test_errors_and_default_mesh():
    model = so.SlopeOne(device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        model.predict(np.ones((3, 4), np.float32))
    with pytest.raises(ValueError, match="model runs on cpu"):
        model.fit(torch.zeros((3, 4), device="meta"))
    r = torch.from_numpy(_ratings(40, 16, 0.4))
    d, c = so.deviation_matrix(r)
    sd, sc = so.sharded_deviation(r)           # the default one-rank mesh
    assert torch.equal(sd, d) and torch.equal(sc, c)
    meshed = so.SlopeOne(E.default_mesh("cpu"), device="cpu").fit(r)
    assert torch.equal(meshed.dev, d) and torch.equal(meshed.counts, c)


@pytest.fixture(scope="module")
def mesh_ratings():
    return _ratings(96, 200, 0.2, seed=9)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_deviation_on_ranks(mesh_ratings, world, tmp_path):
    out = td.launch("slope", world, tmp_path, {"ratings": mesh_ratings})
    r = torch.from_numpy(mesh_ratings)
    d, c = so.deviation_matrix(r)
    want = so.predict(r, d, c)
    for rank, got in enumerate(out):
        name = f"slope_one.sharded.P{world}.rank{rank}"
        assert_parity(f"{name}.dev", got["dev"][0], d)
        assert_parity(f"{name}.counts", got["dev"][1], c)
        assert_parity(f"{name}.fit.dev", got["fit"][0], d)
        assert_parity(f"{name}.predict", got["predict"], want)
        assert "must divide" in got["indivisible"], rank
