"""Port parity: the support scorer (segmented SpMM) on the CPU.

* The plain version (what the wrapper runs on a CPU tensor) against the
  port's einsum oracle ``ref.support_scores_ref``, the reference's oracle
  and the reference's Pallas kernel in interpret mode, at the reference's
  test shapes (``tests/test_support_kernel.py``) and with every neighbor
  masked (1e-6: the einsum and the Pallas grid sum in other orders).
* The support score is the exact prediction: on integer ratings it equals
  ``predict_from_neighbors_blocked`` (the tile predictor's ordered k-loop
  on the same rounded ``r − r̄`` values) bit for bit.
* The int8 route (the (U, I) int8 ratings and the (U,) means in place of
  the tables): its plain version equals the table route's on the tables
  of the same data bit for bit, and the reference's Pallas kernel in
  interpret mode on those tables within 1e-6; the route choice and its
  errors (``support_route``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.kernels import ref as jref
from repro.kernels.support import fused_support_scores as pallas_support
from repro_torch.core import predict as pr
from repro_torch.core.facade import CFEngine
from repro_torch.index.kmeans import center_rows
from repro_torch.kernels import ref
from repro_torch.kernels.support import (BT, fused_support_scores,
                                         support_route,
                                         support_scores_int8_plain,
                                         support_scores_plain,
                                         support_tables, support_width)

TOL = 1e-6


def _inputs(rng, b, k, u, i, masked=False):
    dev = (rng.normal(size=(u, i)).astype(np.float32)
           * (rng.random((u, i)) < 0.3))
    msk = (dev != 0).astype(np.float32)
    idx = rng.integers(0, u, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) < 0.8)).astype(np.float32)
    if masked:
        w[:] = 0.0
    qm = rng.uniform(2, 4, b).astype(np.float32)
    return dev, msk, idx, w, qm


@pytest.mark.parametrize("shape", [(5, 7, 40, 130, False),
                                   (9, 3, 25, 64, False),
                                   (2, 12, 50, 33, False),
                                   (3, 4, 20, 48, True),
                                   (1, 1, 17, 7, False)])
def test_support_plain_matches_oracles_and_pallas(shape):
    b, k, u, i, masked = shape
    arrays = _inputs(np.random.default_rng(b + k + u + i), b, k, u, i,
                     masked)
    t = [torch.from_numpy(x) for x in arrays]
    j = [jnp.asarray(x) for x in arrays]
    before = fused_support_scores.launches
    got = fused_support_scores(*t)
    assert fused_support_scores.launches == before    # CPU: plain version
    assert torch.equal(got, support_scores_plain(*t))
    name = f"support.{b}x{k}x{u}x{i}"
    assert_parity(f"{name}.port_oracle", got, ref.support_scores_ref(*t),
                  atol=TOL)
    assert_parity(f"{name}.reference_oracle", got,
                  jref.support_scores_ref(*j), atol=TOL)
    assert_parity(f"{name}.pallas_interpret", got,
                  pallas_support(*j, bt=32, interpret=True), atol=TOL)
    if masked:                 # zero weights: the query mean, clipped
        assert torch.equal(got, t[4][:, None].clamp(1, 5).expand_as(got))


@pytest.mark.parametrize("measure,k", [("pcc", 12), ("cosine", 5),
                                       ("jaccard", 1)])
def test_support_score_is_the_exact_prediction(measure, k):
    """Identity 2: the support scorer over the item index's padded tables
    equals the blocked exact predictor bit for bit on integer ratings."""
    rng = np.random.default_rng(k)
    r = torch.from_numpy(int_ratings(rng, 120, 700))
    eng = CFEngine(r, measure=measure, k=k, block_size=64,
                   device="cpu").fit()
    scores, idx, means = eng.scores, eng.idx, eng.means
    dev, msk = support_tables(r, means, 700 + (-700) % BT)
    assert dev.shape == (120, 1024)
    safe = torch.where(idx >= 0, idx, 0).to(torch.int32)
    w = torch.where((scores > 0) & (idx >= 0), scores,
                    torch.zeros_like(scores))
    got = fused_support_scores(dev, msk, safe, w, means)
    assert bool((got[:, 700:] == means[:, None].clamp(1, 5)).all())
    want = pr.predict_from_neighbors_blocked(
        r, scores, idx, means=means, item_block=512,
        gather_src=pr.make_gather_source(r), use_kernel=True)
    assert_parity(f"support.identity_tile_predict.{measure}.k{k}",
                  got[:, :700], want)


def test_support_wrapper_validation():
    dev, msk, idx, w, qm = (torch.from_numpy(x) for x in _inputs(
        np.random.default_rng(0), 3, 4, 20, 48))
    with pytest.raises(ValueError):
        fused_support_scores(dev, msk[:, :40], idx, w, qm)
    with pytest.raises(ValueError):
        fused_support_scores(dev, msk, idx, w[:, :2], qm)
    with pytest.raises(ValueError):
        fused_support_scores(dev, msk, idx, w, qm[:2])
    with pytest.raises(ValueError):
        fused_support_scores(dev, msk, idx[0], w, qm)


def _int8_inputs(rng, b, k, u, i, masked=False):
    """Integer ratings (some negative: only r > 0 counts as rated), user
    means, ids, masked weights and query means."""
    r = (rng.integers(1, 6, (u, i)) * (rng.random((u, i)) < 0.3)
         - 2 * (rng.random((u, i)) < 0.05)).astype(np.float32)
    means = rng.uniform(2, 4, u).astype(np.float32)
    idx = rng.integers(0, u, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) < 0.8)).astype(np.float32)
    if masked:
        w[:] = 0.0
    qm = rng.uniform(2, 4, b).astype(np.float32)
    return r, means, idx, w, qm


@pytest.mark.parametrize("shape", [(5, 7, 40, 130, False),
                                   (9, 3, 25, 64, False),
                                   (2, 12, 50, 33, False),
                                   (3, 4, 20, 48, True),
                                   (1, 1, 17, 7, False)])
def test_support_int8_plain_matches_tables_and_pallas(shape):
    b, k, u, i, masked = shape
    r, means, idx, w, qm = _int8_inputs(
        np.random.default_rng(b * k + u + i), b, k, u, i, masked)
    r8 = torch.from_numpy(r).to(torch.int8)
    t = [torch.from_numpy(x) for x in (means, idx, w, qm)]
    width = support_width(i)
    assert width == i + (-i) % min(BT, i)
    got = support_scores_int8_plain(r8, *t)
    assert got.shape == (b, width)
    before = dict(fused_support_scores.routes)
    assert torch.equal(fused_support_scores(r8, *t), got)   # CPU: plain
    assert fused_support_scores.routes == before
    dev, msk = support_tables(r8, t[0], width)
    # the tables are the index's mean-centred rows and rated mask
    rf = torch.from_numpy(r)
    assert torch.equal(dev[:, :i], center_rows(rf, t[0]))
    assert torch.equal(msk[:, :i], (rf > 0).float())
    assert not bool(dev[:, i:].any() or msk[:, i:].any())
    name = f"support.int8.{b}x{k}x{u}x{i}"
    assert_parity(f"{name}.vs_tables", got,
                  support_scores_plain(dev, msk, *t[1:]))
    j = [jnp.asarray(x) for x in (dev.numpy(), msk.numpy(), idx, w, qm)]
    assert_parity(f"{name}.pallas_interpret", got,
                  pallas_support(*j, bt=32, interpret=True), atol=TOL)
    if masked:
        assert torch.equal(got, t[3][:, None].clamp(1, 5).expand_as(got))


def test_support_int8_plain_is_the_exact_prediction():
    """Identity 2 on the int8 route: the gather source and the means
    score every item as the blocked exact predictor does, bit for bit."""
    rng = np.random.default_rng(8)
    r = torch.from_numpy(int_ratings(rng, 120, 700))
    eng = CFEngine(r, measure="pcc", k=12, block_size=64,
                   device="cpu").fit()
    scores, idx, means = eng.scores, eng.idx, eng.means
    safe = torch.where(idx >= 0, idx, 0).to(torch.int32)
    w = torch.where((scores > 0) & (idx >= 0), scores,
                    torch.zeros_like(scores))
    src = pr.make_gather_source(r)
    got = fused_support_scores(src, means, safe, w, means)
    assert got.shape == (120, 1024)
    assert bool((got[:, 700:] == means[:, None].clamp(1, 5)).all())
    want = pr.predict_from_neighbors_blocked(
        r, scores, idx, means=means, item_block=512, gather_src=src,
        use_kernel=True)
    assert_parity("support.int8.identity_tile_predict", got[:, :700], want)


@pytest.mark.parametrize("case,want", [
    ("table", "table"), ("int8", "int8"), ("int8_no_users", "int8"),
    ("int8_means_2d", ValueError), ("int8_f64_means", TypeError),
    ("int8_means_shape", ValueError), ("table_shapes", ValueError),
    ("table_f64", TypeError), ("table_int8_mask", TypeError),
    ("one_dim", ValueError)])
def test_support_route_choice(case, want):
    """The route follows the first operand's dtype: f32 tables → "table",
    an int8 matrix with its f32 means → "int8"; anything else raises."""
    t = torch.zeros((6, 40))
    r8 = torch.zeros((6, 40), dtype=torch.int8)
    mu = torch.zeros(6)
    args = {"table": (t, t), "int8": (r8, mu),
            "int8_no_users": (r8[:0], mu[:0]),
            "int8_means_2d": (r8, mu[:, None]),
            "int8_f64_means": (r8, mu.double()),
            "int8_means_shape": (r8, torch.zeros(5)),
            "table_shapes": (t, t[:, :30]),
            "table_f64": (t.double(), t.double()),
            "table_int8_mask": (t, r8), "one_dim": (mu, mu)}[case]
    if isinstance(want, str):
        assert support_route(*args) == want
    else:
        with pytest.raises(want):
            support_route(*args)
