"""Port parity: the support scorer (segmented SpMM) on the CPU.

* The plain version (what the wrapper runs on a CPU tensor) against the
  port's einsum oracle ``ref.support_scores_ref``, the reference's oracle
  and the reference's Pallas kernel in interpret mode, at the reference's
  test shapes (``tests/test_support_kernel.py``) and with every neighbor
  masked (1e-6: the einsum and the Pallas grid sum in other orders).
* The support score is the exact prediction: on integer ratings it equals
  ``predict_from_neighbors_blocked`` (the tile predictor's ordered k-loop
  on the same rounded ``r − r̄`` values) bit for bit.
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
from repro_torch.index.item_index import _dense_tables
from repro_torch.kernels import ref
from repro_torch.kernels.support import (BT, fused_support_scores,
                                         support_scores_plain)

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
    dev, msk = _dense_tables(r, means, 700 + (-700) % BT)
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
