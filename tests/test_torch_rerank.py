"""Port parity: the co-rated Gram rerank kernel's plain path against the
JAX reference's oracle, on the CPU.

On integer ratings every Gram sum is an exact f32 integer and both
packages keep the reference's epilogue order with correctly rounded
square roots, so the port equals ``repro.kernels.ref.rerank_scores_ref``
bit for bit on all four measures, for f32 and int8 candidate rows, at
β = 50 and β = 7.3; and the Pallas kernel in interpret mode at a toy
shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from repro.kernels import ref as jref
from repro.kernels.rerank import fused_rerank_scores as jax_fused
from repro_torch.kernels import ref
from repro_torch.kernels.rerank import (MEASURES, fused_rerank_scores,
                                        rerank_scores_plain)


def _case(seed, g, kc, j, density=0.3):
    rng = np.random.default_rng(seed)
    q = int_ratings(rng, g, j, density)
    q[1] = 0.0                                   # a query with no ratings
    c = int_ratings(rng, kc, j, density)
    c[3] = c[0]                                  # duplicated candidates
    norms = np.sqrt((c.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    counts = (c > 0).sum(1).astype(np.float32)
    return q, c, norms, counts


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("cand_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("beta", [50.0, 7.3])
def test_rerank_bitwise_against_oracle(measure, cand_dtype, beta):
    q, c, norms, counts = _case(7, 37, 90, 130)
    got = fused_rerank_scores(torch.from_numpy(q),
                              torch.from_numpy(c).to(cand_dtype),
                              torch.from_numpy(norms),
                              torch.from_numpy(counts), measure=measure,
                              beta=beta)
    want = jref.rerank_scores_ref(jnp.asarray(q), jnp.asarray(c),
                                  jnp.asarray(norms), jnp.asarray(counts),
                                  measure=measure, beta=beta)
    dt = "i8" if cand_dtype == torch.int8 else "f32"
    assert_parity(f"rerank.{measure}.{dt}.beta{beta}", got, want)
    assert got.shape == (37, 90) and got.dtype == torch.float32


@pytest.mark.parametrize("measure", MEASURES)
def test_rerank_matches_pallas_interpret(measure):
    q, c, norms, counts = _case(3, 20, 33, 70)
    got = rerank_scores_plain(torch.from_numpy(q), torch.from_numpy(c),
                              torch.from_numpy(norms),
                              torch.from_numpy(counts), measure=measure)
    want = jax_fused(jnp.asarray(q), jnp.asarray(c).astype(jnp.int8),
                     jnp.asarray(norms), jnp.asarray(counts),
                     measure=measure, bm=8, bn=16, bk=32, interpret=True)
    assert_parity(f"rerank.pallas.{measure}", got, want, atol=1e-6)


def test_rerank_beta_is_live():
    q, c, norms, counts = _case(5, 16, 40, 200, density=0.2)
    args = [torch.from_numpy(a) for a in (q, c, norms, counts)]
    a = fused_rerank_scores(*args, measure="pcc_sig", beta=50.0)
    b = fused_rerank_scores(*args, measure="pcc_sig", beta=7.3)
    assert not torch.equal(a, b)
    pcc = fused_rerank_scores(*args, measure="pcc")
    assert (a <= pcc).all() and (b <= pcc).all()


def test_rerank_equals_pairwise_similarity_on_full_rows():
    """With the true full-row norms and counts, the rerank of full rows is
    the exact engines' similarity, bit for bit."""
    from repro_torch.core import similarity as sim
    q, c, norms, counts = _case(11, 12, 30, 64)
    for measure in MEASURES:
        got = ref.rerank_scores_ref(torch.from_numpy(q), torch.from_numpy(c),
                                    torch.from_numpy(norms),
                                    torch.from_numpy(counts),
                                    measure=measure)
        want = sim.pairwise_similarity(torch.from_numpy(q),
                                       torch.from_numpy(c), measure=measure)
        assert_parity(f"rerank.vs_pairwise.{measure}", got, want)


def test_rerank_rejects_bad_input():
    q = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        fused_rerank_scores(q, torch.zeros(3, 5), torch.zeros(3),
                            torch.zeros(3))
    with pytest.raises(ValueError):
        fused_rerank_scores(q, torch.zeros(3, 6), torch.zeros(2),
                            torch.zeros(3))
    with pytest.raises(ValueError):
        fused_rerank_scores(q, torch.zeros(3, 6), torch.zeros(3),
                            torch.zeros(3), measure="dice")


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("beta", [50.0, 7.3])
def test_rerank_int8_query_rows_equal_f32_rows(measure, beta):
    """The int8 route's operands: int8 query rows (with int8 candidates)
    give the f32 rows' scores bit for bit, in the plain version and
    through the wrapper on the CPU, and the reference's oracle agrees."""
    q, c, norms, counts = _case(13, 29, 70, 200)
    nc = (torch.from_numpy(norms), torch.from_numpy(counts))
    want = rerank_scores_plain(torch.from_numpy(q), torch.from_numpy(c), *nc,
                               measure=measure, beta=beta)
    q8 = torch.from_numpy(q).to(torch.int8)
    c8 = torch.from_numpy(c).to(torch.int8)
    for got in (rerank_scores_plain(q8, c8, *nc, measure=measure, beta=beta),
                fused_rerank_scores(q8, c8, *nc, measure=measure,
                                    beta=beta, max_value=5)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    jax_want = jref.rerank_scores_ref(jnp.asarray(q), jnp.asarray(c),
                                      jnp.asarray(norms),
                                      jnp.asarray(counts), measure=measure,
                                      beta=beta)
    assert_parity(f"rerank.int8_queries.{measure}.beta{beta}", want,
                  jax_want)


@pytest.mark.parametrize("measure", MEASURES)
def test_rerank_zero_padded_items_change_nothing(measure):
    """The int8 route stages J in 16-byte copies, so the wrapper pads both
    operands' rows with zeros to a multiple of 16: zeros add nothing to
    any Gram sum, and the scores are the same bits — also for values up to
    127 and below zero, where the squares leave a byte."""
    rng = np.random.default_rng(17)
    q = rng.integers(-128, 128, (9, 300)) * (rng.random((9, 300)) < 0.4)
    c = rng.integers(-128, 128, (14, 300)) * (rng.random((14, 300)) < 0.4)
    q[2] = 0                                     # an all-zero row
    c[5] = 0
    q8, c8 = (torch.from_numpy(x.astype(np.int8)) for x in (q, c))
    norms = torch.from_numpy(np.sqrt((c.astype(np.float64) ** 2).sum(1))
                             .astype(np.float32))
    counts = torch.from_numpy((c > 0).sum(1).astype(np.float32))
    want = rerank_scores_plain(q8, c8, norms, counts, measure=measure)
    pad = (0, 4)                                 # 300 → 304 = 19 · 16
    got = rerank_scores_plain(torch.nn.functional.pad(q8, pad),
                              torch.nn.functional.pad(c8, pad), norms,
                              counts, measure=measure)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isfinite(want).all())
