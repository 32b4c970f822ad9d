"""Port parity: the canonical top-k merge and the streaming neighbor
selection are bit-identical to the JAX reference, on all four measures,
under duplicate-user tie stress and with k larger than the candidate
count.  Neighbor ids are compared bitwise everywhere; scores bitwise too,
except ``pcc_sig`` under the reference's ``jit``, where XLA may round the
division by the constant β differently from an IEEE division (the port
divides exactly, like its CUDA kernel): there the reference's atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from repro.core import neighbors as ref_nb
from repro_torch.core import neighbors as nb
from repro_torch.core import similarity as sim


def test_neg_inf_matches_reference():
    assert nb.NEG_INF == float(ref_nb.NEG_INF)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_topk_bitwise_with_ties(seed):
    rng = np.random.default_rng(seed)
    m, ka, kb, k = 9, 6, 11, 7
    # few distinct values → many ties; NEG_INF and -1 slots included
    vals = np.array([0.0, 0.25, 0.5, 1.0, float(ref_nb.NEG_INF)], np.float32)
    sa = vals[rng.integers(0, 5, (m, ka))]
    sb = vals[rng.integers(0, 5, (m, kb))]
    ia = rng.integers(-1, 20, (m, ka)).astype(np.int32)
    ib = rng.integers(-1, 20, (m, kb)).astype(np.int32)
    want = ref_nb.merge_topk(jnp.asarray(sa), jnp.asarray(ia),
                             jnp.asarray(sb), jnp.asarray(ib), k)
    got = nb.merge_topk(torch.from_numpy(sa), torch.from_numpy(ia),
                        torch.from_numpy(sb), torch.from_numpy(ib), k)
    assert_parity("merge_topk.scores", got[0], want[0])
    assert_parity("merge_topk.ids", got[1], want[1])
    # order invariance: merging (b, a) gives the same canonical result
    swap = nb.merge_topk(torch.from_numpy(sb), torch.from_numpy(ib),
                         torch.from_numpy(sa), torch.from_numpy(ia), k)
    assert torch.equal(swap[1], got[1]) and torch.equal(swap[0], got[0])


def _dup_ratings(seed, u=40, d=30):
    """Integer ratings where every user has a duplicate twin (tie stress)."""
    rng = np.random.default_rng(seed)
    half = int_ratings(rng, u // 2, d, density=0.5)
    r = np.concatenate([half, half])[rng.permutation(u)]
    r[0] = 0.0                           # and one all-zero row
    return r


@pytest.mark.parametrize("measure", sim.SIMILARITY_MEASURES)
def test_topk_neighbors_bitwise_under_ties(measure):
    r = _dup_ratings(3)
    want = ref_nb.topk_neighbors(jnp.asarray(r), 9, measure=measure,
                                 block_size=16)
    got = nb.topk_neighbors(torch.from_numpy(r), 9, measure=measure,
                            block_size=16)
    assert got[1].dtype == torch.int32
    assert_parity(f"topk_neighbors.{measure}.ids", got[1], want[1])
    assert_parity(f"topk_neighbors.{measure}.scores", got[0], want[0],
                  atol=2e-5 if measure == "pcc_sig" else 0.0)


@pytest.mark.parametrize("measure", ["cosine", "pcc"])
def test_k_larger_than_candidates(measure):
    r = _dup_ratings(4, u=6, d=12)
    want = ref_nb.topk_neighbors(jnp.asarray(r), 10, measure=measure,
                                 block_size=4)
    got = nb.topk_neighbors(torch.from_numpy(r), 10, measure=measure,
                            block_size=4)
    assert_parity(f"topk_k_gt_u.{measure}.ids", got[1], want[1])
    assert_parity(f"topk_k_gt_u.{measure}.scores", got[0], want[0])
    assert (got[1][:, 5:] == -1).all()      # 5 real candidates per row


def test_block_topk_explicit_q_ids_with_padding():
    r = _dup_ratings(5, u=24, d=20)
    q_ids = np.array([3, 17, 0, 24, 24, -1], np.int32)   # padding: 24, -1
    q = r[np.clip(q_ids, 0, 23)]
    want = ref_nb.block_topk(jnp.asarray(q), jnp.asarray(r), 5,
                             measure="pcc_sig", q_ids=jnp.asarray(q_ids),
                             block_size=7, beta=9.0)
    got = nb.block_topk(torch.from_numpy(q), torch.from_numpy(r), 5,
                        measure="pcc_sig", q_ids=torch.from_numpy(q_ids),
                        block_size=7, beta=9.0)
    assert_parity("block_topk.q_ids.ids", got[1], want[1])
    assert_parity("block_topk.q_ids.scores", got[0], want[0], atol=2e-5)


def test_neighbor_weight_matrix():
    r = _dup_ratings(6, u=20, d=16)
    s, i = ref_nb.topk_neighbors(jnp.asarray(r), 4, measure="cosine")
    for clip in (True, False):
        want = ref_nb.neighbor_weight_matrix(s, i, 20, clip_negative=clip)
        got = nb.neighbor_weight_matrix(torch.from_numpy(np.array(s)),
                                        torch.from_numpy(np.array(i)), 20,
                                        clip_negative=clip)
        assert_parity(f"neighbor_weight_matrix.clip{clip}", got, want)
