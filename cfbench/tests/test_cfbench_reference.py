"""The plain reference against the port's plain ``sequential`` backend on
the CPU: the same neighbors and recommendations bit for bit.  (This test
may import the port; the reference may not.)"""

import pytest
import torch

from cfbench.tests.tiny import ROOT  # noqa: F401  (puts the repo on the path)
from cfbench import gen
from cfbench.reference import compare, recommend, topk


@pytest.fixture(scope="module")
def data():
    cfg = {"n_users": 240, "n_items": 180, "n_ratings": 240 * 35,
           "min_user_ratings": 5, "rating_min": 1, "rating_max": 5,
           "assumed": {"latent_dim": 8, "global_mean": 3.58,
                       "user_bias_std": 0.3, "item_bias_std": 0.3,
                       "noise_std": 0.55, "affinity_scale": 2.6,
                       "popularity_alpha": 1.1, "activity_sigma": 0.9}}
    return gen.generate(cfg, 2 ** 31 + 77, "cpu")


@pytest.mark.parametrize("k", [5, 40])
def test_topk_matches_the_sequential_engine(data, k):
    from repro_torch.core.facade import CFEngine
    eng = CFEngine(data.matrix, k=k, backend="sequential",
                   device="cpu").fit()
    users = torch.arange(0, 240, 7)
    ref_s, ref_i = topk.topk_rows(data.matrix, users, k)
    assert compare.gaps(eng.scores[users], eng.idx[users], ref_s,
                        ref_i) == (0.0, 0)


def test_recommend_matches_the_sequential_engine(data):
    from repro_torch.core.facade import CFEngine
    eng = CFEngine(data.matrix, k=12, backend="sequential",
                   device="cpu").fit()
    got_s, got_i = eng.recommend(n=10)
    means = recommend.user_means(data.matrix)
    assert torch.equal(means, eng.means)
    users = torch.arange(240)
    ref_s, ref_i = recommend.recommend_rows(data.matrix, means, eng.scores,
                                            eng.idx, users, 10)
    assert compare.gaps(got_s, got_i, ref_s, ref_i) == (0.0, 0)


def test_bf16_control_departs(data):
    users = torch.arange(0, 240, 3)
    ref = topk.topk_rows(data.matrix, users, 20)
    low = topk.topk_rows(data.matrix, users, 20, dtype=torch.bfloat16)
    gap, bad = compare.gaps(*low, *ref)
    assert gap > 0 and bad > 0


def test_compare_reads_nan_and_equal_infinities():
    s = torch.tensor([[1.0, float("-inf")]])
    i = torch.tensor([[3, -1]])
    assert compare.gaps(s, i, s.clone(), i.clone()) == (0.0, 0)
    bad = torch.tensor([[float("nan"), float("-inf")]])
    assert compare.gaps(bad, i, s, i)[0] == float("inf")
