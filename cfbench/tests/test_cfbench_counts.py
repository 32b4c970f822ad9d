"""The frozen counts against brute counts at tiny shapes, and their
independence of any blocking."""

import itertools

import pytest
import torch

from cfbench import counts
from cfbench.tests.tiny import ROOT  # noqa: F401  (puts the repo on the path)


def brute_fit_macs(n_users, n_items, q_users=None, c_users=None):
    """Multiply-adds pcc needs over (query, candidate, item) triples: sum_a
    and sq_a for every ordered pair, n and dot once an unordered pair (a
    pair's mirror has the same two sums)."""
    q_users = range(n_users) if q_users is None else q_users
    c_users = range(n_users) if c_users is None else c_users
    macs = 0
    for a, b in itertools.product(q_users, c_users):
        for _ in range(n_items):
            macs += 2                       # sum_a, sq_a
            if a <= b:
                macs += 2                   # n, dot
    return macs


@pytest.mark.parametrize("u,i", [(1, 1), (3, 2), (5, 7), (8, 3)])
def test_fit_count_is_the_brute_count(u, i):
    work = counts.fit_work(u, i, k=2)
    assert work["ops"] == 2 * brute_fit_macs(u, i)
    assert work["bytes"] == u * i + u * 2 * 8


@pytest.mark.parametrize("block", [1, 2, 3, 4, 7])
def test_fit_count_is_blocking_free(block):
    u, i = 7, 5
    blocks = [range(lo, min(u, lo + block)) for lo in range(0, u, block)]
    total = sum(brute_fit_macs(u, i, q, c)
                for q, c in itertools.product(blocks, blocks))
    assert 2 * total == counts.fit_work(u, i, k=3)["ops"]


def brute_pass(ratings, ids, weights, n):
    """Operations and bytes one recommend pass needs, counted term by
    term: 4 a rated (neighbor, item) term of positive weight, 5 a (user,
    item) prediction; the ratings at a byte a cell, the cache, means and
    top-n at their widths."""
    u, i = ratings.shape
    ops = 0
    for user in range(u):
        for slot in range(ids.shape[1]):
            if weights[user, slot] > 0 and ids[user, slot] >= 0:
                ops += 4 * int((ratings[ids[user, slot]] > 0).sum())
        ops += 5 * i
    n_bytes = u * i + ids.numel() * 8 + u * 4 + u * n * 8
    return ops, n_bytes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass_count_is_the_brute_count(seed):
    g = torch.Generator().manual_seed(seed)
    r = torch.randint(0, 6, (9, 11), generator=g).float()
    ids = torch.randint(-1, 9, (9, 4), generator=g).int()
    w = torch.rand(9, 4, generator=g) - 0.2
    terms = counts.rated_terms((r > 0).sum(1), ids, w)
    work = counts.recommend_work(9, 11, 4, 3, terms)
    assert (work["ops"], work["bytes"]) == brute_pass(r, ids, w, 3)


@pytest.mark.parametrize("block", [1, 2, 5, 9])
def test_pass_count_is_blocking_free(block):
    g = torch.Generator().manual_seed(4)
    r = torch.randint(0, 6, (9, 11), generator=g).float()
    ids = torch.randint(0, 9, (9, 4), generator=g).int()
    w = torch.rand(9, 4, generator=g)
    cnt = (r > 0).sum(1)
    whole = counts.rated_terms(cnt, ids, w)
    parts = sum(counts.rated_terms(cnt, ids[lo:lo + block], w[lo:lo + block])
                for lo in range(0, 9, block))
    assert parts == whole


def test_bound_takes_the_larger_side():
    peaks = counts.H100_PEAKS
    fit = counts.fit_work(6040, 3952, 40)
    assert counts.bound_seconds(fit, peaks) == fit["ops"] / peaks["int8_ops"]
    pas = counts.recommend_work(393216, 17770, 40, 10, 10 ** 9)
    assert counts.bound_seconds(pas, peaks) == pas["bytes"] / peaks["hbm_bytes"]
    assert counts.peaks_for("NVIDIA H100 80GB HBM3") is peaks
    assert counts.peaks_for("cpu") is None
