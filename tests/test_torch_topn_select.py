"""``core/predict.py::topn_unseen`` through kernel 5's canonical select.

The oracle is the full stable sort ``topn_unseen`` took before, kept here
inline: mask seen items to −inf, sort descending and stable, keep n, map
every −inf slot to item −1.  Ids and scores must equal it bit for bit on
every route.  The CPU cases run the select's plain twin; the ``cuda``
fixture's cases launch the kernel and skip, with a reason, without a
CUDA card.  On the card: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_topn_select.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import predict as pr
from repro_torch.core.facade import CFEngine
from repro_torch.kernels.select import SELECT_M_MAX, select_topm
from repro_torch.serving import engine as serving_engine

NEG_INF = float("-inf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def sorted_topn(pred, seen, n):
    """The stable-sort formula: the oracle of every case."""
    masked = pred.masked_fill(seen, NEG_INF)
    vals, items = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, items = vals[:, :n], items[:, :n].to(torch.int32)
    return vals, torch.where(vals == NEG_INF, torch.full_like(items, -1),
                             items)


def block(q, width, seed, *, device="cpu"):
    """(q, width) predictions in [1, 5] on a 0.25 grid, about one in nine
    clamped to exactly 5.0 so that ties cross a top-10 cut, and a sparse
    seen mask; row 0 has every item seen and row 1 three items unseen."""
    g = torch.Generator().manual_seed(seed)
    raw = 1.0 + 4.5 * torch.rand((q, width), generator=g)
    pred = (torch.round(raw * 4.0) / 4.0).clamp(1.0, 5.0)
    seen = torch.rand((q, width), generator=g) < 0.05
    seen[0] = True
    if q > 1:
        seen[1] = True
        seen[1, torch.randperm(width, generator=g)[:3]] = False
    return pred.to(device), seen.to(device)


def few_distinct(q, width, seed, *, device="cpu"):
    """Predictions of three values only: every cut falls inside a tie."""
    g = torch.Generator().manual_seed(seed)
    pred = torch.randint(1, 4, (q, width), generator=g).float()
    seen = torch.rand((q, width), generator=g) < 0.5
    return pred.to(device), seen.to(device)


# name → (maker, q, width, n, route); the CPU shapes, small
CASES = {
    "ties_at_5": (block, 64, 1000, 10, "select"),
    "three_values": (few_distinct, 16, 40, 5, "select"),
    "all_seen_and_few_unseen": (block, 4, 50, 10, "select"),
    "n_past_width": (block, 4, 7, 10, "select"),
    "n_equals_width": (block, 4, 10, 10, "select"),
    "n_one": (block, 8, 300, 1, "select"),
    "n_at_select_max": (block, 2, SELECT_M_MAX + 16, SELECT_M_MAX,
                        "select"),
    "n_past_select_max": (block, 2, SELECT_M_MAX + 16, SELECT_M_MAX + 1,
                          "sort"),
    "n_past_select_max_narrow_row": (block, 4, 300, SELECT_M_MAX + 1,
                                     "select"),
    "n_zero": (block, 4, 50, 0, "sort"),
    "no_items": (block, 4, 0, 10, "sort"),
}


def counts():
    return (obs.counter("recommend.topn.select").value,
            obs.counter("recommend.topn.sort").value)


def assert_bitwise(got, want):
    (g_s, g_i), (w_s, w_i) = got, want
    assert g_s.shape == w_s.shape and g_i.shape == w_i.shape
    assert g_s.dtype == w_s.dtype == torch.float32
    assert g_i.dtype == w_i.dtype == torch.int32
    assert torch.equal(g_i, w_i)
    assert torch.equal(g_s.view(torch.int32), w_s.view(torch.int32))


def run_case(pred, seen, n, route, *, use_kernel=True):
    """``topn_unseen`` once: equal to the oracle, one count on ``route``."""
    sel0, sort0 = counts()
    got = pr.topn_unseen(pred, seen, n, use_kernel=use_kernel)
    sel1, sort1 = counts()
    assert (sel1 - sel0, sort1 - sort0) == \
        ((1, 0) if route == "select" else (0, 1))
    assert_bitwise(got, sorted_topn(pred, seen, n))
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_topn_unseen_equals_stable_sort(name):
    maker, q, width, n, route = CASES[name]
    pred, seen = maker(q, width, seed=len(name))
    scores, items = run_case(pred, seen, n, route)
    for u in range(q):                     # never a seen item
        row = items[u][items[u] >= 0].long()
        assert not seen[u, row].any()


def test_unfillable_slots_are_minus_one():
    pred, seen = block(4, 50, seed=3)
    scores, items = run_case(pred, seen, 10, "select")
    assert items[0].tolist() == [-1] * 10               # every item seen
    assert (items[1, :3] >= 0).all() and items[1, 3:].tolist() == [-1] * 7
    assert torch.isneginf(scores[0]).all()
    assert torch.isneginf(scores[1, 3:]).all()


def test_cut_falls_inside_ties_at_5():
    pred, seen = block(64, 1000, seed=11)
    scores, items = run_case(pred, seen, 10, "select")
    full = (pred.masked_fill(seen, NEG_INF) == 5.0).sum(1)
    assert (full[2:] > 10).all()          # the cut lies in the 5.0 ties
    assert (scores[2:] == 5.0).all()
    for u in range(2, 64):               # the lowest ten unseen 5.0 ids
        want = torch.nonzero((pred[u] == 5.0) & ~seen[u]).flatten()[:10]
        assert items[u].tolist() == want.tolist()


def test_select_route_knocks_out_nothing_but_the_seen():
    # the route's ids of -1 knock out no column: an unseen item 0 of the
    # best score is returned first
    pred = torch.full((3, 6), 2.0)
    pred[:, 0] = 5.0
    seen = torch.zeros((3, 6), dtype=torch.bool)
    seen[2, 0] = True
    _, items = run_case(pred, seen, 2, "select")
    assert items.tolist() == [[0, 1], [0, 1], [1, 2]]


@pytest.mark.parametrize("name", ["ties_at_5", "all_seen_and_few_unseen",
                                  "n_past_width", "n_at_select_max"])
def test_plain_path_keeps_the_sort(name):
    # use_kernel=False is the plain path on every device: the stable sort
    maker, q, width, n, _ = CASES[name]
    pred, seen = maker(q, width, seed=len(name))
    run_case(pred, seen, n, "sort", use_kernel=False)


def small_ratings(seed=0, users=40, items=30):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (users, items)).astype(np.float32)
    return r * (rng.random((users, items)) < 0.4)


@pytest.mark.parametrize("backend,route", [("sequential", "sort"),
                                           ("kernel", "select")])
def test_engine_route_follows_its_use_kernel(backend, route):
    eng = CFEngine(small_ratings(), measure="pcc", k=5, block_size=16,
                   backend=backend, device="cpu").fit()
    sel0, sort0 = counts()
    got = eng.recommend(n=4)
    sel1, sort1 = counts()
    assert sel1 - sel0 + sort1 - sort0 >= 1
    assert (sel1 - sel0 if route == "sort" else sort1 - sort0) == 0
    ratings = torch.from_numpy(small_ratings())
    want = pr.topn_unseen(eng.predict(), ratings > 0, 4, use_kernel=False)
    assert_bitwise(got, want)


@pytest.mark.parametrize("use_kernel,route", [(False, "sort"),
                                              (True, "select")])
def test_batching_server_scoring_route_follows_use_kernel(use_kernel,
                                                           route):
    eng = CFEngine(small_ratings(1), measure="pcc", k=5, block_size=16,
                   device="cpu").fit()
    ratings, scores, idx, means = eng.snapshot()
    users = torch.tensor([3, 0, 17, 39])
    sel0, sort0 = counts()
    got = pr.recommend_block(ratings, ratings, scores[users], idx[users],
                             means, means[users], users, n=6,
                             item_block=serving_engine._ITEM_BLOCK,
                             use_kernel=use_kernel)
    sel1, sort1 = counts()
    assert (sel1 - sel0, sort1 - sort0) == \
        ((1, 0) if route == "select" else (0, 1))
    assert_bitwise(got, eng.recommend(users.numpy(), n=6))


# -- on the card ---------------------------------------------------------

CARD_CASES = {
    "block_1024x17770_ties_at_5": (block, 1024, 17770, 10, "select"),
    "all_seen_and_few_unseen": (block, 4, 17770, 10, "select"),
    "n_past_width": (block, 4, 7, 10, "select"),
    "three_values": (few_distinct, 256, 4099, 25, "select"),
    "n_past_select_max": (block, 4, 17770, SELECT_M_MAX + 1, "sort"),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_topn_unseen_on_card_equals_stable_sort(cuda, name):
    maker, q, width, n, route = CARD_CASES[name]
    pred, seen = maker(q, width, seed=len(name), device=cuda)
    launches = select_topm.launches
    run_case(pred, seen, n, route)
    torch.cuda.synchronize()
    assert select_topm.launches == launches + (route == "select")


def test_topn_unseen_on_card_matches_cpu_twin(cuda):
    pred, seen = block(1024, 17770, seed=5)
    on_card = pr.topn_unseen(pred.to(cuda), seen.to(cuda), 10)
    on_cpu = pr.topn_unseen(pred, seen, 10)
    assert_bitwise(tuple(t.cpu() for t in on_card), on_cpu)


def test_sequential_engine_on_card_keeps_the_sort(cuda):
    # the plain backend launches no select and equals the kernel backend
    r = small_ratings(2, users=600, items=700)
    seq = CFEngine(r, measure="pcc", k=10, backend="sequential",
                   device=cuda).fit()
    ker = CFEngine(r, measure="pcc", k=10, backend="kernel",
                   device=cuda).fit()
    launches = select_topm.launches
    plain = seq.recommend(n=10)
    torch.cuda.synchronize()
    assert select_topm.launches == launches
    fast = ker.recommend(n=10)
    torch.cuda.synchronize()
    assert select_topm.launches > launches
    assert_bitwise(fast, plain)
