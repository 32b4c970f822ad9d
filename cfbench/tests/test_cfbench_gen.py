"""The device generator at a small scale of each configuration's marginals
(run on the CPU): sizes, the exact rating total, the 1-5 histogram, the
per-user minimum, and one seed giving one matrix."""

import json

import pytest
import torch

from cfbench.tests.tiny import ROOT
from cfbench import gen

CONFIGS = sorted((ROOT / "cfbench" / "configs").glob("*.json"))


def small(path, users=400):
    """The configuration at ``users`` users and at most 600 items, its
    ratings a user and minimum kept."""
    cfg = json.loads(path.read_text())
    items = min(cfg["n_items"], 600)
    per_user = min(cfg["n_ratings"] / cfg["n_users"], items / 4)
    return dict(cfg, n_users=users, n_items=items,
                n_ratings=int(per_user * users))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_marginals(path):
    cfg = small(path)
    data = gen.generate(cfg, 2 ** 31 + 3, "cpu")
    r = data.matrix
    assert r.shape == (cfg["n_users"], cfg["n_items"])
    cnt = (r > 0).sum(1)
    # the total is exact: the tolerance of the generator is 0
    assert int(cnt.sum()) == cfg["n_ratings"]
    assert torch.equal(cnt, data.counts)
    assert int(cnt.min()) >= cfg["min_user_ratings"]
    vals = r[r > 0]
    assert set(torch.unique(vals).tolist()) == {1.0, 2.0, 3.0, 4.0, 5.0}
    hist = torch.bincount(vals.long(), minlength=6)[1:].double() / len(vals)
    assert float(hist.min()) > 0.01 and float(hist[2:].sum()) > 0.6
    assert abs(float(vals.mean()) - cfg["published"]["mean_rating"]) < 0.15


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_seed_gives_one_matrix(path):
    cfg = small(path, 200)
    a = gen.generate(cfg, 99, "cpu").matrix
    assert torch.equal(a, gen.generate(cfg, 99, "cpu").matrix)
    assert not torch.equal(a, gen.generate(cfg, 100, "cpu").matrix)


def test_counts_are_one_set_for_every_seed():
    cfg = small(CONFIGS[0], 300)
    a = gen.generate(cfg, 1, "cpu").counts
    b = gen.generate(cfg, 2, "cpu").counts
    assert torch.equal(torch.sort(a).values, torch.sort(b).values)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("users,items,total,low", [
    (6040, 3952, 1_000_209, 20), (65536, 17770, 13_713_539, 1),
    (1000, 50, 40_000, 1)])
def test_activity_counts_sum_exactly(users, items, total, low):
    c = gen.activity_counts(users, items, total, low, 0.9)
    assert int(c.sum()) == total
    assert int(c.min()) >= low and int(c.max()) <= items
    assert torch.equal(c, torch.sort(c).values)


def test_update_stream_is_seeded_and_deduplicated():
    cfg = small(CONFIGS[0], 100)
    data = gen.generate(cfg, 5, "cpu")
    one = gen.UpdateStream(data, 5, 500)
    two = gen.UpdateStream(data, 5, 500)
    for _ in range(3):
        c1, v1 = one.next()
        c2, v2 = two.next()
        assert torch.equal(c1, c2) and torch.equal(v1, v2)
        assert set(v1.unique().tolist()) <= {1.0, 2.0, 3.0, 4.0, 5.0}
        # a cell drawn twice carries one value, so the write is determinate
        for cell in c1.unique():
            assert len(v1[c1 == cell].unique()) == 1


def test_neighbor_cache():
    cfg = small(CONFIGS[0], 300)
    data = gen.generate(cfg, 8, "cpu")
    w, ids = gen.neighbor_cache(data, 8, 40)
    assert w.shape == ids.shape == (300, 40)
    assert float(w.min()) > 0 and float(w.max()) <= 1
    assert torch.all(w[:, :-1] >= w[:, 1:])
    assert not torch.any(ids == torch.arange(300)[:, None])
    assert all(len(set(row)) == 40 for row in ids.tolist())
    w2, ids2 = gen.neighbor_cache(data, 8, 40)
    assert torch.equal(w, w2) and torch.equal(ids, ids2)
