"""The exact recommend's user ids, staged on the device once a call.

``CFEngine._recommend_exact`` pads every block's ids in numpy and copies
them to the device in one step before its block loop, and slices a
block's ids from them, so no block copies from the host and the host
issues block b+1 while the device still runs block b.
The oracle is the loop it replaced, kept here inline: each block pads its
ids in numpy and copies them to the device.  ``USER_BLOCK`` is patched to
8 so that a small CPU engine runs many blocks; the answers must equal the
oracle's bit for bit, and ``obs`` counter ``recommend.ids.staged`` rises
by one an exact call whatever its block count.

The ``cuda`` fixture's cases profile an exact call of three blocks and a
kernel fit at ML-1M's 6,040 × 3,952 on the card (at most three host waits
in ``engine.fit``: the gather operand's one read, the rows-past-bound
count, the publish fence), and skip, with a reason, without a CUDA card.
On the card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_recommend_ids.py``.
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import facade
from repro_torch.core import predict as pr
from repro_torch.core.facade import CFEngine

BLOCK = 8
N = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def ratings(n_users, n_items=40, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n_users, n_items)) < 0.3)
            * rng.integers(1, 6, (n_users, n_items))).astype(np.float32)


_ENGINES = {}


def engine(n_users, recommend_mode="exact"):
    key = (n_users, recommend_mode)
    if key not in _ENGINES:
        _ENGINES[key] = CFEngine(ratings(n_users), k=6, block_size=32,
                                 device="cpu",
                                 recommend_mode=recommend_mode).fit()
    return _ENGINES[key]


def per_block_copies(eng, uids, n):
    """The loop before staging: a block's ids padded in numpy and copied
    to the device, block by block."""
    ratings_, scores, idx, means = eng.snapshot()
    src = eng._gather_source(ratings_)
    ub = min(facade.USER_BLOCK, facade._bucket(len(uids), eng.n_users))
    out_s, out_i = [], []
    for lo in range(0, len(uids), ub):
        ids = uids[lo:lo + ub]
        ids_pad = np.full((ub,), eng.n_users, np.int64)
        ids_pad[:len(ids)] = ids
        ids_t = torch.as_tensor(ids_pad, device=eng.device)
        safe = ids_t.clamp(0, eng.n_users - 1)
        s, i = pr.recommend_block(
            ratings_, src, scores[safe], idx[safe], means, means[safe],
            ids_t, n=n, item_block=facade.ITEM_BLOCK,
            use_kernel=eng.use_kernel)
        out_s.append(s[:len(ids)])
        out_i.append(i[:len(ids)])
    return torch.cat(out_s), torch.cat(out_i)


def assert_bitwise(got, want):
    (g_s, g_i), (w_s, w_i) = got, want
    assert g_s.shape == w_s.shape and g_i.shape == w_i.shape
    assert g_s.dtype == w_s.dtype and g_i.dtype == w_i.dtype
    assert torch.equal(g_i, w_i)
    assert torch.equal(g_s.view(torch.int32), w_s.view(torch.int32))


def shuffled(n_users, count, seed):
    return np.random.default_rng(seed).permutation(n_users)[:count]


# name → (engine users, the call's ids: None for all users, else how many
# of them in a shuffled order); blocks of 8
CASES = {
    "all_one_block_full": (8, None),
    "all_fewer_than_a_block": (5, None),
    "all_two_blocks_full": (16, None),
    "all_many_blocks_full": (64, None),
    "all_many_blocks_partial": (61, None),
    "ids_one_block_full": (61, 8),
    "ids_one_block_partial": (61, 3),
    "ids_two_blocks_full": (61, 16),
    "ids_two_blocks_partial": (61, 13),
    "ids_many_blocks_full": (61, 56),
    "ids_many_blocks_partial": (61, 61),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_ids_equal_per_block_copies(name, monkeypatch):
    monkeypatch.setattr(facade, "USER_BLOCK", BLOCK)
    n_users, count = CASES[name]
    eng = engine(n_users)
    if count is None:
        got = eng.recommend(n=N)
        uids = np.arange(n_users, dtype=np.int64)
    else:
        uids = shuffled(n_users, count, seed=len(name))
        got = eng.recommend(uids, n=N)
    assert got[0].shape == (len(uids), N)
    assert_bitwise(got, per_block_copies(eng, uids, N))


def test_repeated_ids_equal_per_block_copies(monkeypatch):
    monkeypatch.setattr(facade, "USER_BLOCK", BLOCK)
    eng = engine(61)
    uids = np.array([7, 3, 7, 60, 0, 3, 3, 59, 1, 7, 60], np.int64)
    assert_bitwise(eng.recommend(uids, n=N),
                   per_block_copies(eng, uids, N))


def staged():
    return obs.counter("recommend.ids.staged").value


def recorded_blocks():
    return sum(1 for s in obs.get_spans() if s.name == "recommend.block")


@pytest.mark.parametrize("count", [None, 1, 8, 13, 61])
def test_staged_once_an_exact_call_whatever_its_blocks(count, monkeypatch):
    monkeypatch.setattr(facade, "USER_BLOCK", BLOCK)
    eng = engine(61)
    uids = None if count is None else shuffled(61, count, seed=count)
    obs.clear()
    before = staged()
    eng.recommend(uids, n=N)
    assert staged() - before == 1
    assert recorded_blocks() == math.ceil((count or 61) / BLOCK)


def test_approx_recommend_stages_nothing(monkeypatch):
    monkeypatch.setattr(facade, "USER_BLOCK", BLOCK)
    eng = engine(61, recommend_mode="approx")
    before = staged()
    eng.recommend(n=N)
    eng.recommend(shuffled(61, 13, seed=1), n=N, mode="approx")
    assert staged() == before
    eng.recommend(n=N, mode="exact")
    assert staged() == before + 1


def sync_names():
    """``cfbench/spans.py``'s ``SYNC_NAMES``, read from its source (the
    port's tests import nothing of the benchmark)."""
    path = Path(__file__).resolve().parents[1] / "cfbench" / "spans.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SYNC_NAMES" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError("no SYNC_NAMES in cfbench/spans.py")


def waits_inside(prof, tmp_path, root="engine.recommend"):
    """Host waits on the device that start inside a ``root`` span."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = [e for e in (doc["traceEvents"] if isinstance(doc, dict)
                          else doc) if e.get("ph") == "X" and "ts" in e]
    roots = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == root and e.get("cat") == "user_annotation"]
    assert len(roots) == 1
    (a, b), names = roots[0], sync_names()
    return [e["name"] for e in events
            if e["name"] in names and a <= e["ts"] <= b]


def test_card_exact_recommend_waits_at_most_once(cuda, tmp_path):
    """Three blocks of 1,024 users on the card: at most one host wait in
    ``engine.recommend`` (the ids' one copy), where the per-block copies
    made one a block."""
    n_users = 3 * facade.USER_BLOCK
    eng = CFEngine(ratings(n_users, 500, seed=3), k=20, device=cuda).fit()
    uids = shuffled(n_users, n_users - 100, seed=4)
    for call in (lambda: eng.recommend(n=10),
                 lambda: eng.recommend(uids, n=10)):
        call()                                   # warm: builds, gathers
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = call()
            torch.cuda.synchronize()
        waits = waits_inside(prof, tmp_path)
        assert len(waits) <= 1, waits
    assert_bitwise(got, per_block_copies(eng, uids, 10))


def test_card_kernel_fit_waits_at_most_three_times(cuda, tmp_path):
    """A kernel fit of a fresh engine over ML-1M's 6,040 × 3,952, as each
    refit step makes one: at most three host waits in ``engine.fit``, where
    reading the int8 copy's exactness and its bound apart made four."""
    r = torch.as_tensor(ratings(6040, 3952, seed=5), device=cuda)
    CFEngine(r, k=40, device=cuda).fit()         # warm: builds the kernels
    torch.cuda.synchronize()
    eng = CFEngine(r, k=40, device=cuda)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.fit()
        torch.cuda.synchronize()
    waits = waits_inside(prof, tmp_path, root="engine.fit")
    assert len(waits) <= 3, waits
    assert eng._gather_cache.entry[1].max_value == 5
