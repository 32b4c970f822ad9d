"""The port's spans on the profiler's clock: under ``torch.profiler`` a
fit and a recommend call leave their span tree as ``user_annotation``
events, nested by time; with no profiler running no span builds a
``record_function``."""

import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import facade
from repro_torch.core.facade import CFEngine

FIT_TREE = {
    "engine.fit": None,
    "fit.user_stats": "engine.fit",
    "fit.topk": "engine.fit",
    "gather_source.build": "fit.topk",
    "gather_source.check": "gather_source.build",
    "topk.block": "fit.topk",
    "topk.score": "topk.block",
    "topk.merge": "topk.block",
    "topk.check_bad": "fit.topk",
    "fit.publish": "engine.fit",
}
RECOMMEND_TREE = {
    "engine.recommend": None,
    "recommend.block": "engine.recommend",
    "recommend.ids": "recommend.block",
    "recommend.predict": "recommend.block",
    "recommend.topn": "recommend.block",
}


def _ratings(n_users=300, n_items=50, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n_users, n_items)) < 0.3)
            * rng.integers(1, 6, (n_users, n_items))).astype(np.float32)


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _parent(ev, events):
    """The innermost annotation that holds ``ev`` (the shortest)."""
    name, a, b = ev
    holders = [e for e in events if e is not ev and e[1] <= a and b <= e[2]]
    return min(holders, key=lambda e: e[2] - e[1])[0] if holders else None


def test_fit_and_recommend_span_trees_under_the_profiler(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(facade, "USER_BLOCK", 64)     # 300 users: 5 blocks
    eng = CFEngine(_ratings(), k=8, device="cpu", block_size=128)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.fit()
        got_s, got_i = eng.recommend(n=5)
    events = _annotations(prof, tmp_path)
    names = [e[0] for e in events]
    for tree in (FIT_TREE, RECOMMEND_TREE):
        for ev in (e for e in events if e[0] in tree):
            assert _parent(ev, events) == tree[ev[0]], ev
    assert set(FIT_TREE) | set(RECOMMEND_TREE) == set(names)
    assert names.count("topk.block") == 3         # ceil(300 / 128)
    assert names.count("topk.score") == names.count("topk.merge") == 3
    assert names.count("recommend.block") == 5    # ceil(300 / 64)
    for name in ("recommend.ids", "recommend.predict", "recommend.topn"):
        assert names.count(name) == 5
    for name in ("engine.fit", "engine.recommend", "fit.publish",
                 "topk.check_bad", "gather_source.build",
                 "gather_source.check"):
        assert names.count(name) == 1, name
    # the spans change no result
    want_s, want_i = eng.recommend(n=5)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


def test_no_profiler_builds_no_record_function(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with obs.span("outer") as sp:
        with obs.span("inner"):
            pass
    assert sp.duration >= 0.0
    eng = CFEngine(_ratings(40, 20), k=4, device="cpu").fit()
    eng.recommend(n=3)


def test_span_closes_its_range_on_an_exception(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with obs.span("fails"):
                raise ValueError("x")
        with obs.span("after"):
            torch.ones(2).add_(1)
    events = _annotations(prof, tmp_path)
    by = {e[0]: e for e in events}
    assert set(by) == {"fails", "after"}
    assert by["fails"][2] <= by["after"][1]     # closed before the next
    assert obs.current_span() is None
