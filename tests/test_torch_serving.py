"""The port's supervised ``BatchingServer`` on the CPU: every future
resolves, served answers equal ``engine.recommend``, transient faults are
retried, deadlines and admission bounds hold, ``stop()`` strands nothing,
and a stress run with concurrent rating updates is race-clean under the
reference's ``RaceTracer``.  The legacy form ``BatchingServer(cf_model,
ratings)`` answers as ``UserCF.recommend``, as the facade form and as the
reference's legacy server; the serve CLI runs both engines on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.analysis.races import RaceTracer
from repro_torch import obs
from repro_torch.core.facade import BACKENDS, CFEngine
from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                     RecoveryPolicy,
                                                     StragglerWatchdog)
from repro_torch.serving.engine import (BatchingServer, DeadlineExceeded,
                                        DegradationLadder, Overloaded,
                                        ServerStopped)


def _engine(seed=0, u=64, d=32, backend="kernel", **kw):
    r = int_ratings(np.random.default_rng(seed), u, d, density=0.5)
    return CFEngine(r, measure="cosine", k=5, block_size=16,
                    backend=backend, device="cpu", **kw).fit()


def _server(eng, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("topn", 3)
    return BatchingServer(eng, device="cpu", **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_served_answers_equal_engine_recommend(backend):
    eng = _engine(backend=backend)
    server = _server(eng)
    server.start()
    users = list(range(0, 64, 3))
    futs = [server.submit(u) for u in users]
    res = [f.result(timeout=30) for f in futs]
    server.stop()
    _, want = eng.recommend(users, n=3)
    for r, u, w in zip(res, users, want):
        assert r.user == u
        np.testing.assert_array_equal(r.items, w.numpy())
    st = server.stats()
    assert st["n_requests"] == len(users) and st["n_failures"] == 0
    assert st["n_batches"] >= len(users) // 4
    assert st["latency_p99_ms"] >= st["latency_p50_ms"] > 0


def test_server_refuses_missing_card_and_unfitted_engine(monkeypatch):
    eng = _engine()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchingServer(eng)
    unfitted = CFEngine(np.ones((4, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match="fit"):
        BatchingServer(unfitted, device="cpu")


def test_transient_fault_is_retried():
    server = _server(_engine(), fault_injector=FaultInjector(
        fail_at_steps=(1,)), recovery=RecoveryPolicy(max_restarts=2))
    server.start()
    futs = [server.submit(u) for u in range(4)]
    res = [f.result(timeout=30) for f in futs]
    server.stop()
    assert len(res) == 4
    st = server.stats()
    assert st["n_failures"] == 1 and st["n_retries"] == 1
    assert st["n_recoveries"] == 1


def test_fault_beyond_retry_budget_fails_the_batch_loudly():
    server = _server(_engine(), fault_injector=FaultInjector(
        fail_at_steps=(1,)), recovery=RecoveryPolicy(max_restarts=0))
    server.start()
    futs = [server.submit(u) for u in range(4)]
    errors = 0
    for f in futs:
        try:
            f.result(timeout=30)
        except RuntimeError:
            errors += 1
    server.stop()
    assert errors >= 1
    assert server.stats()["n_failures"] == 1
    # the batcher survived: a later request is served
    server2 = _server(_engine())
    server2.start()
    assert server2.submit(3).result(timeout=30).user == 3
    server2.stop()


def test_deadline_and_overload_paths():
    server = _server(_engine(), max_queue=3)
    # not started: the queue fills, the 4th submit is refused at admission
    futs = [server.submit(u, deadline_ms=1.0) for u in range(3)]
    with pytest.raises(Overloaded):
        server.submit(9)
    time.sleep(0.01)                   # every queued deadline passes
    server.start()
    for f in futs:
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=30)
    server.stop()
    st = server.stats()
    assert st["n_shed"] == 1 and st["n_deadline_exceeded"] == 3
    with pytest.raises(ServerStopped):
        server.submit(1)
    with pytest.raises(ValueError):
        server.submit(1, request_class="batch")


def test_out_of_range_users_are_refused_on_the_host():
    eng = _engine()
    server = _server(eng)
    for bad in (-1, 64, 10**9):
        with pytest.raises(ValueError, match="out of range"):
            server.submit(bad)
    with pytest.raises(ValueError, match="out of range"):
        eng.recommend([3, 64])
    with pytest.raises(ValueError, match="out of range"):
        eng.predict([-2])
    assert server.stats()["n_requests"] == 0


def test_stop_strands_nothing():
    for drain in (True, False):
        server = _server(_engine(), max_wait_ms=50.0)
        server.start()
        futs = [server.submit(u % 64) for u in range(40)]
        server.stop(drain=drain)
        served = stopped = 0
        for f in futs:
            assert f.done()
            try:
                f.result(timeout=0)
                served += 1
            except ServerStopped:
                stopped += 1
        assert served + stopped == 40
        if drain:
            assert served == 40


def test_shedding_ladder_refuses_bulk_traffic():
    ladder = DegradationLadder(degrade_p99_ms=0.0, shed_p99_ms=0.0,
                               window=1)
    server = _server(_engine(), ladder=ladder,
                     watchdog=StragglerWatchdog())
    server.start()
    server.submit(1).result(timeout=30)
    deadline = time.time() + 10
    while server.health != "SHEDDING" and time.time() < deadline:
        time.sleep(0.005)
    assert server.health == "SHEDDING"
    with pytest.raises(Overloaded, match="SHEDDING"):
        server.submit(2, request_class="bulk")
    assert server.submit(2).result(timeout=30).user == 2
    server.stop()
    assert server.stats()["health"] == "SHEDDING"


def test_spans_and_registry_record_the_serving_path():
    obs.clear()
    reg = obs.MetricsRegistry()
    server = _server(_engine(), registry=reg)
    server.start()
    server.submit(5).result(timeout=30)
    server.stop()
    names = {s.name for s in obs.get_spans()}
    assert {"serve.batch", "serve.predict"} <= names
    snap = reg.snapshot()
    assert snap["counters"]["serve.requests"] == 1
    assert snap["histograms"]["serve.latency_seconds"]["count"] == 1
    # a CPU tensor needs no fence; the span still times
    with obs.span("noop", device_sync=True) as sp:
        sp.track(torch.zeros(3))
    assert sp.duration >= 0.0


def test_serving_stack_is_race_clean_under_updates():
    """Batcher thread serving while the main thread applies rating updates
    and polls stats(); every attribute access on engine and server is
    traced, and anything unguarded must be covered by the engine's
    annotated single-writer contract."""
    rng = np.random.default_rng(1)
    eng = _engine(backend="sequential")
    server = _server(eng)
    tracer = RaceTracer()
    with tracer.trace(eng, "engine"), tracer.trace(server, "server"):
        server.start()
        futures = []
        for i, u in enumerate(rng.integers(0, 64, 48)):
            futures.append(server.submit(int(u)))
            if i % 6 == 5:
                eng.update_ratings([int(rng.integers(0, 64))],
                                   [int(rng.integers(0, 32))], [4.0])
            server.stats()
        done = [f.result(timeout=30) for f in futures]
        time.sleep(0.02)
        server.stop()
    assert len(done) == 48
    tracer.assert_clean()
    sup = tracer.report(include_suppressed=True)
    assert any(f.attr == "_snapshot" and f.suppressed for f in sup)


def test_concurrent_submitters_all_resolve():
    server = _server(_engine(), max_batch=8)
    server.start()
    futs, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        for u in rng.integers(0, 64, 25):
            f = server.submit(int(u))
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    res = [f.result(timeout=30) for f in futs]
    server.stop()
    assert len(res) == 200
    assert server.stats()["n_requests"] == 200


def test_fault_tolerance_and_metrics_match_reference():
    """The port's copies of the watchdog, the retry policy and the metrics
    registry behave as the reference's on the same inputs."""
    from repro.distributed import fault_tolerance as ref_ft
    from repro.obs import metrics as ref_metrics
    from repro_torch.obs import metrics
    times = [0.01, 0.01, 0.012, 0.011, 0.01, 0.01, 0.05, 0.06, 0.07, 0.01]
    a, b = StragglerWatchdog(), ref_ft.StragglerWatchdog()
    for step, t in enumerate(times):
        assert a.observe(step, t) == b.observe(step, t)
        assert a.needs_escalation == b.needs_escalation
    assert a.flagged_steps == b.flagged_steps
    p, q = RecoveryPolicy(max_restarts=2), ref_ft.RecoveryPolicy(
        max_restarts=2)
    assert [p.backoff_s(i) for i in range(10)] == \
        [q.backoff_s(i) for i in range(10)]
    with pytest.raises(Exception, match="injected"):
        FaultInjector(fail_at_steps=(3,)).check(3)
    r, s = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    vals = np.random.default_rng(0).lognormal(-5, 2, 500)
    for v in vals:
        r.histogram("h").observe(v)
        s.histogram("h").observe(v)
    assert r.snapshot() == s.snapshot()
    snap = r.snapshot()["histograms"]["h"]
    assert metrics.delta_quantile(None, snap, 0.99) == \
        ref_metrics.delta_quantile(None, snap, 0.99)


# -- an approx-recommend engine (the item index) behind the server -----------

def _approx_engine(seed=0, u=64, d=48, **kw):
    from repro_torch.index import ItemIndexConfig
    r = int_ratings(np.random.default_rng(seed), u, d, density=0.5)
    return CFEngine(r, measure="cosine", k=5, block_size=16, device="cpu",
                    recommend_mode="approx",
                    item_index_cfg=ItemIndexConfig(n_clusters=6,
                                                   shortlist=8), **kw).fit()


def test_served_approx_answers_equal_engine_recommend():
    eng = _approx_engine()
    server = _server(eng, topn=5)
    server.start()
    users = [0, 7, 31, 47, 63, 7]
    futs = [server.submit(u) for u in users]
    res = [f.result(timeout=30) for f in futs]
    server.stop()
    want_s, want_i = eng.recommend(users, n=5)
    seen = eng.ratings.numpy() > 0
    for r, u, w in zip(res, users, want_i):
        assert r.user == u
        np.testing.assert_array_equal(r.items, w.numpy())
        assert not seen[u, r.items[r.items >= 0]].any()
    # the kernel scorer's shortlist holds the exact top-n
    assert torch.equal(want_i, eng.recommend(users, n=5, mode="exact")[1])
    assert server.stats()["n_failures"] == 0


def test_ladder_budgets_match_reference():
    from repro.serving.engine import DegradationLadder as RefLadder
    for fracs in ((0.5, 0.5), (0.25, 0.75)):
        a = DegradationLadder(n_probe_frac=fracs[0], shortlist_frac=fracs[1])
        b = RefLadder(n_probe_frac=fracs[0], shortlist_frac=fracs[1])
        for level in range(3):
            for base in ((4, 8, 5), (39, 512, 10), (1, 3, 10)):
                assert a.budget(level, *base) == b.budget(level, *base)
    assert DegradationLadder().budget(0, 8, 64, 10) is None


def test_degraded_server_plans_per_class_budgets():
    eng = _approx_engine()
    ladder = DegradationLadder(staged_when_degraded=False, window=10**6)
    server = _server(eng, topn=5, ladder=ladder)
    assert (server._base_n_probe, server._base_shortlist) == (3, 8)
    server._health = 1                                    # DEGRADED
    live = [(3, 0.0, None, "interactive", None),
            (9, 0.0, None, "bulk", None)]
    plan = server._plan(live)
    assert [(cls, budget) for budget, cls, _ in plan] == [
        ("bulk", ladder.budget(2, 3, 8, 5)),
        ("interactive", ladder.budget(1, 3, 8, 5))]
    server.start()
    rec = server.submit(3).result(timeout=30)
    server.stop()
    _, want = eng.recommend([3], n=5, **ladder.budget(1, 3, 8, 5))
    np.testing.assert_array_equal(rec.items, want[0].numpy())
    # healthy, or no approx engine: one full-batch group at the defaults
    server._health = 0
    assert server._plan(live) == [(None, "interactive", live)]
    exact = _server(_engine(), ladder=ladder)
    exact._health = 1
    assert exact._plan(live) == [(None, "interactive", live)]


def test_staged_override_is_refused():
    """No longer refused: the default ladder (``staged_when_degraded``)
    constructs in front of an approx-recommend engine with a user index,
    a degraded transition switches the user index to its staged pipeline
    and recovery hands the choice back to its config; with
    ``staged_when_degraded=False`` the index is left alone."""
    from repro_torch.index import IndexConfig
    from repro_torch.serving.engine import DEGRADED, HEALTHY
    eng = _approx_engine(neighbor_mode="approx",
                         index_cfg=IndexConfig(n_clusters=4, project_dim=8,
                                               query_mode="fused"))
    server = _server(eng, topn=5, ladder=DegradationLadder())
    server.start()
    assert server.submit(2).result(timeout=30).user == 2
    server.stop()
    assert eng.index._query_mode() == "fused"
    server._transition(HEALTHY, DEGRADED, "test", 0.0, 0.0)
    assert eng.index.query_mode_override == "staged"
    assert eng.index._query_mode() == "staged"
    server._transition(DEGRADED, HEALTHY, "test", 0.0, 0.0)
    assert eng.index.query_mode_override is None
    assert eng.index._query_mode() == "fused"
    off = _server(eng, ladder=DegradationLadder(staged_when_degraded=False))
    off._transition(HEALTHY, DEGRADED, "test", 0.0, 0.0)
    assert eng.index.query_mode_override is None
    # no user index: nothing to switch, the default ladder is accepted
    plain = _server(_approx_engine(), ladder=DegradationLadder())
    plain._transition(HEALTHY, DEGRADED, "test", 0.0, 0.0)


def test_approx_serving_is_race_clean_under_updates():
    """The batcher serves an approx-recommend engine while the main thread
    applies rating updates (refolding the item index); engine, server and
    item index are traced, and every unguarded shared attribute must be
    covered by an annotated single-writer contract."""
    rng = np.random.default_rng(2)
    eng = _approx_engine(seed=2)
    server = _server(eng, topn=5)
    tracer = RaceTracer()
    with tracer.trace(eng, "engine"), tracer.trace(server, "server"), \
            tracer.trace(eng.item_index, "item_index"):
        server.start()
        futures = []
        for i, u in enumerate(rng.integers(0, 64, 40)):
            futures.append(server.submit(int(u)))
            if i % 5 == 4:
                eng.update_ratings([int(rng.integers(0, 64))],
                                   [int(rng.integers(0, 48))], [4.0])
            server.stats()
        done = [f.result(timeout=30) for f in futures]
        time.sleep(0.02)
        server.stop()
    assert len(done) == 40
    assert all(r.items.shape == (5,) for r in done)
    tracer.assert_clean()
    assert eng.item_index.check_consistent(eng.ratings, eng.means)


# -- the legacy form: BatchingServer(cf_model, ratings) ----------------------

def _usercf(seed=0, u=64, d=32):
    from repro_torch.core.cf_model import CFConfig, UserCF
    r = int_ratings(np.random.default_rng(seed), u, d, density=0.5)
    cf = UserCF(CFConfig(measure="cosine", top_k=5, block_size=16),
                device="cpu")
    cf.fit(r)
    return cf, torch.from_numpy(r)


def test_legacy_server_answers_equal_usercf_recommend():
    """The legacy form serves the fitted ``UserCF`` over its ratings: each
    answer equals ``UserCF.recommend`` for that user and the facade
    server's answer on an engine with the same neighbors."""
    cf, r = _usercf()
    server = BatchingServer(cf, r, device="cpu", max_batch=4,
                            max_wait_ms=2.0, topn=3)
    server.start()
    users = list(range(0, 64, 3)) + [5, 5]
    futs = [server.submit(u) for u in users]
    res = [f.result(timeout=30) for f in futs]
    server.stop()
    _, want = cf.recommend(r, n=3)
    for got, u in zip(res, users):
        assert got.user == u
        np.testing.assert_array_equal(got.items, want[u].numpy())
    eng = CFEngine(r.numpy(), measure="cosine", k=5, block_size=16,
                   backend="sequential", device="cpu").fit()
    assert torch.equal(eng.idx, cf.state.idx)
    facade = _server(eng)
    facade.start()
    futs = [facade.submit(u) for u in users]
    other = [f.result(timeout=30) for f in futs]
    facade.stop()
    for a, b in zip(res, other):
        np.testing.assert_array_equal(a.items, b.items)
    st = server.stats()
    assert st["n_requests"] == len(users) and st["n_failures"] == 0


def test_legacy_server_matches_reference_legacy_server():
    """The reference's legacy server on the reference's fitted model
    answers as the port's on the port's (cosine neighbors bit for bit)."""
    import jax.numpy as jnp
    from repro.core import CFConfig as RefConfig
    from repro.core import UserCF as RefUserCF
    from repro.serving.engine import BatchingServer as RefServer
    cf, r = _usercf(seed=3)
    ref = RefUserCF(RefConfig(measure="cosine", top_k=5, block_size=16))
    ref.fit(jnp.asarray(r.numpy()))
    users = [0, 9, 17, 40, 63]
    answers = []
    for srv in (RefServer(ref, jnp.asarray(r.numpy()), max_batch=4,
                          max_wait_ms=2.0, topn=3),
                BatchingServer(cf, r, device="cpu", max_batch=4,
                               max_wait_ms=2.0, topn=3)):
        srv.start()
        futs = [srv.submit(u) for u in users]
        answers.append([np.asarray(f.result(timeout=60).items)
                        for f in futs])
        srv.stop()
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a, b)


def test_legacy_server_refuses_unfitted_model_and_other_devices(
        monkeypatch):
    from repro_torch.core.cf_model import CFConfig, UserCF
    cf, r = _usercf()
    unfitted = UserCF(CFConfig(), device="cpu")
    with pytest.raises(ValueError, match="fit the model first"):
        BatchingServer(unfitted, r, device="cpu")
    with pytest.raises(ValueError, match="ratings on meta"):
        BatchingServer(cf, torch.zeros((64, 32), device="meta"),
                       device="cpu")
    # numpy ratings go to the server's device
    srv = BatchingServer(cf, r.numpy(), device="cpu", max_batch=2, topn=3)
    assert srv.n_batches == 0
    with pytest.raises(ValueError, match="out of range"):
        srv.submit(64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchingServer(cf, r)


def test_legacy_server_retries_a_transient_fault():
    cf, r = _usercf()
    server = BatchingServer(
        cf, r, device="cpu", max_batch=4, max_wait_ms=2.0, topn=3,
        fault_injector=FaultInjector(fail_at_steps=(1,)),
        recovery=RecoveryPolicy(max_restarts=2))
    server.start()
    res = [f.result(timeout=30) for f in [server.submit(u)
                                          for u in range(4)]]
    server.stop()
    assert len(res) == 4
    st = server.stats()
    assert st["n_retries"] == 1 and st["n_recoveries"] == 1


# -- the serve CLI ------------------------------------------------------------

@pytest.mark.parametrize("argv,want", [
    ([], "engine=legacy"),
    (["--engine", "facade"], "engine=facade backend=kernel"),
    (["--engine", "facade", "--recommend-mode", "approx"],
     "recommend_mode=approx"),
])
def test_serve_cli_on_the_cpu(capsys, argv, want):
    """``python -m repro_torch.launch.serve --device cpu``: the default
    ``legacy`` engine (as in the reference) and the facade serve the
    sample user the exact engine's top-10."""
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--users", "128", "--items", "64",
                "--requests", "16", "--max-batch", "8"] + argv)
    out = capsys.readouterr().out
    assert want in out and "16 requests" in out and "health=HEALTHY" in out
    sample = [line for line in out.splitlines()
              if line.startswith("sample:")]
    train = load_ml1m_synthetic(n_users=128, n_items=64)[0]
    eng = CFEngine(train, k=40, block_size=256, device="cpu").fit()
    items = eng.recommend([108], n=10)[1][0].tolist()
    assert sample == [f"sample: user 108 → items {items}"], sample


def test_serve_cli_refuses_facade_options_on_legacy(capsys):
    from repro_torch.launch import serve
    for flag in (["--backend", "ring"], ["--recommend-mode", "approx"]):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu"] + flag)
        assert "--engine facade only" in capsys.readouterr().err
