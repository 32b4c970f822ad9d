"""Engine-level checkpoint recovery on the port, on the CPU: the cases of
the reference's ``tests/test_engine_recovery.py`` run on
``repro_torch`` with its ``checkpoint`` module and chaos hooks.

Faults injected inside ``update_ratings`` (``CFEngine.fault_injector``)
and mid-refold (``ClusteredIndex.fault_injector``, between the ledger's
subtraction and re-add) leave torn state; restoring the last committed
checkpoint and re-applying the update gives recommendations bit-identical
to a fault-free run that took the same restore path, and the restored
index passes ``check_consistent`` where the torn one fails it.  The
approx engines' user index runs its CPU default, the staged pipeline.
A degradation-ladder transition of a live server sets and clears the
index's ``query_mode_override`` under concurrent updates, race-clean
under the reference's ``RaceTracer``.
"""

import dataclasses
import time

import numpy as np
import pytest

from _torch_parity import int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.analysis.races import RaceTracer
from repro_torch import obs
from repro_torch.core.facade import CFEngine
from repro_torch.distributed import checkpoint
from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                     InjectedFault)
from repro_torch.index import IndexConfig
from repro_torch.serving.engine import (DEGRADED, HEALTHY, BatchingServer,
                                        DegradationLadder)


def _engine(seed=0, u=64, d=32, **kw):
    r = int_ratings(np.random.default_rng(seed), u, d, density=0.5)
    return CFEngine(r, measure="cosine", k=5, block_size=16, device="cpu",
                    **kw).fit()


def _approx_engine(seed=0, **kw):
    return _engine(seed, neighbor_mode="approx", recommend_mode="approx",
                   index_cfg=IndexConfig(n_clusters=8, seed=0,
                                         features="raw"), **kw)


def _updates(rng, n, u=64, d=32):
    return [([int(rng.integers(0, u))], [int(rng.integers(0, d))],
             [float(rng.integers(1, 6))]) for _ in range(n)]


def _recs(eng, users=(0, 3, 7, 11)):
    scores, items = eng.recommend(np.asarray(users, np.int32), n=5)
    return scores.numpy(), items.numpy()


def test_state_checkpoint_round_trip_is_bit_identical(tmp_path):
    eng = _approx_engine()
    assert eng.index._query_mode() == "staged"
    for uu, ii, vv in _updates(np.random.default_rng(1), 4):
        eng.update_ratings(uu, ii, vv)
    ref_s, ref_i = _recs(eng)
    checkpoint.save(tmp_path, 1, eng.state())
    # trample the model, then restore: recommendations must match bitwise
    eng.update_ratings([0, 1], [0, 1], [1.0, 1.0])
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    got_s, got_i = _recs(eng)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_s, ref_s)


def test_exact_engine_state_round_trip(tmp_path):
    eng = _engine()
    ref_s, ref_i = _recs(eng)
    checkpoint.save(tmp_path, 3, eng.state())
    eng.update_ratings([2], [2], [5.0])
    eng.load_state(checkpoint.restore(tmp_path, 3, eng.state_template()))
    got_s, got_i = _recs(eng)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_s, ref_s)
    assert eng.ratings_version == int(np.asarray(
        eng.state()["meta"]).reshape(-1)[0])


def test_fault_during_update_recovers_bit_identical(tmp_path):
    """Checkpoint, inject a fault inside update_ratings, restore,
    re-apply: the result matches a fault-free run that took the same
    restore path."""
    eng = _approx_engine()
    u1, u2 = _updates(np.random.default_rng(2), 2)
    eng.update_ratings(*u1)
    checkpoint.save(tmp_path, 1, eng.state())
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    eng.update_ratings(*u2)
    ref_s, ref_i = _recs(eng)
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    snap = eng.snapshot()
    eng.fault_injector = FaultInjector(fail_at_steps=(eng._update_seq + 1,))
    with pytest.raises(InjectedFault):
        eng.update_ratings(*u2)
    assert eng.snapshot() is snap          # the torn state is not published
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    eng.update_ratings(*u2)                # the injector is one-shot
    eng.fault_injector = None
    got_s, got_i = _recs(eng)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_s, ref_s)


def test_fault_mid_refold_restores_consistent_index(tmp_path):
    """A fault between the index ledger's subtraction and re-add leaves
    the cluster mass torn: check_consistent fails until the restore, and
    the re-applied update recommends bit for bit the fault-free run."""
    eng = _approx_engine()
    u1, u2 = _updates(np.random.default_rng(3), 2)
    eng.update_ratings(*u1)
    checkpoint.save(tmp_path, 1, eng.state())
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    eng.update_ratings(*u2)
    ref_s, ref_i = _recs(eng)
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    eng.index.fault_injector = FaultInjector(
        fail_at_steps=(eng.index._refold_seq + 1,))
    with pytest.raises(InjectedFault):
        eng.update_ratings(*u2)
    eng.index.fault_injector = None
    with pytest.raises(RuntimeError, match="mass"):
        eng.index.check_consistent(eng.ratings, eng.means)
    eng.load_state(checkpoint.restore(tmp_path, 1, eng.state_template()))
    assert eng.index.check_consistent(eng.ratings, eng.means)
    eng.update_ratings(*u2)
    got_s, got_i = _recs(eng)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_s, ref_s)


def test_engine_update_failure_counter_increments():
    eng = _engine()
    eng.fault_injector = FaultInjector(fail_at_steps=(1,))
    before = int(obs.registry().snapshot()["counters"]
                 .get("engine.update.failures", 0))
    with pytest.raises(InjectedFault):
        eng.update_ratings([0], [0], [5.0])
    after = int(obs.registry().snapshot()["counters"]
                ["engine.update.failures"])
    assert after == before + 1
    eng.update_ratings([0], [0], [5.0])      # one-shot: the retry lands


def test_per_call_quality_knobs():
    eng = _approx_engine()
    users = np.arange(8, dtype=np.int32)
    s_full, i_full = eng.recommend(users, n=5)
    s_cheap, i_cheap = eng.recommend(users, n=5, n_probe=1, shortlist=8)
    assert i_cheap.shape == i_full.shape
    # exact mode can't honor candidate budgets — loud, not silent
    with pytest.raises(ValueError, match="approx"):
        _engine().recommend(users, n=5, shortlist=8)


def test_query_mode_override_survives_updates():
    eng = _approx_engine()
    eng.index.query_mode_override = "staged"
    eng.update_ratings([1], [2], [4.0])
    assert eng.index.query_mode_override == "staged"
    assert eng.index._query_mode() == "staged"
    assert eng.index.last_query.query_mode == "staged"
    eng.index.query_mode_override = "bogus"
    with pytest.raises(ValueError, match="bogus"):
        eng.index._query_mode()


@dataclasses.dataclass
class _ScriptedLadder(DegradationLadder):
    """A ladder whose evaluations follow a script: DEGRADED at the first
    window, HEALTHY at the second, then holding."""
    script: list = dataclasses.field(
        default_factory=lambda: [DEGRADED, HEALTHY])
    seen: list = dataclasses.field(default_factory=list)
    engine: object = None

    def next_level(self, level, **kw):
        # the override as the previous transition left it
        self.seen.append(self.engine.index.query_mode_override)
        if self.script:
            return self.script.pop(0), "scripted"
        return level, ""


def test_ladder_transition_switches_staged_race_clean():
    """A live server's DEGRADED transition sets the fused-config index's
    ``query_mode_override`` to "staged" and recovery clears it, while the
    caller applies rating updates (which re-query the index) on its own
    thread — race-clean under ``RaceTracer``."""
    eng = _engine(neighbor_mode="approx", recommend_mode="approx",
                  index_cfg=IndexConfig(n_clusters=8, seed=0,
                                        features="raw", query_mode="fused"))
    ladder = _ScriptedLadder(window=1, engine=eng)
    server = BatchingServer(eng, max_batch=4, max_wait_ms=2.0, topn=3,
                            ladder=ladder, device="cpu")
    rng = np.random.default_rng(4)
    tracer = RaceTracer()
    with tracer.trace(eng, "engine"), tracer.trace(server, "server"), \
            tracer.trace(eng.index, "index"):
        server.start()
        for wave in range(4):
            futs = [server.submit(int(u)) for u in rng.integers(0, 64, 4)]
            eng.update_ratings([int(rng.integers(0, 64))],
                               [int(rng.integers(0, 32))], [4.0])
            assert all(f.result(timeout=30).items.shape == (3,)
                       for f in futs)
            deadline = time.monotonic() + 10
            while len(ladder.seen) <= wave and time.monotonic() < deadline:
                time.sleep(0.005)
        server.stop()
    tracer.assert_clean()
    assert ladder.seen[:3] == [None, "staged", None], ladder.seen
    assert server.stats()["health"] == "HEALTHY"
    assert eng.index._query_mode() == "fused"
