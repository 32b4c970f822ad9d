"""The check fails a broken program: for each cell's job, a run on the CPU
(past the harness's look for a card) with the timed path broken
underneath reads ``correct`` false, and so does the control, the
reference in bf16 in the program's place.  A sound run reads true.

Faults: a step that returns its state unchanged (a refit that hands back
an earlier fit's neighbors), half of the batch left out (half the users'
rows never computed), and an answer altered where it is produced.  A
recommend pass changes no state, so it has no stale-state fault; no cell
runs on more than one chip, so none has an exchange to leave out."""

import pytest
import torch

from cfbench.tests import tiny
from repro_torch.core.facade import CFEngine

NEG = torch.finfo(torch.float32).min


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny.tiny_tree(tmp_path_factory.mktemp("faults"))


def _stale(monkeypatch):
    orig = CFEngine.fit
    first = []

    def fit(self):
        orig(self)
        if first:
            self.scores, self.idx = first[0]
        else:
            first.append((self.scores, self.idx))
        return self
    monkeypatch.setattr(CFEngine, "fit", fit)


def _half_fit(monkeypatch):
    orig = CFEngine.fit

    def fit(self):
        orig(self)
        half = self.n_users // 2
        self.scores = self.scores.clone()
        self.idx = self.idx.clone()
        self.scores[half:] = NEG
        self.idx[half:] = -1
        return self
    monkeypatch.setattr(CFEngine, "fit", fit)


def _altered_fit(monkeypatch):
    orig = CFEngine.fit

    def fit(self):
        orig(self)
        self.scores = self.scores.clone()
        self.scores[:, 0] = torch.nextafter(self.scores[:, 0],
                                            torch.tensor(2.0))
        return self
    monkeypatch.setattr(CFEngine, "fit", fit)


def _half_pass(monkeypatch):
    orig = CFEngine.recommend

    def recommend(self, *args, **kw):
        s, i = orig(self, *args, **kw)
        half = s.shape[0] // 2
        return (torch.cat([s[:half], torch.full_like(s[half:], -torch.inf)]),
                torch.cat([i[:half], torch.full_like(i[half:], -1)]))
    monkeypatch.setattr(CFEngine, "recommend", recommend)


def _altered_pass(monkeypatch):
    orig = CFEngine.recommend

    def recommend(self, *args, **kw):
        s, i = orig(self, *args, **kw)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % self.n_items
        return s, i
    monkeypatch.setattr(CFEngine, "recommend", recommend)


FAULTS = [("ml1m.refit", _stale), ("ml1m.refit", _half_fit),
          ("ml1m.refit", _altered_fit), ("netflix.refit", _stale),
          ("netflix.recommend", _half_pass),
          ("netflix.recommend", _altered_pass)]


@pytest.mark.parametrize("cell", ["ml1m.refit", "netflix.refit",
                                  "netflix.recommend"])
def test_sound_run_is_correct(here, cell):
    out = tiny.run(here, cell)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_reads_incorrect(here, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = tiny.run(here, cell)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("cell", ["ml1m.refit", "netflix.recommend"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 1, 4_000_000_007])
def test_control_reads_incorrect(here, cell, seed):
    job = tiny.job(here, cell, seed)
    job.prepare()
    readings = job.control()
    assert any(value > limit for value, limit in readings.values())
