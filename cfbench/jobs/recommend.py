"""The recommend job: the bulk top-n pass over every user of a restored
model.

Set-up makes the ratings and a neighbor cache from the seed, computes the
users' rating counts, sums and means, and restores them into a
``CFEngine`` through ``load_state`` (the path a deployment takes to serve a
fitted model); then one warm-up pass.  Each step is ``recommend(n=n)``
over all users: the facade, ``_recommend_block``, kernel 2 and the top-n
select.  The fit layer is bypassed.

The check draws users from the seed (uniformly, with the users of the
most and the fewest ratings) and holds the first and the last timed
pass's rows for them against the plain reference, which recomputes the
means from the ratings and predicts from the same cache.
"""

from __future__ import annotations

import time

import torch

from cfbench import counts, gen
from cfbench.reference import compare, recommend


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        eng = cfg["engine"]
        self.engine_kw = {key: eng[key] for key in ("measure", "k", "backend")}
        self.n = eng["n"]
        self.steps = 0
        self.passes = []        # outputs of the first and the last pass

    def prepare(self) -> None:
        """The deployment's data and neighbor cache, without the program."""
        self.data = gen.generate(self.cfg, self.seed, self.device)
        self.scores, self.ids = gen.neighbor_cache(
            self.data, self.seed, self.engine_kw["k"])

    def setup(self) -> None:
        from repro_torch.core.facade import CFEngine
        self.marks = {"port imported": time.perf_counter()}
        self.prepare()
        self.marks["data made"] = time.perf_counter()
        r = self.data.matrix
        cnt = torch.cat([(r[lo:lo + 65536] > 0).sum(1, dtype=torch.int32)
                         for lo in range(0, r.shape[0], 65536)])
        tot = r.sum(1)
        means = torch.where(cnt > 0, tot / cnt.clamp_min(1),
                            tot.sum() / cnt.sum().clamp_min(1))
        self.terms = counts.rated_terms(cnt, self.ids, self.scores)
        self.engine = CFEngine(r, device=self.device, **self.engine_kw)
        self.engine.load_state({"ratings": r, "scores": self.scores,
                                "idx": self.ids, "means": means, "cnt": cnt,
                                "tot": tot, "version": 0})
        self.marks["model restored"] = time.perf_counter()
        for _ in range(self.traffic["warmup_steps"]):
            self.engine.recommend(n=self.n)

    @property
    def units(self) -> int:
        """Users given their top-n a step."""
        return self.data.matrix.shape[0]

    def work(self) -> dict:
        u, i = self.data.matrix.shape
        return {"pass": counts.recommend_work(u, i, self.engine_kw["k"],
                                              self.n, self.terms)}

    def step(self) -> None:
        out = self.engine.recommend(n=self.n)
        if self.steps == 0:
            self.passes.append(out)
        self.last = out
        self.steps += 1

    def release(self) -> None:
        """Drop the program's engine (its int8 copy of the ratings)."""
        self.engine = None

    def _users(self) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.seed % (1 << 62) + 2)
        n_u = self.data.matrix.shape[0]
        cnt = self.data.counts.cpu()
        extremes = torch.stack([cnt.argmax(), cnt.argmin()])
        pick = torch.randperm(n_u, generator=g)[
            :self.traffic["check"]["users"]]
        return torch.unique(torch.cat([pick, extremes])).to(
            self.data.matrix.device)

    def _reference(self, users, dtype=torch.float32):
        r = self.data.matrix
        means = torch.cat([recommend.user_means(r[lo:lo + 65536])
                           for lo in range(0, r.shape[0], 65536)])
        return recommend.recommend_rows(r, means, self.scores, self.ids,
                                        users, self.n, dtype)

    def check(self) -> dict:
        """Each number compared: (value, limit)."""
        users = self._users()
        ref_s, ref_i = self._reference(users)
        widest, wrong, failed = 0.0, 0, 0
        for got_s, got_i in self.passes + [self.last]:
            gap, bad = compare.gaps(got_s[users], got_i[users], ref_s, ref_i)
            widest, wrong = max(widest, gap), wrong + bad
            failed += int(gap > 0 or bad > 0)
        self.failed = failed
        return {"score_gap": (widest, 0.0), "id_mismatches": (wrong, 0)}

    def control(self) -> dict:
        """The check's numbers with the reference in bf16 in the program's
        place, after :meth:`prepare`."""
        users = self._users()
        ref_s, ref_i = self._reference(users)
        low_s, low_i = self._reference(users, torch.bfloat16)
        gap, bad = compare.gaps(low_s, low_i, ref_s, ref_i)
        return {"score_gap": (gap, 0.0), "id_mismatches": (bad, 0)}
