"""The half-star recommend job: ``jobs/recommend.py``'s bulk top-n pass
over every user of a restored model, on a deployment rated on a half-star
grid (``cfbench/gen_halfstar.py``).

Half stars are not int8-exact, so the program's gather source stays the
f32 matrix: kernel 2's ``"f32"`` route, and at MovieLens-25M's 59,047
items kernel 5's select on rows too long to stage.  Set-up, the step and
the check are the recommend job's, with the users' rating counts (set-up)
and the reference's means (the check) taken in blocks of ``ROWS`` users:
a block's int32 counts and f64 sums stay small beside a 35.75 GiB matrix,
so that the run's memory peak is the program's.  ``work()`` adds the top-n
select's count (``cfbench/counts_topn.py``) beside the pass's.
"""

from __future__ import annotations

import time

import torch

from cfbench import counts, counts_topn, gen, gen_halfstar
from cfbench.jobs import recommend
from cfbench.reference import recommend as reference

ROWS = 4096


class Job(recommend.Job):
    def prepare(self) -> None:
        """The half-star deployment and its neighbor cache."""
        self.data = gen_halfstar.generate(self.cfg, self.seed, self.device)
        self.scores, self.ids = gen.neighbor_cache(
            self.data, self.seed, self.engine_kw["k"])

    def setup(self) -> None:
        from repro_torch.core.facade import CFEngine
        self.marks = {"port imported": time.perf_counter()}
        self.prepare()
        self.marks["data made"] = time.perf_counter()
        r = self.data.matrix
        cnt = torch.cat([(r[lo:lo + ROWS] > 0).sum(1, dtype=torch.int32)
                         for lo in range(0, r.shape[0], ROWS)])
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

    def work(self) -> dict:
        out = super().work()
        u, i = self.data.matrix.shape
        out["topn"] = counts_topn.topn_work(u, i, self.n)
        return out

    def _reference(self, users, dtype=torch.float32):
        r = self.data.matrix
        means = torch.cat([reference.user_means(r[lo:lo + ROWS])
                           for lo in range(0, r.shape[0], ROWS)])
        return reference.recommend_rows(r, means, self.scores, self.ids,
                                        users, self.n, dtype)
