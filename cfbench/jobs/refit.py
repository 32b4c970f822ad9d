"""The refit job: back-to-back exact fits over a matrix that a stream of
new ratings keeps changing.

Each step writes the stream's next batch of ratings into the device
matrix, builds a ``CFEngine`` over it and calls ``fit()``: the facade, the
engine's user statistics and streaming top-k, kernel 1 and the top-k
merge.  No fit can reuse another's result, since every step sees a matrix
the one before did not.

The check samples timed fits from the seed (the first, the last, and one
of those in between that were kept, at indices 0, 1, 2, 4, 8, ...), and in
each the users whose ratings that step's batch touched plus users drawn
uniformly.  The matrix each fit saw is rebuilt by undoing the later
batches from the values each write replaced; the plain reference
recomputes those users' top-k there and the fit's rows must equal it bit
for bit.
"""

from __future__ import annotations

import time

import torch

from cfbench import counts, gen
from cfbench.reference import compare, topk


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.engine_kw = {key: cfg["engine"][key]
                          for key in ("measure", "k", "backend")}
        self.steps = 0          # timed steps
        self.kept = {}          # timed step → (scores, ids) of its fit
        self.writes = []        # timed step → (cells, values replaced)

    def prepare(self) -> None:
        """The deployment's data and its rating stream, without the
        program."""
        self.data = gen.generate(self.cfg, self.seed, self.device)
        self.flat = self.data.matrix.view(-1)
        self.stream = gen.UpdateStream(self.data, self.seed,
                                       self.traffic["new_ratings"])

    def setup(self) -> None:
        from repro_torch.core.facade import CFEngine
        self._engine = CFEngine
        self.marks = {"port imported": time.perf_counter()}
        self.prepare()
        self.marks["data made"] = time.perf_counter()
        for _ in range(self.traffic["warmup_steps"]):
            self._write()
            self._fit()

    def work(self) -> dict:
        u, i = self.data.matrix.shape
        return {"fit": counts.fit_work(u, i, self.engine_kw["k"])}

    def _write(self):
        cells, vals = self.stream.next()
        old = self.flat[cells]
        self.flat[cells] = vals
        return cells, old

    def _fit(self):
        eng = self._engine(self.data.matrix, device=self.device,
                           **self.engine_kw).fit()
        return eng.scores, eng.idx

    def step(self) -> None:
        self.writes.append(self._write())
        out = self._fit()
        j = self.steps
        self.steps += 1
        if j & (j - 1) == 0:
            self.kept[j] = out
        self.last = out

    def release(self) -> None:
        """Drop everything of the program but the fits' outputs."""
        self._engine = None

    def _sample(self):
        """The checked fits and, for each, its users: a generator on the
        CPU seeded from the run's seed."""
        g = torch.Generator().manual_seed(self.seed % (1 << 62) + 1)
        chk = self.traffic["check"]
        last = self.steps - 1
        middle = [j for j in self.kept if 0 < j < last]
        fits = {0, last}
        if middle:
            fits.add(middle[int(torch.randint(len(middle), (1,),
                                              generator=g))])
        n_u, n_i = self.data.matrix.shape
        plan = {}
        for j in sorted(fits):
            touched = torch.unique(self.writes[j][0].cpu() // n_i)
            pick = touched[torch.randperm(len(touched), generator=g)
                           [:chk["touched_users"]]]
            rand = torch.randperm(n_u, generator=g)[:chk["random_users"]]
            plan[j] = torch.unique(torch.cat([pick, rand]))
        return plan

    def check(self) -> dict:
        """Each number compared: (value, limit)."""
        k = self.engine_kw["k"]
        plan = self._sample()
        kept = dict(self.kept)
        kept[self.steps - 1] = self.last
        widest, wrong, failed = 0.0, 0, 0
        for j in range(self.steps - 1, min(plan) - 1, -1):
            if j in plan:
                users = plan[j]
                ref_s, ref_i = topk.topk_rows(self.data.matrix, users, k)
                rows = users.to(self.data.matrix.device)
                got_s, got_i = (t[rows] for t in kept[j])
                gap, bad = compare.gaps(got_s, got_i, ref_s, ref_i)
                widest, wrong = max(widest, gap), wrong + bad
                failed += int(gap > 0 or bad > 0)
            cells, old = self.writes[j]
            self.flat[cells] = old          # the matrix the fit before saw
        self.failed = failed
        return {"score_gap": (widest, 0.0), "id_mismatches": (wrong, 0)}

    def control(self) -> dict:
        """The check's numbers with the reference in bf16 in the program's
        place, after :meth:`prepare` and one batch of the stream, for users
        drawn as the check draws them."""
        k = self.engine_kw["k"]
        self.writes = [self._write()]
        self.steps = 1
        users = self._sample()[0]
        ref_s, ref_i = topk.topk_rows(self.data.matrix, users, k)
        low_s, low_i = topk.topk_rows(self.data.matrix, users, k,
                                      dtype=torch.bfloat16)
        gap, bad = compare.gaps(low_s, low_i, ref_s, ref_i)
        return {"score_gap": (gap, 0.0), "id_mismatches": (bad, 0)}
