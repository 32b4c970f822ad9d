"""Half-star ratings on the port's exact recommend path.

* ``core/predict.py::make_gather_operand`` checks in row blocks and
  reads its verdict and bound in one host read: the verdict equals the
  whole-matrix expression on integer, half star, negative, past-127, NaN
  and meta matrices at block sizes that split the rows unevenly, the
  bound is the largest rating, and the int8 copy is the same bits.  A
  kernel fit builds the operand once and an update patches it once, to a
  cold rebuild's bound.
* ``obs``: span ``gather_source.check`` inside ``gather_source.build``,
  counters ``gather_source.check.blocks``, ``gather_source.int8`` /
  ``.f32`` and ``recommend.topn.unstaged``.
* A half-star deployment's exact recommend on the ``kernel`` and
  ``sequential`` backends against ``cfbench/reference/recommend.py``, bit
  for bit.

The ``cuda`` fixture's cases launch the kernels and skip, with a reason,
without a CUDA card: kernel 5 at 1,024 × 59,047 (m 10, 5.0 ties), kernel
2's ``"f32"`` route at 59,047 items, the staging limit at 32,768 and
32,769 scores, and the engine at MovieLens-25M's width.  On the card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_halfstar.py``.
"""

import math
from pathlib import Path

import pytest
import torch

from cfbench import gen_halfstar
from cfbench.reference import compare, recommend as reference
from repro_torch import obs
from repro_torch.core import facade
from repro_torch.core import predict as pr
from repro_torch.core.facade import CFEngine
from repro_torch.kernels import select as sel
from repro_torch.kernels.predict import fused_tile_predict, tile_predict_plain

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def whole_matrix_exact(r):
    """The check as one expression over the whole matrix."""
    return bool(((r >= 0) & (r <= 127) & (r == torch.round(r))).all())


def matrix(kind, users=37, items=11, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = torch.randint(0, 6, (users, items), generator=g).float()
    bad = (int(torch.randint(0, users, (1,), generator=g)),
           int(torch.randint(0, items, (1,), generator=g)))
    if kind == "half_star":
        r = torch.randint(0, 11, (users, items), generator=g).float() / 2
    elif kind == "one_half":
        r[bad] = 2.5
    elif kind == "negative":
        r[bad] = -1.0
    elif kind == "past_127":
        r[bad] = 128.0
    elif kind == "at_127":
        r[bad] = 127.0
    elif kind == "nan":
        r[bad] = math.nan
    elif kind == "inf":
        r[bad] = math.inf
    elif kind == "negative_zero":
        r[bad] = -0.0
    elif kind == "last_row_bad":
        r[-1, -1] = 0.5
    return r


KINDS = ["integer", "half_star", "one_half", "negative", "past_127",
         "at_127", "nan", "inf", "negative_zero", "last_row_bad"]
# cells a block: 1 (one row a block), a row and a bit, 5 and 3 rows
# (37 rows split unevenly), more than the matrix
BLOCKS = [1, 12, 55, 33, 1 << 28]


@pytest.mark.parametrize("block_cells", BLOCKS)
@pytest.mark.parametrize("kind", KINDS)
def test_blocked_check_equals_whole_matrix_expression(monkeypatch, kind,
                                                      block_cells):
    monkeypatch.setattr(pr, "CHECK_BLOCK_CELLS", block_cells)
    r = matrix(kind, seed=len(kind))
    op = pr.make_gather_operand(r)
    exact = whole_matrix_exact(r)
    assert (op.src.dtype == torch.int8) == exact
    assert op.max_value == (int(r.max()) if exact else None)


# the Tensor methods that read a value to the host
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
              "__float__", "__index__")


def count_host_reads(monkeypatch):
    """The names of the host reads made from here on, in order."""
    reads = []
    for name in HOST_READS:
        def spy(self, *args, _real=getattr(torch.Tensor, name), _name=name,
                **kwargs):
            reads.append(_name)
            return _real(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, spy)
    return reads


@pytest.mark.parametrize("block_cells,blocks", [
    (1, 37), (12, 37), (55, 8), (33, 13), (1 << 28, 1)])
def test_blocked_check_counts_its_blocks(monkeypatch, block_cells, blocks):
    """Whatever its block count, the build reads the device once."""
    monkeypatch.setattr(pr, "CHECK_BLOCK_CELLS", block_cells)
    r = matrix("integer")                       # 37 × 11
    c = obs.counter("gather_source.check.blocks")
    before = c.value
    reads = count_host_reads(monkeypatch)
    op = pr.make_gather_operand(r)
    assert len(reads) == 1, reads
    monkeypatch.undo()
    assert c.value - before == blocks == math.ceil(
        37 / max(1, block_cells // 11))
    assert op.src.dtype == torch.int8 and op.max_value == 5


def test_meta_and_empty_matrices_count_as_exact(monkeypatch):
    meta = pr.make_gather_operand(torch.empty((10, 4), device="meta"))
    assert meta.src.is_meta and meta.src.dtype == torch.int8
    assert meta.max_value is None               # no data to bound
    monkeypatch.setattr(pr, "CHECK_BLOCK_CELLS", 1)
    empty = pr.make_gather_operand(torch.empty((0, 4)))
    assert empty.src.dtype == torch.int8 and empty.max_value == 0
    assert whole_matrix_exact(torch.empty((0, 4)))


@pytest.mark.parametrize("block_cells", BLOCKS)
def test_int8_copy_is_the_same_bits(monkeypatch, block_cells):
    monkeypatch.setattr(pr, "CHECK_BLOCK_CELLS", block_cells)
    r = matrix("integer", users=41, items=13, seed=3)
    src = pr.make_gather_source(r)
    assert src.dtype == torch.int8 and torch.equal(src, r.to(torch.int8))
    r2 = r.clone()
    r2[5, 2] = 4.0
    touched = torch.tensor([5, 41])              # padded with U
    patched = pr.patch_gather_source(src, r2, touched)
    assert torch.equal(patched, r2.to(torch.int8))
    r3 = r2.clone()
    r3[6, 1] = 1.5
    rebuilt = pr.patch_gather_source(patched, r3, torch.tensor([6]))
    assert rebuilt is r3


def _counts():
    return {name: obs.counter(name).value for name in (
        "gather_source.int8", "gather_source.f32",
        "gather_source.check.blocks")}


@pytest.mark.parametrize("kind,source", [("integer", "gather_source.int8"),
                                         ("half_star", "gather_source.f32")])
def test_build_counts_its_source_and_nests_the_check(kind, source):
    r = matrix(kind, users=20, items=9)
    before = _counts()
    obs.clear()
    src = pr.make_gather_source(r)
    after = _counts()
    assert src.dtype == (torch.int8 if kind == "integer" else torch.float32)
    assert {k: after[k] - before[k] for k in after} == {
        "gather_source.int8": int(source == "gather_source.int8"),
        "gather_source.f32": int(source == "gather_source.f32"),
        "gather_source.check.blocks": 1}
    spans = {s.name: s for s in obs.get_spans()}
    assert spans["gather_source.check"].parent_id == \
        spans["gather_source.build"].span_id


def test_kernel_fit_builds_the_operand_once_and_an_update_patches_it(
        monkeypatch):
    """A kernel-backend fit builds the gather operand once and scores with
    its bound; an update that lowers the largest rating (the one 5 becomes
    a 3) patches it once, to a cold rebuild's bound, and the refit scores
    with that bound without building another."""
    g = torch.Generator().manual_seed(7)
    r = torch.randint(0, 5, (48, 20), generator=g).float()      # 0..4
    r[9, 3] = 5.0
    seen, patches = [], []
    real_sim = facade.ksim.fused_similarity
    real_patch = pr.patch_gather_operand

    def sim_spy(ra, rb, **kw):
        seen.append(kw.get("max_value"))
        return real_sim(ra, rb, **kw)

    def patch_spy(*args):
        patches.append(args)
        return real_patch(*args)

    monkeypatch.setattr(facade.ksim, "fused_similarity", sim_spy)
    monkeypatch.setattr(pr, "patch_gather_operand", patch_spy)
    builds = obs.counter("gather_source.int8")
    before = builds.value
    eng = CFEngine(r, k=5, block_size=16, backend="kernel",
                   device="cpu").fit()
    assert builds.value - before == 1
    assert seen and set(seen) == {5}
    seen.clear()
    eng.update_ratings([9], [3], [3.0], oracle_check=True)
    assert builds.value - before == 1 and len(patches) == 1
    key, op = eng._gather_cache.entry
    cold = pr.make_gather_operand(eng.ratings)
    assert key is eng.ratings and op.max_value == cold.max_value == 4
    assert torch.equal(op.src, cold.src)
    assert seen and set(seen) == {4}


# -- kernel 5's staging limit --------------------------------------------

@pytest.mark.parametrize("width,n,unstaged", [
    (17770, 10, 0), (sel.ROW_STAGE_MAX, 10, 0), (sel.ROW_STAGE_MAX + 1, 10, 1),
    (59047, 10, 1)])
def test_topn_counts_unstaged_rows(width, n, unstaged):
    pred = torch.ones((2, width))
    seen = torch.zeros((2, width), dtype=torch.bool)
    c = obs.counter("recommend.topn.unstaged")
    before = c.value
    pr.topn_unseen(pred, seen, n)
    assert c.value - before == unstaged
    pr.topn_unseen(pred, seen, n, use_kernel=False)      # the sort
    assert c.value - before == unstaged


# -- the exact recommend on half stars -----------------------------------

def half_star_data(users, items, seed, device="cpu"):
    per_user = items // 5
    cfg = {"n_users": users, "n_items": items,
           "n_ratings": users * per_user, "min_user_ratings": 20,
           "rating_min": 0.5, "rating_max": 5.0, "rating_step": 0.5,
           "assumed": {"latent_dim": 8, "global_mean": 3.53,
                       "user_bias_std": 0.3, "item_bias_std": 0.3,
                       "noise_std": 0.55, "affinity_scale": 2.6,
                       "popularity_alpha": 1.1, "activity_sigma": 0.9}}
    return gen_halfstar.generate(cfg, seed, device).matrix


def assert_reference_recommend(eng, r, n=10):
    """The engine's recommend of every user equals the plain reference's
    (computed on ``r``'s device), bit for bit."""
    got_s, got_i = eng.recommend(n=n)
    means = reference.user_means(r)
    assert torch.equal(means, eng.means)
    users = torch.arange(r.shape[0], device=r.device)
    ref_s, ref_i = reference.recommend_rows(r, means, eng.scores, eng.idx,
                                            users, n)
    assert compare.gaps(got_s, got_i, ref_s, ref_i) == (0.0, 0)
    return got_s, got_i


@pytest.mark.parametrize("backend", ["kernel", "sequential"])
def test_half_star_recommend_equals_reference(backend):
    r = half_star_data(300, 400, seed=2 ** 31 + 9)
    assert set(torch.unique(r).tolist()) == {0.5 * j for j in range(11)}
    eng = CFEngine(r, measure="pcc", k=40, backend=backend,
                   device="cpu").fit()
    assert eng._gather_source(eng.ratings).dtype == torch.float32
    got_s, got_i = assert_reference_recommend(eng, r)
    ids = got_i[got_i >= 0].long()
    rows = torch.nonzero(got_i >= 0)[:, 0]
    assert not (r[rows, ids] > 0).any()          # never a rated item


# -- on the card -----------------------------------------------------------

def _ties_at_5(q, width, seed, device):
    """(q, width) predictions in [1, 5] on the 0.25 grid, ~1 in 9 exactly
    5.0 so that ties cross a top-10 cut; a sparse seen mask."""
    g = torch.Generator().manual_seed(seed)
    raw = 1.0 + 4.5 * torch.rand((q, width), generator=g)
    pred = (torch.round(raw * 4.0) / 4.0).clamp(1.0, 5.0)
    seen = torch.rand((q, width), generator=g) < 0.01
    return pred.to(device), seen.to(device)


def test_select_at_ml25m_width_on_card(cuda):
    pred, seen = _ties_at_5(1024, 59047, seed=40, device=cuda)
    c = obs.counter("recommend.topn.unstaged")
    before = c.value
    got_s, got_i = pr.topn_unseen(pred, seen, 10)
    torch.cuda.synchronize()
    assert c.value - before == 1
    want_s, want_i = pr.topn_unseen(pred.cpu(), seen.cpu(), 10,
                                    use_kernel=False)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_s.cpu().view(torch.int32),
                       want_s.view(torch.int32))
    assert (want_s == 5.0).all()                  # the cut lies in the ties


# (row length, m): either side of ROW_STAGE_MAX at n = 10, the shared
# memory's limit on m at ROW_STAGE_MAX, and ml25m's row
STAGING = [(32768, 10), (32769, 10), (32768, 8192), (32768, 8193),
           (59047, 10)]
# the launches whose branch the row length alone decides
ROUTES = [(n, m) for n, m in STAGING if m == 10]


@pytest.mark.parametrize("n,m", STAGING)
def test_select_either_side_of_the_staging_limit_on_card(cuda, n, m):
    scores, _ = _ties_at_5(64, n, seed=n + m, device=cuda)
    q_ids = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    got = sel.select_topm(scores, q_ids, m=m)
    want = sel.select_topm_twin(scores.cpu(), q_ids.cpu(), m=m)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


# one profiler session in a process of its own (a test process may hold
# an earlier session, after which CUPTI's kernel records can be missing):
# the kernel's template branch of each ROUTES launch, in order
_ROUTES = """
import json, sys, torch
from repro_torch.kernels.select import select_topm
shapes = json.loads(sys.argv[1])
ids = torch.full((8,), -1, dtype=torch.int32, device="cuda")
rows = [torch.rand((8, n), device="cuda") for n, _ in shapes]
select_topm(rows[0], ids, m=1)
torch.cuda.synchronize()
act = torch.profiler.ProfilerActivity
with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
    for x, (_, m) in zip(rows, shapes):
        select_topm(x, ids, m=m)
        torch.cuda.synchronize()
names = sorted((e.time_range.start, e.name) for e in prof.events()
               if "radix_topm_kernel" in e.name)
print(json.dumps([name for _, name in names]))
"""


def test_staging_limit_is_the_kernels_branch_on_card(cuda):
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(pr.__file__).resolve().parents[2])]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    out = subprocess.run([sys.executable, "-c", _ROUTES,
                          json.dumps(ROUTES)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    want = ["radix_topm_kernel<%s>" % str(n <= sel.ROW_STAGE_MAX).lower()
            for n, _ in ROUTES]
    assert len(names) == len(want), names
    assert all(w in got for w, got in zip(want, names)), names


def test_f32_predict_route_at_ml25m_width_on_card(cuda):
    r = half_star_data(4096, 59047, seed=11, device=cuda)
    g = torch.Generator().manual_seed(12)
    m, k = 256, 40
    ids = torch.randint(0, r.shape[0], (m, k), generator=g,
                        dtype=torch.int32)
    w = torch.rand((m, k), generator=g)
    w[:, -3:] = 0.0                              # dead slots
    nb_means = 1.0 + 4.0 * torch.rand((m, k), generator=g)
    q_means = 1.0 + 4.0 * torch.rand((m,), generator=g)
    args = [t.to(cuda) for t in (ids, w, nb_means, q_means)]
    routes = dict(fused_tile_predict.routes)
    got = fused_tile_predict(r, *args, 0, r.shape[1])
    torch.cuda.synchronize()
    assert fused_tile_predict.routes["f32"] == routes["f32"] + 1
    for lo in range(0, r.shape[1], 8192):
        hi = min(r.shape[1], lo + 8192)
        want = tile_predict_plain(r, *args, lo, hi)
        assert torch.equal(got[:, lo:hi].view(torch.int32),
                           want.view(torch.int32)), (lo, hi)


def test_half_star_engine_at_ml25m_width_on_card(cuda):
    r = half_star_data(2048, 59047, seed=13, device=cuda)
    eng = CFEngine(r, measure="pcc", k=40, backend="kernel",
                   device=cuda).fit()
    c = obs.counter("recommend.topn.unstaged")
    before = c.value
    assert_reference_recommend(eng, r)
    assert c.value - before == 2                 # 2 blocks of 1,024 users
