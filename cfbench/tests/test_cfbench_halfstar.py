"""The half-star deployment (``ml25m``) on the CPU: the generator's grid,
marginals and seeding, its scaled draw against a direct half-star
rounding, the ``recommend_halfstar`` job's check and control, and the
top-n select's count and roofline reader on a synthetic trace."""

import json
from types import SimpleNamespace

import pytest
import torch

from cfbench.tests import tiny
from cfbench import counts, counts_topn, gen, gen_halfstar, trace
from repro_torch.core.facade import CFEngine

CONFIG = tiny.ROOT / "cfbench" / "configs" / "halfstar" / "ml25m.json"
CELL = "ml25m.recommend"
GRID = {0.5 * j for j in range(1, 11)}


def small(users=400, items=600):
    """ml25m at ``users`` × ``items``, its ratings a user kept."""
    cfg = json.loads(CONFIG.read_text())
    per_user = min(cfg["n_ratings"] / cfg["n_users"], items / 4)
    return dict(cfg, n_users=users, n_items=items,
                n_ratings=int(per_user * users))


def test_config_is_the_published_deployment_uncut():
    cfg = json.loads(CONFIG.read_text())
    pub = cfg["published"]
    assert (cfg["n_users"], cfg["n_items"], cfg["n_ratings"]) == (
        pub["n_users"], pub["n_items_rated"], pub["n_ratings"]) == (
        162541, 59047, 25000095)
    assert cfg["min_user_ratings"] == pub["min_user_ratings"] == 20
    assert (cfg["rating_min"], cfg["rating_max"], cfg["rating_step"]) == (
        0.5, 5.0, 0.5)
    assert cfg["reduced"] == []
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["ml25m"]
    assert entry["reduced"] == [] and (
        tiny.ROOT / entry["file"]).resolve() == CONFIG.resolve()


def test_marginals_on_the_half_star_grid():
    cfg = small()
    data = gen_halfstar.generate(cfg, 2 ** 31 + 3, "cpu")
    r = data.matrix
    assert r.shape == (cfg["n_users"], cfg["n_items"])
    cnt = (r > 0).sum(1)
    assert int(cnt.sum()) == cfg["n_ratings"]
    assert torch.equal(cnt, data.counts)
    assert int(cnt.min()) >= cfg["min_user_ratings"]
    vals = r[r > 0]
    assert set(torch.unique(vals).tolist()) == GRID
    halves = (vals * 2 % 2 == 1).double().mean()
    assert 0.3 < float(halves) < 0.7          # both kinds of star
    assert abs(float(vals.mean()) - cfg["published"]["mean_rating"]) < 0.15


def test_seed_gives_one_matrix():
    cfg = small(200, 300)
    a = gen_halfstar.generate(cfg, 99, "cpu").matrix
    assert torch.equal(a, gen_halfstar.generate(cfg, 99, "cpu").matrix)
    assert not torch.equal(a, gen_halfstar.generate(cfg, 100, "cpu").matrix)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_scaled_draw_is_the_direct_half_star_rounding(monkeypatch, seed):
    """Drawn at twice the scale and halved, the matrix equals the latent
    model at scale 1 rounded straight to half stars, bit for bit, and
    the model it returns rounds the same way."""
    cfg = small(150, 200)
    got = gen_halfstar.generate(cfg, seed, "cpu")

    def half_star(self, raw):
        return (torch.round(raw * 2.0) / 2.0).clamp(0.5, 5.0)
    monkeypatch.setattr(gen.Ratings, "rating", half_star)
    want = gen.generate(cfg, seed, "cpu")
    assert torch.equal(got.matrix, want.matrix)
    assert torch.equal(got.bias_u, want.bias_u)
    assert torch.equal(got.bias_i, want.bias_i)
    raw = torch.linspace(-1.0, 7.0, 97)
    assert torch.equal(got.rating(raw), half_star(None, raw))


@pytest.mark.parametrize("step", [0.3, 2.0, 0.75])
def test_only_power_of_two_grids(step):
    with pytest.raises(ValueError):
        gen_halfstar.grid_scale(step)


def test_port_takes_the_f32_gather_source():
    data = gen_halfstar.generate(small(200, 300), 5, "cpu")
    eng = CFEngine(data.matrix, k=8, device="cpu").fit()
    assert eng._gather_source(eng.ratings).dtype == torch.float32


# -- the job, on a tiny tree ---------------------------------------------

@pytest.fixture(scope="module")
def here(tmp_path_factory):
    """The tiny tree with ml25m cut to the tiny sizes too."""
    here = tiny.tiny_tree(tmp_path_factory.mktemp("halfstar"))
    path = here / "configs" / "halfstar" / "ml25m.json"
    cfg = json.loads(path.read_text())
    cfg.update(tiny.TINY)
    cfg["engine"] = dict(cfg["engine"], k=8)
    path.write_text(json.dumps(cfg))
    return here


def test_sound_run_is_correct(here):
    out = tiny.run(here, CELL)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert set(out["metrics"]) == {"recommend_users_per_s", "setup_s"}


def test_altered_pass_reads_incorrect(here, monkeypatch):
    orig = CFEngine.recommend

    def recommend(self, *args, **kw):
        s, i = orig(self, *args, **kw)
        return torch.nextafter(s, torch.tensor(9.0)), i
    monkeypatch.setattr(CFEngine, "recommend", recommend)
    out = tiny.run(here, CELL)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 1, 4_000_000_007])
def test_control_reads_incorrect(here, seed):
    job = tiny.job(here, CELL, seed)
    job.prepare()
    assert set(torch.unique(job.data.matrix).tolist()) <= GRID | {0.0}
    readings = job.control()
    assert any(value > limit for value, limit in readings.values())


def test_job_counts_the_pass_and_the_select(here):
    job = tiny.job(here, CELL)
    job.setup()
    u, i = job.data.matrix.shape
    work = job.work()
    assert work["pass"] == counts.recommend_work(u, i, 8, 10, job.terms)
    assert work["topn"] == counts_topn.topn_work(u, i, 10)


# -- the select's count and reader ---------------------------------------

@pytest.mark.parametrize("u,i,n", [(1, 1, 1), (3, 7, 10), (1024, 59047, 10)])
def test_topn_count_is_the_tensors_bytes(u, i, n):
    pred = torch.empty((u, i), dtype=torch.float32, device="meta")
    out_s = torch.empty((u, n), dtype=torch.float32, device="meta")
    out_i = torch.empty((u, n), dtype=torch.int32, device="meta")
    want = sum(t.numel() * t.element_size() for t in (pred, out_s, out_i))
    assert counts_topn.topn_work(u, i, n) == {"bytes": float(want)}


K5 = ("void (anonymous namespace)::radix_topm_kernel<false>(float const*, "
      "int const*, float*, int*, int, int, int, int)")
K2 = ("void (anonymous namespace)::predict_kernel(float const*, int, int, "
      "int const*)")


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("cfbench.step", "user_annotation", 0, 100),
    ev("cfbench.step", "user_annotation", 100, 100),
    ev(K2, "kernel", 5, 40), ev(K5, "kernel", 50, 30),
    ev(K2, "kernel", 105, 40), ev(K5, "kernel", 150, 10),
    ev(K5, "kernel", 250, 10),                    # past the window
]


def test_select_roofline_reads_kernel_5_a_pass():
    from cfbench import harness
    reader = harness.reader_for("select_roofline")
    work = {"topn": counts_topn.topn_work(100, 50, 10)}
    ctx = SimpleNamespace(trace=trace.Trace(EVENTS), work=work,
                          peaks=counts.H100_PEAKS)
    # 40 µs of kernel 5 over two passes: 20 µs a pass
    want = 100.0 * work["topn"]["bytes"] / 3.35e12 / 20e-6
    assert abs(reader.read(ctx) - want) < 1e-9 * want
    no_k5 = trace.Trace([e for e in EVENTS if e["name"] != K5])
    for other in (dict(work={"pass": {}}), dict(peaks=None),
                  dict(trace=trace.Trace([])), dict(trace=no_k5)):
        assert reader.read(SimpleNamespace(**{**vars(ctx), **other})) \
            is None
