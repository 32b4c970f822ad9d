"""Port parity: the paper's ``UserCF`` (``repro_torch.core.cf_model``) and
the top-n list metric against the JAX reference, on the CPU.

* ``sequential`` engine, every measure, on ``ml_small`` (384 × 300):
  neighbor ids and scores bit for bit (``pcc_sig`` scores within 2e-5,
  the one-ulp difference of the reference's jitted epilogue), ``predict``
  within 1e-6, ``evaluate``'s keys equal and values within 1e-6,
  ``recommend`` ids equal up to ties at the cut (a swap passes only where
  the two predictions are within 1e-5, as in ``test_torch_facade.py``);
* the reference's fitted ``CFState`` carried across as numpy: the port
  predicts and evaluates from it as the reference does;
* ``sharded`` / ``ring`` on 1, 2 and 4 gloo ranks (``_torch_dist.py``)
  bit for bit the ``sequential`` engine, and ``build_step``'s
  ``cf_movielens`` steps through the same mesh;
* ``engine.kernel_topk`` — the one kernel fit of the facade,
  ``sharded_topk`` and ``UserCF`` — on CPU tensors (the kernel's plain
  version) equal to ``topk_neighbors``, for a query-row range too;
* ``topn_precision_recall`` on lists with ties straddling the cut, users
  with fewer than n unseen items and users with no relevant item;
* the reference's own end-to-end tests (``test_system.py``) on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import assert_parity, int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core import CFConfig as RefConfig
from repro.core import CFState as RefState
from repro.core import UserCF as RefUserCF
from repro.core import metrics as ref_metrics
from repro.data import load_ml1m_synthetic
from repro_torch.core import engine as E
from repro_torch.core import metrics
from repro_torch.core.cf_model import CFConfig, CFState, UserCF
from repro_torch.core.neighbors import topk_neighbors
from repro_torch.core.similarity import SIMILARITY_MEASURES, user_means

K = 10
BLOCK = 128


def _port(measure, **kw):
    return UserCF(CFConfig(measure=measure, top_k=K, block_size=BLOCK,
                           **kw), device="cpu")


@pytest.fixture(scope="module")
def reference(ml_small):
    train, test, _ = ml_small
    tr, te = jnp.asarray(train), jnp.asarray(test)
    out = {}
    for m in SIMILARITY_MEASURES:
        cf = RefUserCF(RefConfig(measure=m, top_k=K, block_size=BLOCK))
        cf.fit(tr)
        out[m] = {"model": cf, "predict": np.asarray(cf.predict(tr)),
                  "evaluate": cf.evaluate(tr, te),
                  "recommend": [np.asarray(x) for x in cf.recommend(tr)]}
    return out


@pytest.fixture(scope="module")
def ported(ml_small):
    train, test, _ = ml_small
    out = {}
    for m in SIMILARITY_MEASURES:
        cf = _port(m)
        cf.fit(train)
        out[m] = cf
    return out


@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_fit_matches_reference(reference, ported, measure):
    st, ref = ported[measure].state, reference[measure]["model"].state
    assert isinstance(st, CFState) and st.fit_seconds > 0
    assert_parity(f"usercf.{measure}.ids", st.idx, ref.idx)
    assert_parity(f"usercf.{measure}.scores", st.scores, ref.scores,
                  atol=2e-5 if measure == "pcc_sig" else 0.0)
    assert_parity(f"usercf.{measure}.means", st.means, ref.means)
    assert st.idx.dtype == torch.int32 and st.scores.dtype == torch.float32


@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_predict_and_evaluate_match_reference(ml_small, reference, ported,
                                              measure):
    train, test, _ = ml_small
    cf, ref = ported[measure], reference[measure]
    assert_parity(f"usercf.{measure}.predict", cf.predict(train),
                  ref["predict"], atol=1e-6)
    got = cf.evaluate(train, test)
    assert got.keys() == ref["evaluate"].keys()
    assert {"mae", "rmse", "precision", "recall", "f1", "tp", "fp", "fn",
            "tn", "top10_precision", "top10_recall",
            "top10_f1"} == set(got)
    for key, want in ref["evaluate"].items():
        assert isinstance(got[key], float)
        assert abs(got[key] - want) <= 1e-6, (key, got[key], want)


@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_recommend_matches_reference(ml_small, reference, ported, measure):
    train = ml_small[0]
    got_s, got_i = ported[measure].recommend(train, n=10)
    want_s, want_i = reference[measure]["recommend"]
    pred = reference[measure]["predict"]
    got_i = got_i.numpy()
    bad = np.nonzero((got_i != want_i).any(axis=1))[0]
    for u in bad:                       # a near-tie at the cut only
        j = int(np.argmax(got_i[u] != want_i[u]))
        a, b = got_i[u, j], want_i[u, j]
        assert abs(pred[u, a] - pred[u, b]) <= 1e-5, (u, a, b)
    keep = np.setdiff1d(np.arange(len(got_i)), bad)
    assert_parity(f"usercf.{measure}.recommend", got_i[keep], want_i[keep])
    assert_parity(f"usercf.{measure}.recommend.scores", got_s,
                  want_s, atol=1e-6)


@pytest.mark.parametrize("measure", ["cosine", "pcc_sig"])
def test_reference_state_carried_across(ml_small, reference, measure):
    """The reference's fitted state as numpy: the port predicts and
    evaluates from it as the reference does."""
    train, test, _ = ml_small
    ref = reference[measure]
    st = ref["model"].state
    cf = _port(measure)
    cf.state = CFState(scores=torch.from_numpy(np.array(st.scores)),
                       idx=torch.from_numpy(np.array(st.idx)),
                       means=torch.from_numpy(np.array(st.means)))
    assert_parity(f"usercf.{measure}.carried.predict", cf.predict(train),
                  ref["predict"], atol=1e-6)
    got = cf.evaluate(train, test)
    for key, want in ref["evaluate"].items():
        assert abs(got[key] - want) <= 1e-6, (key, got[key], want)


def test_config_and_usage_errors(ml_small):
    with pytest.raises(ValueError, match="unknown measure"):
        CFConfig(measure="euclid")
    with pytest.raises(ValueError, match="unknown engine"):
        CFConfig(engine="pallas")
    for engine in ("sharded", "ring"):
        with pytest.raises(ValueError, match="requires a mesh"):
            UserCF(CFConfig(engine=engine), device="cpu")
    cf = _port("pcc")
    with pytest.raises(RuntimeError, match="fit"):
        cf.predict(ml_small[0])
    with pytest.raises(ValueError, match="model runs on cpu"):
        cf.fit(torch.zeros((4, 3), device="meta"))


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UserCF(CFConfig())


@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_kernel_topk_is_the_plain_fit_on_cpu(measure):
    """The shared kernel fit on CPU tensors (the similarity wrapper's plain
    version) equals ``topk_neighbors``; a query range gives those rows,
    with a candidate block that does not divide U."""
    r = torch.from_numpy(int_ratings(np.random.default_rng(3), 70, 40))
    want_s, want_i = topk_neighbors(r, 6, measure=measure, block_size=16)
    s, i = E.kernel_topk(r, 6, measure=measure, block_size=16)
    assert torch.equal(i, want_i) and torch.equal(s, want_s)
    s, i = E.kernel_topk(r, 6, measure=measure, block_size=32, q0=20,
                         n_query=30)
    assert torch.equal(i, want_i[20:50]) and torch.equal(s, want_s[20:50])


# -- the mesh engines on gloo ranks -----------------------------------------

MESH_K = 8
MESH_BLOCK = 48


@pytest.fixture(scope="module")
def mesh_input():
    train, test, _ = load_ml1m_synthetic(n_users=256, n_items=120, seed=2)
    return train, test


@pytest.fixture(scope="module")
def ranks(mesh_input, tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            train, test = mesh_input
            cache[world] = td.launch(
                "usercf", world, tmp_path_factory.mktemp(f"usercf{world}"),
                {"ratings": train, "test": test, "k": MESH_K,
                 "block_size": MESH_BLOCK})
        return cache[world]
    return get


@pytest.fixture(scope="module")
def sequential(mesh_input):
    train, test = mesh_input
    out = {}
    for m in SIMILARITY_MEASURES:
        cf = UserCF(CFConfig(measure=m, top_k=MESH_K,
                             block_size=MESH_BLOCK), device="cpu")
        out[m] = (cf, cf.fit(train))
    return out


@pytest.mark.parametrize("engine", ["sharded", "ring"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_engines_equal_sequential(mesh_input, ranks, sequential, world,
                                       engine):
    train, test = mesh_input
    for rank, out in enumerate(ranks(world)):
        for m in SIMILARITY_MEASURES:
            st = sequential[m][1]
            s, i, means = out[(engine, m)]
            name = f"usercf.{engine}.P{world}.rank{rank}.{m}"
            assert_parity(f"{name}.ids", i, st.idx)
            assert_parity(f"{name}.scores", s, st.scores)
            assert_parity(f"{name}.means", means, st.means)
        cf = sequential[SIMILARITY_MEASURES[-1]][0]
        assert_parity(f"usercf.{engine}.P{world}.rank{rank}.predict",
                      out[(engine, "predict")], cf.predict(train),
                      atol=1e-6)
        want = cf.evaluate(train, test)
        got = out[(engine, "evaluate")]
        assert got.keys() == want.keys()
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-6, (rank, key)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_cf_steps_through_the_mesh(mesh_input, ranks, world):
    """``build_step``'s ``cf_fit`` (the ring engine of ``cf_movielens``)
    equals the sequential ``UserCF`` bit for bit, ``cf_predict`` (the
    ring predictor) its ``predict`` within 1e-5."""
    train = mesh_input[0]
    cf = UserCF(CFConfig(measure="pcc", top_k=MESH_K,
                         block_size=MESH_BLOCK), device="cpu")
    st = cf.fit(train)
    for rank, out in enumerate(ranks(world)):
        s, i = out["step_fit"]
        assert_parity(f"steps.cf_fit.P{world}.rank{rank}.ids", i, st.idx)
        assert_parity(f"steps.cf_fit.P{world}.rank{rank}.scores", s,
                      st.scores)
        assert_parity(f"steps.cf_predict.P{world}.rank{rank}",
                      out["step_predict"], cf.predict(train), atol=1e-5)


# -- the top-n list metric ---------------------------------------------------

def _topn_case(rng, u, i, *, ties=False):
    pred = rng.uniform(1, 5, (u, i)).astype(np.float32)
    if ties:                        # few distinct values: ties at every cut
        pred = np.round(pred * 2) / 2
    truth = int_ratings(rng, u, i, density=0.5)
    seen = rng.random((u, i)) < 0.3
    return pred, truth, seen


def _topn_parity(name, pred, truth, seen, n):
    want = ref_metrics.topn_precision_recall(
        jnp.asarray(pred), jnp.asarray(truth), jnp.asarray(seen), n)
    got = metrics.topn_precision_recall(
        torch.from_numpy(pred), torch.from_numpy(truth),
        torch.from_numpy(seen), n)
    assert got.keys() == want.keys()
    for key in want:
        assert_parity(f"topn.{name}.{key}", got[key], want[key], atol=1e-6)
    return got


@pytest.mark.parametrize("n", [1, 5, 12])
def test_topn_ties_straddle_the_cut(n):
    """Half-star predictions: every cut splits a tie set; ties go to the
    lower item id in both packages."""
    pred, truth, seen = _topn_case(np.random.default_rng(n), 40, 30,
                                   ties=True)
    _topn_parity(f"ties.n{n}", pred, truth, seen, n)
    # ranking: the port's list is the stable descending sort
    masked = np.where(seen, -np.inf, pred)
    items = np.argsort(-masked, axis=1, kind="stable")[:, :n]
    rel = (truth >= 3.5) & ~seen
    hits = np.take_along_axis(rel, items, 1).sum(1)
    has = rel.sum(1) > 0
    prec = np.where(has, hits / n, 0).sum() / max(has.sum(), 1)
    got = metrics.topn_precision_recall(
        torch.from_numpy(pred), torch.from_numpy(truth),
        torch.from_numpy(seen), n)
    assert abs(float(got["precision"]) - prec) <= 1e-6


def test_topn_users_with_few_unseen_items():
    """Users with fewer than n unseen items fill their list with seen
    (−inf) items, which never count as hits."""
    rng = np.random.default_rng(7)
    pred, truth, seen = _topn_case(rng, 24, 10)
    seen[:8] = True                   # nothing unseen
    seen[8:16, 3:] = True             # three unseen items
    truth[8:16, :3] = 5.0             # ... all relevant
    got = _topn_parity("few_unseen", pred, truth, seen, 6)
    assert 0.0 <= float(got["precision"]) <= 1.0


def test_topn_users_without_relevant_items():
    """A user with no relevant unseen item is left out of the average; no
    such user at all gives 0 (the denominator is clamped to 1)."""
    rng = np.random.default_rng(8)
    pred, truth, seen = _topn_case(rng, 30, 20)
    truth[::2] = np.where(truth[::2] >= 3.5, 2.0, truth[::2])
    _topn_parity("some_without", pred, truth, seen, 5)
    got = _topn_parity("none_relevant", pred, np.minimum(truth, 3.0), seen,
                       5)
    assert float(got["precision"]) == float(got["recall"]) == 0.0
    assert float(got["f1"]) == 0.0


# -- the reference's end-to-end tests on the port ----------------------------

@pytest.fixture(scope="module")
def ml_split():
    return load_ml1m_synthetic(n_users=768, n_items=512, seed=7)


def test_cf_end_to_end_all_measures(ml_split):
    """The paper's experiment: fit, predict, evaluate with all 3 measures
    (``test_system.py::test_cf_end_to_end_all_measures``)."""
    train, test, _ = ml_split
    results = {}
    for measure in ("jaccard", "cosine", "pcc"):
        cf = UserCF(CFConfig(measure=measure, top_k=30, block_size=128),
                    device="cpu")
        cf.fit(train)
        results[measure] = cf.evaluate(train, test)
    for m, ev in results.items():
        assert 0.6 < ev["mae"] < 1.1, (m, ev["mae"])
        assert ev["precision"] > 0.5, (m, ev)
        assert ev["recall"] > 0.4, (m, ev)
        assert 0 < ev["f1"] <= 1
    tr, te = torch.from_numpy(train), torch.from_numpy(test)
    naive = user_means(tr)[:, None].expand(te.shape)
    naive_mae = float(metrics.mae(naive, te, te > 0))
    assert min(ev["mae"] for ev in results.values()) < naive_mae


def test_cf_topn_curves(ml_split):
    """MAE improves (then flattens) as top-N grows — the paper's Fig. 3
    shape (``test_system.py::test_cf_topn_curves``)."""
    train, test, _ = ml_split
    maes = []
    for k in (2, 10, 40):
        cf = UserCF(CFConfig(measure="pcc", top_k=k, block_size=128),
                    device="cpu")
        cf.fit(train)
        maes.append(cf.evaluate(train, test)["mae"])
    assert maes[1] < maes[0]
    assert abs(maes[2] - maes[1]) < 0.08


def test_cf_recommendations_are_unseen(ml_split):
    train = ml_split[0][:128]
    cf = UserCF(CFConfig(measure="cosine", top_k=10, block_size=64),
                device="cpu")
    cf.fit(train)
    scores, items = cf.recommend(train, n=5)
    seen = train > 0
    items = items.numpy()
    for u in range(items.shape[0]):
        assert not seen[u, items[u]].any()
    assert tuple(scores.shape) == (128, 5)


def test_state_and_config_fields_match_reference():
    """``RefState`` and ``CFState`` carry the same fields; the configs
    the same defaults."""
    assert [f.name for f in dataclasses.fields(CFState)] == \
        [f.name for f in dataclasses.fields(RefState)]
    assert dataclasses.asdict(CFConfig()) == dataclasses.asdict(RefConfig())
