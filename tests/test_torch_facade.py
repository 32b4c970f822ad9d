"""Port parity: the exact ``CFEngine`` (both port backends, on the CPU)
against the JAX reference engine on the ``ml_small`` split (384 × 300):
neighbor ids identical and scores within 2e-5, recommend ids identical up
to ties at the cut, incremental updates bitwise equal to a cold fit, the
reference's ``state()`` carried into the port, and the held-out MAE."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, to_np
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core import metrics as ref_metrics
from repro.core.facade import CFEngine as RefEngine
from repro_torch.core import engine as tengine
from repro_torch.core import metrics
from repro_torch.core import facade as tfacade
from repro_torch.core.facade import BACKENDS, CFEngine
from repro_torch.core.predict import make_gather_operand
from repro_torch.core.similarity import (SIMILARITY_MEASURES,
                                         pairwise_similarity)
from repro_torch.index import IndexConfig
from repro_torch.state import from_reference_state

K = 10


@pytest.fixture(scope="module")
def ref_engines(ml_small):
    train = ml_small[0]
    return {m: RefEngine(jnp.asarray(train), measure=m, k=K,
                         block_size=128).fit()
            for m in SIMILARITY_MEASURES}


def _port(train, measure, backend, **kw):
    return CFEngine(train, measure=measure, k=K, block_size=128,
                    backend=backend, device="cpu", **kw).fit()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_neighbors_match_reference(ml_small, ref_engines, measure, backend):
    eng = _port(ml_small[0], measure, backend)
    s, i = eng.neighbors()
    r_s, r_i = ref_engines[measure].neighbors()
    assert_parity(f"engine.{backend}.{measure}.ids", i, r_i)
    assert_parity(f"engine.{backend}.{measure}.scores", s, r_s, atol=2e-5)


def test_backends_agree_bitwise(ml_small):
    a = _port(ml_small[0], "pcc", "sequential")
    b = _port(ml_small[0], "pcc", "kernel")
    assert torch.equal(a.idx, b.idx) and torch.equal(a.scores, b.scores)
    assert torch.equal(a.recommend(n=10)[1], b.recommend(n=10)[1])


def _record_similarity_operands(monkeypatch):
    """Record (dtype, max_value) of every fused-similarity call the
    facade makes."""
    seen = []
    real = tfacade.ksim.fused_similarity

    def spy(ra, rb, **kw):
        seen.append((ra.dtype, rb.dtype, kw.get("max_value")))
        return real(ra, rb, **kw)

    monkeypatch.setattr(tfacade.ksim, "fused_similarity", spy)
    return seen


@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_kernel_backend_takes_the_int8_operand(ml_small, ref_engines,
                                               monkeypatch, measure):
    """Integer ratings: every candidate block of the kernel fit goes to
    the similarity kernel as int8 with the ratings' bound (5), and the
    fit equals the sequential backend bit for bit — and the reference's,
    bit for bit except pcc_sig's one-ulp score difference, which both
    port backends share."""
    seen = _record_similarity_operands(monkeypatch)
    eng = _port(ml_small[0], measure, "kernel")
    assert len(seen) == 3                       # 384 users, blocks of 128
    assert set(seen) == {(torch.int8, torch.int8, 5)}
    seq = _port(ml_small[0], measure, "sequential")
    assert torch.equal(eng.idx, seq.idx)
    assert torch.equal(eng.scores, seq.scores)
    r_s, r_i = ref_engines[measure].neighbors()
    assert_parity(f"engine.kernel.int8.{measure}.ids", eng.idx, r_i)
    assert_parity(f"engine.kernel.int8.{measure}.scores", eng.scores, r_s,
                  atol=2e-5 if measure == "pcc_sig" else 0.0)
    seen.clear()
    st = eng.update_ratings([3, 3, 200], [7, 8, 9], [4.0, 0.0, 1.0],
                            oracle_check=True)
    assert st.oracle_ok           # the refit and the oracle's recompute
    assert seen and set(seen) == {(torch.int8, torch.int8, 5)}


def test_half_star_ratings_take_the_f32_operand(ml_small, monkeypatch):
    """A 3.5 rating leaves int8: the fit scores f32 blocks (no
    max_value), still bit for bit the sequential backend's."""
    train = ml_small[0].copy()
    train[0, np.nonzero(train[0])[0][0]] = 3.5
    seen = _record_similarity_operands(monkeypatch)
    eng = _port(train, "pcc", "kernel")
    assert set(seen) == {(torch.float32, torch.float32, None)}
    seq = _port(train, "pcc", "sequential")
    assert torch.equal(eng.idx, seq.idx)
    assert torch.equal(eng.scores, seq.scores)


@pytest.mark.parametrize("top,width,want", [
    (5, 3952, "int8"), (64, 4096, "int8"), (64, 4097, "f32"),
    (127, 3952, "f32"), (0, 300, "int8")])
def test_similarity_operand_choice(top, width, want):
    """The fit's operand: int8 with its largest rating as max_value inside
    the int8 route's exact domain (max_value² · D ≤ 2^24), else f32."""
    r = torch.zeros((3, width))
    r[1, 2] = float(top)
    gather = make_gather_operand(r)
    assert gather.src.dtype == torch.int8 and gather.max_value == top
    op, max_value = tengine._similarity_operand(r, gather)
    if want == "int8":
        assert op is gather.src and max_value == top
    else:
        assert op is r and max_value is None


def _assert_recommend_tie_aware(name, got_i, want_i, pred):
    """Ids identical, except where the two predictions at the cut are
    within 1e-5 (a near-tie the two packages may round either way)."""
    got_i, want_i, pred = to_np(got_i), to_np(want_i), to_np(pred)
    bad = np.nonzero((got_i != want_i).any(axis=1))[0]
    for u in bad:
        j = int(np.argmax(got_i[u] != want_i[u]))
        a, b = got_i[u, j], want_i[u, j]
        assert a >= 0 and b >= 0, (name, u, got_i[u], want_i[u])
        assert abs(pred[u, a] - pred[u, b]) <= 1e-5, (name, u, a, b)
    print(f"PARITY {name} rows_differing_at_near_ties={len(bad)}")


@pytest.mark.parametrize("user_block", [None, 8])
@pytest.mark.parametrize("measure", ["pcc", "cosine"])
def test_recommend_matches_reference(ml_small, ref_engines, measure,
                                     user_block, monkeypatch):
    """``user_block`` 8 splits the exact path's 384 users into 48 blocks,
    and its shuffled 61 ids into 8 blocks with a partial last one."""
    if user_block is not None:
        monkeypatch.setattr(tfacade, "USER_BLOCK", user_block)
    ref = ref_engines[measure]
    _, want = ref.recommend(n=10)
    for backend in BACKENDS:
        eng = _port(ml_small[0], measure, backend)
        _, got = eng.recommend(n=10)
        _assert_recommend_tie_aware(f"recommend.{backend}.{measure}", got,
                                    want, eng.predict())
        for sub in ([5, 0, 383, 5],
                    np.random.default_rng(1).permutation(384)[:61].tolist()):
            _, got_sub = eng.recommend(sub, n=10)
            assert torch.equal(got_sub, got[sub])
        seen = eng.ratings > 0
        for u in range(eng.n_users):
            row = got[u][got[u] >= 0].long()
            assert not seen[u, row].any()


def test_predict_and_mae_match_reference(ml_small, ref_engines):
    train, test, _ = ml_small
    ref = ref_engines["pcc"]
    eng = _port(train, "pcc", "kernel")
    pred = eng.predict()
    assert_parity("engine.predict", pred, ref.predict(), atol=2e-5)
    got = float(metrics.mae(pred, torch.from_numpy(test)))
    want = float(ref_metrics.mae(ref.predict(), jnp.asarray(test)))
    print(f"PARITY engine.mae max_abs_diff={abs(got - want)!r} atol=1e-06")
    assert abs(got - want) <= 1e-6
    assert abs(float(metrics.rmse(pred, torch.from_numpy(test)))
               - float(ref_metrics.rmse(ref.predict(), jnp.asarray(test)))
               ) <= 1e-6
    p = metrics.precision_recall_f1(pred, torch.from_numpy(test))
    r = ref_metrics.precision_recall_f1(ref.predict(), jnp.asarray(test))
    for key in ("tp", "fp", "fn", "tn"):
        assert float(p[key]) == float(r[key])
    for key in ("precision", "recall", "f1"):
        assert abs(float(p[key]) - float(r[key])) <= 1e-6


def _delta(rng, u, d, n_users_touched, per_user=4):
    us = rng.choice(u, n_users_touched, replace=False)
    uids = np.repeat(us, per_user).astype(np.int32)
    iids = rng.integers(0, d, uids.size).astype(np.int32)
    vals = rng.integers(0, 6, uids.size).astype(np.float32)   # 0 = delete
    return uids, iids, vals


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("measure", SIMILARITY_MEASURES)
def test_update_equals_cold_fit_bitwise(ml_small, measure, backend):
    train = ml_small[0]
    u, d = train.shape
    rng = np.random.default_rng(11)
    eng = _port(train, measure, backend)
    want = train.copy()
    for _ in range(3):                      # repeated updates stay exact
        uids, iids, vals = _delta(rng, u, d, n_users_touched=3)
        stats = eng.update_ratings(uids, iids, vals, oracle_check=True)
        assert stats.oracle_ok
        assert stats.n_touched == len(np.unique(uids))
        assert stats.n_affected + stats.n_merged == u
        for uu, ii, vv in zip(uids, iids, vals):
            want[uu, ii] = vv
    assert np.array_equal(to_np(eng.ratings), want)
    cold = _port(want, measure, backend)
    assert torch.equal(cold.idx, eng.idx)
    assert torch.equal(cold.scores, eng.scores)
    assert torch.equal(cold.means, eng.means)
    assert eng.ratings_version == 3


def test_update_duplicates_last_wins_and_matches_reference(ml_small):
    train = ml_small[0]
    ref = RefEngine(jnp.asarray(train), measure="pcc", k=K,
                    block_size=128).fit()
    eng = _port(train, "pcc", "sequential")
    uids = np.array([7, 7, 7, 40, 40], np.int32)
    iids = np.array([3, 3, 9, 1, 1], np.int32)
    vals = np.array([5.0, 2.0, 0.0, 4.0, 1.0], np.float32)
    st = eng.update_ratings(uids, iids, vals, oracle_check=True)
    ref.update_ratings(uids, iids, vals)
    assert st.n_deltas == 3                        # (7,3) (7,9) (40,1)
    r = to_np(eng.ratings)
    assert r[7, 3] == 2.0 and r[7, 9] == 0.0 and r[40, 1] == 1.0
    assert_parity("update.ratings", eng.ratings, ref.ratings)
    assert_parity("update.ids", eng.idx, ref.idx)
    assert_parity("update.scores", eng.scores, ref.scores, atol=2e-5)
    assert_parity("update.means", eng.means, ref.means)
    empty = eng.update_ratings([], [], [])
    assert empty.n_deltas == 0
    with pytest.raises(ValueError):
        eng.update_ratings([10_000], [0], [1.0])
    with pytest.raises(ValueError):
        eng.update_ratings([0], [0, 1], [1.0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_state_carries_into_port(ml_small, ref_engines, backend):
    ref = ref_engines["pcc"]
    tree = ref.state()
    carried = from_reference_state(tree, "cpu")
    assert carried["version"] == ref.ratings_version
    eng = CFEngine(np.zeros((1, 1), np.float32), measure="pcc", k=K,
                   backend=backend, device="cpu").load_state(tree)
    _, want = ref.recommend(n=10)
    _, got = eng.recommend(n=10)
    _assert_recommend_tie_aware(f"state.recommend.{backend}", got, want,
                                eng.predict())
    eng2 = CFEngine(np.zeros((1, 1), np.float32), measure="pcc", k=K,
                    backend=backend, device="cpu").load_state(carried)
    assert torch.equal(eng2.recommend(n=10)[1], got)
    # the port's own state round-trips and keeps the reference layout
    own = eng.state()
    assert set(own) == set(tree) == set(eng.state_template())
    for key in ("ratings", "scores", "idx", "means", "cnt", "tot"):
        assert own[key].dtype == np.asarray(tree[key]).dtype, key
        assert np.array_equal(own[key], np.asarray(tree[key])), key


def test_state_with_index_is_refused(ml_small, ref_engines):
    """An index or item-index subtree must be whole; a whole item-index
    subtree (the reference's ``recommend_mode="approx"`` engine) carries
    across as host arrays and serves the port's approx recommend."""
    tree = dict(ref_engines["pcc"].state())
    tree["item_index"] = {"centroids": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="lacks"):
        from_reference_state(tree, "cpu")
    tree = dict(ref_engines["pcc"].state())
    tree["index"] = {"centroids": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="lacks"):
        from_reference_state(tree, "cpu")
    from repro.index import ItemIndexConfig as RefItemConfig
    from repro_torch.index import ItemIndexConfig
    cfg = dict(n_clusters=8, seed=0, shortlist=16)
    ref = RefEngine(jnp.asarray(ml_small[0]), measure="pcc", k=K,
                    block_size=128, recommend_mode="approx",
                    item_index_cfg=RefItemConfig(**cfg)).fit()
    tree = ref.state()
    carried = from_reference_state(tree, "cpu")
    assert set(carried["item_index"]) == set(tree["item_index"])
    for key, val in tree["item_index"].items():
        assert np.array_equal(carried["item_index"][key], np.asarray(val))
    eng = CFEngine(np.zeros((1, 1), np.float32), measure="pcc", k=K,
                   recommend_mode="approx", device="cpu",
                   item_index_cfg=ItemIndexConfig(**cfg)).load_state(tree)
    s, i = eng.recommend(n=10)
    assert torch.equal(i, eng.recommend(n=10, mode="exact")[1])
    _assert_recommend_tie_aware("state.item_index.recommend", i,
                                ref.recommend(n=10)[1], eng.predict())


def test_missing_card_raises_and_unported_options(monkeypatch):
    r = np.ones((4, 3), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CFEngine(r)
    with pytest.raises(NotImplementedError, match="'kernel' backend"):
        CFEngine(r, backend="pallas", device="cpu")
    # the mesh backends build on the default one-rank mesh; the indexes
    # get the engine's mesh and axis
    for backend in ("sharded", "ring"):
        eng = CFEngine(r, backend=backend, device="cpu",
                       neighbor_mode="approx")
        assert eng.mesh.size() == 1 and eng.mesh.device_type == "cpu"
        assert eng.index.mesh is eng.mesh and eng.index.mesh_axis == "data"
    staged = CFEngine(r, neighbor_mode="approx", device="cpu",
                      index_cfg=IndexConfig(query_mode="staged"))
    assert staged.index._query_mode() == "staged"
    assert staged.mesh is None and staged.index.mesh is None
    from repro_torch.index import ItemIndexConfig
    host = CFEngine(r, recommend_mode="approx", device="cpu",
                    item_index_cfg=ItemIndexConfig(shortlist_mode="support"))
    assert host.item_index._shortlist_mode() == "support"
    assert CFEngine(r, recommend_mode="approx", device="cpu"
                    ).item_index is not None
    with pytest.raises(ValueError):
        CFEngine(r, backend="threads", device="cpu")
    with pytest.raises(ValueError):
        CFEngine(r, measure="euclid", device="cpu")
    eng = CFEngine(r, k=2, device="cpu").fit()
    with pytest.raises(RuntimeError, match="item index"):
        eng.recommend(mode="approx")
    with pytest.raises(ValueError):
        eng.recommend(n_probe=4)


# -- approx neighbor mode (the clustered index) -------------------------------

def _ref_approx(train, measure, cfg):
    from repro.index import IndexConfig as RefConfig
    return RefEngine(jnp.asarray(train), measure=measure, k=K,
                     block_size=128, neighbor_mode="approx",
                     index_cfg=RefConfig(**cfg)).fit()


_APPROX = dict(n_clusters=16, seed=0, project_dim=32, rerank_frac=0.2,
               use_kernel=False, query_mode="fused")


@pytest.mark.parametrize("measure", ["pcc", "cosine"])
def test_approx_carried_state_matches_reference(ml_small, measure):
    """The reference's approx engine state, carried into the port: the
    same cache, the same recall against the exact engine, and the port's
    own re-query of the carried index gives the same neighbors."""
    train = ml_small[0]
    cfg = dict(_APPROX, features="centered" if measure == "pcc" else "raw")
    ref = _ref_approx(train, measure, cfg)
    eng = CFEngine(np.zeros((1, 1), np.float32), measure=measure, k=K,
                   block_size=128, neighbor_mode="approx",
                   index_cfg=IndexConfig(**cfg),
                   device="cpu").load_state(ref.state())
    assert_parity(f"approx.carried.{measure}.cache_ids", eng.idx, ref.idx)
    got, want = eng.recall_vs_exact(sample=128), ref.recall_vs_exact(
        sample=128)
    print(f"PARITY approx.recall_vs_exact.{measure} port={got!r} "
          f"reference={want!r}")
    assert got == want
    s, i = eng.index.query(eng.ratings, eng.means, k=K, measure=measure)
    assert_parity(f"approx.carried.{measure}.requery_ids", i, ref.idx)
    assert_parity(f"approx.carried.{measure}.requery_scores", s, ref.scores,
                  atol=2e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("measure", ["pcc", "jaccard"])
def test_approx_update_passes_oracle(ml_small, measure, backend):
    train = ml_small[0]
    u, d = train.shape
    eng = _port(train, measure, backend, neighbor_mode="approx",
                index_cfg=IndexConfig(n_clusters=16, project_dim=32,
                                      query_mode="fused"))
    assert eng.index.last_query.query_mode == "fused"
    rng = np.random.default_rng(3)
    for _ in range(3):
        uids, iids, vals = _delta(rng, u, d, n_users_touched=4)
        st = eng.update_ratings(uids, iids, vals, oracle_check=True)
        assert st.oracle_ok and st.n_affected + st.n_merged == u
        assert eng.index.last_refold.n_touched == len(np.unique(uids))
    full = pairwise_similarity(eng.ratings, eng.ratings, measure=measure)
    rows = torch.arange(u)[:, None].expand_as(eng.idx)
    ok = eng.idx >= 0
    assert torch.equal(eng.scores[ok], full[rows[ok], eng.idx[ok].long()])
    assert 0.0 < eng.recall_vs_exact(sample=64) <= 1.0


def test_approx_degenerate_matches_exact_fit():
    rng = np.random.default_rng(0)
    r = (rng.integers(1, 6, (64, 48)) * (rng.random((64, 48)) < 0.4)
         ).astype(np.float32)
    cfg = IndexConfig(n_clusters=8, n_probe=8, rerank_frac=0.0)
    ex = CFEngine(r, measure="cosine", k=6, block_size=16, device="cpu").fit()
    ap = CFEngine(r, measure="cosine", k=6, neighbor_mode="approx",
                  index_cfg=cfg, device="cpu").fit()
    assert torch.equal(ex.scores, ap.scores) and torch.equal(ex.idx, ap.idx)
    assert ex.recall_vs_exact(sample=32) == 1.0
    assert ap.recall_vs_exact(sample=32) == 1.0


def test_approx_new_user_onboarding():
    """A cold user gaining ratings enters real clusters and gets real
    neighbors through the index path (the reference's
    test_new_user_onboarding_approx)."""
    rng = np.random.default_rng(0)
    r = (rng.integers(1, 6, (64, 32)) * (rng.random((64, 32)) < 0.4)
         ).astype(np.float32)
    r[5] = 0.0
    eng = CFEngine(r, measure="cosine", k=5, neighbor_mode="approx",
                   index_cfg=IndexConfig(n_clusters=8, seed=0,
                                         features="raw"),
                   device="cpu").fit()
    iids = rng.choice(32, 10, replace=False).astype(np.int32)
    vals = rng.integers(1, 6, 10).astype(np.float32)
    st = eng.update_ratings(np.full(10, 5, np.int32), iids, vals,
                            oracle_check=True)
    assert st.oracle_ok
    assert int(eng.idx[5].max()) >= 0
    assert eng.index.check_consistent(eng.ratings, eng.means)


def test_approx_state_round_trip(ml_small):
    eng = _port(ml_small[0], "cosine", "kernel", neighbor_mode="approx",
                index_cfg=IndexConfig(n_clusters=12, project_dim=24))
    tree = eng.state()
    assert set(tree["index"]) == set(eng.state_template()["index"])
    back = CFEngine(np.zeros((1, 1), np.float32), measure="cosine", k=K,
                    neighbor_mode="approx",
                    index_cfg=IndexConfig(n_clusters=12, project_dim=24),
                    device="cpu").load_state(tree)
    assert torch.equal(back.idx, eng.idx)
    assert back.index.check_consistent(back.ratings, back.means)
    s, i = back.index.query(back.ratings, back.means, k=K, measure="cosine")
    assert torch.equal(i, eng.idx) and torch.equal(s, eng.scores)
