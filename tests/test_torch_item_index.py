"""Port parity: the item index (``CFEngine(recommend_mode="approx")``)
against the JAX reference, on the CPU.

* The reference engine's ``state()`` (with its ``item_index`` subtree)
  carried into the port, then recommended by both packages: the kernel
  scorer (the reference runs its host support pass, the same num/den
  form) and the proxy scorer (full-pool and cluster-restricted).  Proxy
  scores are summed in different orders by the two packages, so proxy
  shortlists are compared tie-aware (a differing item's proxy score must
  be within 1e-5 of the row's cut); recommended ids are compared
  tie-aware on the exact predictions (1e-5 at the cut) and scores within
  1e-6 (the reference's jitted predictor is 1 ulp off its eager form,
  ROADMAP Queue 3).
* Within the port: the kernel scorer at any shortlist ≥ n, and the
  degenerate mode (``n_probe = C``, ``shortlist = 0``), equal the exact
  recommend bit for bit.
* A fresh fit against the reference's; refold rounds (oracle-checked,
  and against the reference's refold of the same carried state); the
  periodic profile re-fold and the auto-refit; the recommendation
  contract, validation and state round trip; the recall floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index.item_index as jii
import repro_torch.index.item_index as tii
from _torch_parity import assert_parity, int_ratings, to_np
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core import similarity as jsim
from repro.core.facade import CFEngine as RefEngine
from repro.index import ItemClusteredIndex as JaxItemIndex
from repro.index import ItemIndexConfig as JaxItemConfig
from repro_torch.core import similarity as sim
from repro_torch.core.facade import CFEngine
from repro_torch.index import ItemClusteredIndex, ItemIndexConfig

K = 10


def _ref_engine(train, measure, cfg, k=K):
    return RefEngine(jnp.asarray(train), measure=measure, k=k,
                     block_size=128, recommend_mode="approx",
                     item_index_cfg=JaxItemConfig(**cfg)).fit()


def _carry(ref, measure, cfg, k=K):
    return CFEngine(np.zeros((1, 1), np.float32), measure=measure, k=k,
                    block_size=128, recommend_mode="approx",
                    item_index_cfg=ItemIndexConfig(**cfg),
                    device="cpu").load_state(ref.state())


def _port(r, measure="cosine", k=5, **cfg):
    return CFEngine(r, measure=measure, k=k, block_size=16,
                    recommend_mode="approx",
                    item_index_cfg=ItemIndexConfig(**cfg),
                    device="cpu").fit()


def _assert_tie_aware(name, got_s, got_i, want_s, want_i, pred, rows=None):
    """Ids equal except where the two exact predictions at the first
    difference are within 1e-5; scores within 1e-6 on equal-id rows."""
    got_s, got_i, want_s, want_i, pred = (to_np(x) for x in (
        got_s, got_i, want_s, want_i, pred))
    rows = np.arange(got_i.shape[0]) if rows is None else rows
    bad = [u for u in rows if (got_i[u] != want_i[u]).any()]
    for u in bad:
        j = int(np.argmax(got_i[u] != want_i[u]))
        a, b = got_i[u, j], want_i[u, j]
        assert a >= 0 and b >= 0, (name, u, got_i[u], want_i[u])
        assert abs(pred[u, a] - pred[u, b]) <= 1e-5, (name, u, a, b)
    keep = np.array([u for u in rows if u not in set(bad)], np.int64)
    assert_parity(f"{name}.ids", got_i[keep], want_i[keep])
    assert_parity(f"{name}.scores", got_s[keep], want_s[keep], atol=1e-6)
    print(f"PARITY {name} rows_differing_at_near_ties={len(bad)}")


# -- the reference's state carried into the port ------------------------------

@pytest.mark.parametrize("measure", ["cosine", "pcc"])
def test_carried_state_kernel_scorer(ml_small, measure):
    cfg = dict(n_clusters=12, seed=0, shortlist=24, shortlist_mode="kernel")
    ref = _ref_engine(ml_small[0], measure, cfg)
    eng = _carry(ref, measure, cfg)
    st = eng.state()["item_index"]
    for key, val in ref.state()["item_index"].items():
        assert np.array_equal(st[key], np.asarray(val)), key
    s, i = eng.recommend(n=K)
    j_s, j_i = ref.recommend(n=K)
    _assert_tie_aware(f"item_index.carried.kernel.{measure}", s, i, j_s,
                      j_i, eng.predict())
    # the kernel scorer's shortlist holds the exact top-n: exact, bitwise
    e_s, e_i = eng.recommend(n=K, mode="exact")
    assert torch.equal(s, e_s) and torch.equal(i, e_i)
    got, want = eng.recommend_recall_vs_exact(), ref.recommend_recall_vs_exact()
    print(f"PARITY item_index.recall.{measure} port={got!r} "
          f"reference={want!r}")
    assert got == 1.0 and want >= 0.95
    lr = eng.item_index.last_recommend
    assert lr.n_probed == 256 * 300 and lr.rerank_fraction <= 24 / 300


def _capture(monkeypatch, module):
    """Record the (query ids, shortlists) each rerank consumes."""
    got = []
    orig = module._rerank_items

    def grab(ratings, gather_src, nb_scores, nb_idx, means, q_means, q_ids,
             cand_items, **kw):
        got.append((to_np(q_ids), to_np(cand_items)))
        return orig(ratings, gather_src, nb_scores, nb_idx, means, q_means,
                    q_ids, cand_items, **kw)

    monkeypatch.setattr(module, "_rerank_items", grab)
    return got


def _shortlists(captured, n_users, n_items):
    out = {}
    for q_ids, short in captured:
        for q, row in zip(q_ids, short):
            if q < n_users:
                out[int(q)] = set(int(x) for x in row if 0 <= x < n_items)
    return out


@pytest.mark.parametrize("n_probe", [12, 3])
def test_carried_state_proxy_scorer(ml_small, monkeypatch, n_probe):
    cfg = dict(n_clusters=12, n_probe=n_probe, seed=0, shortlist=40,
               shortlist_mode="proxy", project_dim=32, query_block=64)
    ref = _ref_engine(ml_small[0], "cosine", cfg)
    eng = _carry(ref, "cosine", cfg)
    n_users, n_items = eng.ratings.shape
    j_cap, t_cap = _capture(monkeypatch, jii), _capture(monkeypatch, tii)
    j_s, j_i = ref.recommend(n=K)
    s, i = eng.recommend(n=K)
    j_short = _shortlists(j_cap, n_users, n_items)
    t_short = _shortlists(t_cap, n_users, n_items)
    assert j_short.keys() == t_short.keys() == set(range(n_users))
    ji = ref.item_index
    prof = np.asarray(jii._query_profiles(
        ji.profiles, ref.scores, ref.idx, jnp.arange(n_users)), np.float64)
    sc_all = prof @ np.asarray(ji.proxies, np.float64).T
    differ = set()
    for q in range(n_users):
        a, b = j_short[q], t_short[q]
        if a == b:
            continue
        differ.add(q)
        cut = min(sc_all[q, x] for x in a)
        for x in a ^ b:
            assert abs(sc_all[q, x] - cut) <= 1e-5, (q, x, sc_all[q, x], cut)
    rows = np.array([q for q in range(n_users) if q not in differ])
    print(f"PARITY item_index.carried.proxy.p{n_probe} "
          f"shortlist_rows_differing_at_near_ties={len(differ)}")
    _assert_tie_aware(f"item_index.carried.proxy.p{n_probe}", s, i, j_s,
                      j_i, eng.predict(), rows=rows)
    js, ts = ref.item_index.last_recommend, eng.item_index.last_recommend
    assert ts.n_probed == js.n_probed
    if not differ:
        assert ts.n_reranked == js.n_reranked


# -- exactness within the port ------------------------------------------------

@pytest.mark.parametrize("measure", ["pcc", "cosine", "jaccard"])
def test_kernel_scorer_equals_exact_recommend(measure):
    r = int_ratings(np.random.default_rng(10), 200, 150, 0.3)
    eng = CFEngine(r, measure=measure, k=K, block_size=64,
                   recommend_mode="approx", device="cpu",
                   item_index_cfg=ItemIndexConfig(seed=0)).fit()
    e_s, e_i = eng.recommend(n=K, mode="exact")
    for shortlist in (K, 24, 149):
        s, i = eng.recommend(n=K, shortlist=shortlist)
        assert_parity(f"item_index.kernel_vs_exact.{measure}.s{shortlist}"
                      ".ids", i, e_i)
        assert_parity(f"item_index.kernel_vs_exact.{measure}.s{shortlist}"
                      ".scores", s, e_s)
    sub = [5, 0, 199, 5]
    s, i = eng.recommend(sub, n=K, shortlist=24)
    assert torch.equal(i, e_i[sub]) and torch.equal(s, e_s[sub])
    # the plain versions everywhere (use_kernel=False) give the same bits
    plain = CFEngine(r, measure=measure, k=K, block_size=64,
                     recommend_mode="approx", device="cpu",
                     item_index_cfg=ItemIndexConfig(seed=0,
                                                    use_kernel=False)).fit()
    assert torch.equal(plain.recommend(n=K, shortlist=24)[1], e_i)


def test_degenerate_mode_is_bit_identical_to_exact():
    rng = np.random.default_rng(0)
    r = int_ratings(rng, 96, 64)
    ex = CFEngine(r, measure="cosine", k=6, block_size=32, device="cpu").fit()
    s_ex, i_ex = ex.recommend(n=8)
    ap = CFEngine(r, measure="cosine", k=6, block_size=32,
                  recommend_mode="approx", device="cpu",
                  item_index_cfg=ItemIndexConfig(n_clusters=8, n_probe=8,
                                                 shortlist=0)).fit()
    s_ap, i_ap = ap.recommend(n=8)
    assert torch.equal(s_ex, s_ap) and torch.equal(i_ex, i_ap)
    assert ap.item_index.last_recommend.rerank_fraction > 0.5
    assert ap.recommend_recall_vs_exact(sample=48, n=8) == 1.0
    ref = RefEngine(jnp.asarray(r), measure="cosine", k=6,
                    block_size=32).fit()
    j_s, j_i = ref.recommend(n=8)
    _assert_tie_aware("item_index.degenerate_vs_reference_exact", s_ap,
                      i_ap, j_s, j_i, ap.predict())


# -- fit and refold against the reference -------------------------------------

def test_fresh_fit_close_to_reference():
    r = int_ratings(np.random.default_rng(8), 200, 90)
    cfg = dict(n_clusters=10, seed=0, project_dim=24)
    rt, rj = torch.from_numpy(r), jnp.asarray(r)
    tix = ItemClusteredIndex(ItemIndexConfig(**cfg)).fit(
        rt, sim.user_stats(rt)[2])
    jix = JaxItemIndex(JaxItemConfig(**cfg)).fit(rj, jsim.user_stats(rj)[2])
    assert_parity("item_index.fit.proxies", tix.proxies, jix.proxies,
                  atol=1e-5)
    assert_parity("item_index.fit.centroids", tix.centroids, jix.centroids,
                  atol=1e-5)
    assert_parity("item_index.fit.spill_ids", tix.spill_ids, jix.spill_ids)
    assert_parity("item_index.fit.profiles", tix.profiles, jix.profiles,
                  atol=1e-4)
    assert_parity("item_index.fit.has_pos", tix._has_pos, jix._has_pos)
    assert (tix.n_clusters, tix.n_probe) == (jix.n_clusters, jix.n_probe)


def _deltas(rng, u, d, rounds=3):
    for _ in range(rounds):
        m = int(rng.integers(1, 8))
        yield (rng.choice(u, m, replace=False).astype(np.int32),
               rng.integers(0, d, m).astype(np.int32),
               rng.integers(0, 6, m).astype(np.float32))


@pytest.mark.parametrize("features", ["raw", "centered"])
def test_update_stream_keeps_item_index_consistent(features):
    rng = np.random.default_rng(1)
    r = int_ratings(rng, 80, 48)
    eng = _port(r, n_clusters=6, features=features, shortlist=16)
    ix = eng.item_index
    for delta in _deltas(rng, 80, 48):
        eng.recommend(n=5)                   # builds the per-ratings caches
        st = eng.update_ratings(*delta, oracle_check=True)
        assert st.oracle_ok
        # integer ratings: the scorer takes its int8 route, so the int8
        # gather source is its operand and no table is built; the source
        # was patched along the version chain, copy-on-write, to what a
        # cold build gives
        assert ix.last_refold.caches_patched == 1
        assert ix._support_dense_cache is None
        key, op = ix._gather_cache.entry
        assert key is eng.ratings
        assert torch.equal(op.src, eng.ratings.to(torch.int8))
    assert ix.check_consistent(eng.ratings, eng.means)
    e_s, e_i = eng.recommend(n=5, mode="exact")
    s, i = eng.recommend(n=5)
    assert torch.equal(s, e_s) and torch.equal(i, e_i)


@pytest.mark.parametrize("features", ["raw", "centered"])
def test_update_stream_patches_tables_on_the_f32_route(features):
    """Half-star ratings leave int8: the scorer reads the dense f32
    tables, patched copy-on-write along the version chain."""
    rng = np.random.default_rng(3)
    r = int_ratings(rng, 80, 48)
    r[r == 3] = 3.5
    eng = _port(r, n_clusters=6, features=features, shortlist=16)
    ix = eng.item_index
    for delta in _deltas(rng, 80, 48):
        eng.recommend(n=5)
        st = eng.update_ratings(*delta, oracle_check=True)
        assert st.oracle_ok
        assert ix.last_refold.caches_patched == 2
        cached = ix._support_dense_cache
        assert cached[0] is eng.ratings
        cold = tii.support_tables(eng.ratings, eng.means, 48)
        assert torch.equal(cached[1][0], cold[0])
        assert torch.equal(cached[1][1], cold[1])
    e_s, e_i = eng.recommend(n=5, mode="exact")
    s, i = eng.recommend(n=5)
    assert torch.equal(s, e_s) and torch.equal(i, e_i)


@pytest.mark.parametrize("measure", ["pcc", "jaccard"])
def test_int8_route_scores_equal_the_table_route(monkeypatch, measure):
    """The scorer's int8 operands (gather source, means) and the dense
    tables give the same shortlist scores bit for bit, so the int8 route
    changes no recommendation."""
    r = int_ratings(np.random.default_rng(11), 120, 200, 0.3)
    eng = _port(r, measure=measure, k=8, shortlist=24)
    ix = eng.item_index
    ratings, scores, idx, means = eng.snapshot()
    ops = ix._support_operands(ratings, means)
    assert ops[0].dtype == torch.int8 and ops[1] is not None
    assert ix._support_dense_cache is None
    ids = torch.arange(0, 120, 3)
    got = ix._score_select(ratings, means, scores, idx, ids, ops, 24)
    tables = ix._support_dense(ratings, means)
    want = ix._score_select(ratings, means, scores, idx, ids, tables, 24)
    assert torch.equal(got, want)
    seen = []
    real = tii.support_scores_int8_plain
    monkeypatch.setattr(tii, "support_scores_int8_plain",
                        lambda *a, **kw: seen.append(a[0].dtype)
                        or real(*a, **kw))
    s, i = eng.recommend(n=5)
    assert seen and set(seen) == {torch.int8}
    e_s, e_i = eng.recommend(n=5, mode="exact")
    assert torch.equal(s, e_s) and torch.equal(i, e_i)


def test_refold_matches_reference_on_carried_state():
    rng = np.random.default_rng(2)
    r = int_ratings(rng, 120, 60)
    cfg = dict(n_clusters=8, seed=0, shortlist=16, project_dim=16,
               refit_reassign_frac=0.0)
    ref = _ref_engine(r, "cosine", cfg, k=6)
    eng = _carry(ref, "cosine", cfg, k=6)
    for rnd, (us, its, vals) in enumerate(_deltas(rng, 120, 60), 1):
        ref.update_ratings(us, its, vals)
        eng.update_ratings(us, its, vals)
        ji, ti = ref.item_index, eng.item_index
        jst, tst = ji.last_refold, ti.last_refold
        assert (tst.n_touched, tst.n_changed_clusters, tst.n_full_rows) == \
            (jst.n_touched, jst.n_changed_clusters, jst.n_full_rows)
        name = f"item_index.refold.round{rnd}"
        assert_parity(f"{name}.spill_ids", ti.spill_ids, ji.spill_ids)
        assert_parity(f"{name}.spill_dist", ti.spill_dist, ji.spill_dist,
                      atol=1e-5)
        assert_parity(f"{name}.centroids", ti.centroids, ji.centroids,
                      atol=1e-6)
        assert_parity(f"{name}.profiles", ti.profiles, ji.profiles,
                      atol=1e-4)
        np.testing.assert_array_equal(ti._counts, ji._counts)


# -- profile re-fold and auto-refit -------------------------------------------

def test_profile_refold_zeroes_drift():
    rng = np.random.default_rng(3)
    eng = _port(int_ratings(rng, 150, 120, 0.3), k=6, n_clusters=8,
                shortlist=32, profile_refold_frac=0.01,
                refit_reassign_frac=0.0)
    saw = 0
    for _ in range(8):
        us = rng.choice(150, 4, replace=False).astype(np.int32)
        eng.update_ratings(us, rng.integers(0, 120, 4).astype(np.int32),
                           rng.integers(1, 6, 4).astype(np.float32),
                           oracle_check=True)
        saw += int(eng.item_index.last_refold.profile_refold)
    assert saw >= 6
    w, _ = tii._affinity_weights(eng.ratings, eng.means)
    assert torch.equal(tii._fold_profiles(w, eng.item_index.proxies),
                       eng.item_index.profiles)


def test_profile_refold_disabled_keeps_tolerance_contract():
    rng = np.random.default_rng(4)
    eng = _port(int_ratings(rng, 100, 80, 0.3), n_clusters=6, shortlist=16,
                profile_refold_frac=0.0)
    for _ in range(4):
        us = rng.choice(100, 3, replace=False).astype(np.int32)
        eng.update_ratings(us, rng.integers(0, 80, 3).astype(np.int32),
                           rng.integers(1, 6, 3).astype(np.float32))
        assert not eng.item_index.last_refold.profile_refold
    assert eng.item_index.check_consistent(eng.ratings, eng.means)


def test_refold_auto_refit_trigger():
    rng = np.random.default_rng(5)
    r = int_ratings(rng, 80, 48)
    eng = _port(r, n_clusters=8, shortlist=16, refit_reassign_frac=0.01)
    fired = False
    for _ in range(5):
        us = rng.choice(80, 6, replace=False).astype(np.int32)
        st = eng.update_ratings(us, rng.integers(0, 48, 6).astype(np.int32),
                                rng.integers(1, 6, 6).astype(np.float32),
                                oracle_check=True)
        assert st.oracle_ok
        fired |= eng.item_index.last_refold.refit
    assert fired
    off = _port(r, n_clusters=8, shortlist=16, refit_reassign_frac=0.0)
    for _ in range(3):
        us = rng.choice(80, 6, replace=False).astype(np.int32)
        off.update_ratings(us, rng.integers(0, 48, 6).astype(np.int32),
                           rng.integers(1, 6, 6).astype(np.float32))
        assert not off.item_index.last_refold.refit


# -- the recommendation contract, validation, state ---------------------------

def _assert_unseen(items, ratings):
    seen = to_np(ratings) > 0
    items = to_np(items)
    for u in range(items.shape[0]):
        row = items[u]
        assert not seen[u, row[row >= 0]].any()


@pytest.mark.parametrize("mode_kwargs", [
    dict(),
    dict(recommend_mode="approx",
         item_index_cfg=ItemIndexConfig(n_clusters=8, shortlist=16)),
    dict(recommend_mode="approx",
         item_index_cfg=ItemIndexConfig(n_clusters=8, shortlist=16,
                                        shortlist_mode="proxy")),
])
def test_recommend_never_returns_rated(mode_kwargs):
    rng = np.random.default_rng(6)
    r = int_ratings(rng, 64, 48, 0.5)
    r[3, :46] = 4.0                      # user 3: only 2 unseen items
    eng = CFEngine(r, measure="cosine", k=6, block_size=16, device="cpu",
                   **mode_kwargs).fit()
    _, items = eng.recommend(n=8)
    _assert_unseen(items, eng.ratings)
    assert int((items[3] == -1).sum()) >= 6
    us = rng.choice(64, 6, replace=False).astype(np.int32)
    iids = rng.integers(0, 48, 6).astype(np.int32)
    eng.update_ratings(us, iids, rng.integers(1, 6, 6).astype(np.float32))
    _, items = eng.recommend(n=8)
    _assert_unseen(items, eng.ratings)
    for u, i in zip(us, iids):
        assert i not in to_np(items)[u]


def test_recommend_empty_user_list():
    eng = _port(int_ratings(np.random.default_rng(7), 32, 24), k=4,
                n_clusters=4, shortlist=8)
    for mode in ("exact", "approx"):
        s, i = eng.recommend(user_ids=[], n=5, mode=mode)
        assert s.shape == (0, 5) and i.shape == (0, 5), mode


def test_validation():
    r = int_ratings(np.random.default_rng(8), 16, 12)
    with pytest.raises(ValueError):
        CFEngine(r, recommend_mode="sparse", device="cpu")
    with pytest.raises(ValueError, match="shortlist_mode"):
        ItemClusteredIndex(ItemIndexConfig(shortlist_mode="psychic"))
    assert ItemClusteredIndex(ItemIndexConfig(shortlist_mode="support")
                              )._shortlist_mode() == "support"
    host = CFEngine(r, k=3, block_size=8, recommend_mode="approx",
                    device="cpu", item_index_cfg=ItemIndexConfig(
                        n_clusters=3, shortlist=4, shortlist_mode="support"))
    host.fit()
    assert host.item_index._support_cache is not None   # pre-warmed
    s, i = host.recommend(n=3)
    assert torch.equal(i, host.recommend(n=3, mode="exact")[1])
    # a mesh on another device type than the ratings is refused at fit
    from types import SimpleNamespace
    meshed = ItemClusteredIndex(ItemIndexConfig(n_clusters=3),
                                mesh=SimpleNamespace(device_type="cuda"))
    with pytest.raises(ValueError, match="collectives"):
        meshed.fit(torch.from_numpy(r))
    with pytest.raises(ValueError):
        ItemClusteredIndex(ItemIndexConfig(features="whitened"))
    eng = CFEngine(r, k=3, block_size=8, device="cpu").fit()
    with pytest.raises(RuntimeError, match="item index"):
        eng.recommend(n=4, mode="approx")
    with pytest.raises(RuntimeError):
        ItemClusteredIndex().recommend(eng.ratings, eng.means, eng.scores,
                                       eng.idx)
    assert ItemClusteredIndex()._shortlist_mode() == "kernel"


def test_state_round_trip():
    eng = _port(int_ratings(np.random.default_rng(9), 64, 40), k=5,
                n_clusters=6, shortlist=12)
    tree = eng.state()
    assert set(tree["item_index"]) == set(
        ItemClusteredIndex.state_template()) == set(
        eng.state_template()["item_index"])
    back = CFEngine(np.zeros((1, 1), np.float32), measure="cosine", k=5,
                    recommend_mode="approx", device="cpu",
                    item_index_cfg=ItemIndexConfig(n_clusters=6,
                                                   shortlist=12)
                    ).load_state(tree)
    assert back.item_index.check_consistent(back.ratings, back.means)
    a, b = eng.recommend(n=6), back.recommend(n=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ix = ItemClusteredIndex(ItemIndexConfig(n_clusters=6, shortlist=12)
                            ).load_state(eng.item_index.state())
    assert ix.check_consistent(eng.ratings, eng.means)
    assert np.array_equal(ix.member_counts(),
                          eng.item_index.member_counts())


def test_recall_floor_small():
    """ML-1M surrogate at 512 × 256: the two-stage path recovers ≥ 95 %
    of the exact top-10 (the kernel scorer: all of it) while reranking a
    small fraction of the catalog."""
    from repro_torch.data import load_ml1m_synthetic
    train, _, _ = load_ml1m_synthetic(n_users=512, n_items=256, seed=0)
    eng = CFEngine(train, measure="cosine", k=20, block_size=128,
                   recommend_mode="approx", device="cpu",
                   item_index_cfg=ItemIndexConfig(seed=0, shortlist=48)
                   ).fit()
    rec = eng.recommend_recall_vs_exact(sample=256, n=10)
    frac = eng.item_index.last_recommend.rerank_fraction
    print(f"PARITY item_index.recall_floor recall={rec!r} "
          f"rerank_fraction={frac!r}")
    assert rec == 1.0 and frac < 0.30
