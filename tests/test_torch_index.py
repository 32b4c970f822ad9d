"""Port parity: the clustered index (fused query mode) against the JAX
reference, on the CPU.

* The degenerate mode (``n_probe = C``, ``rerank_frac = 0``) is bit for
  bit the exact engine's top-k — the port's and the reference's — on all
  four measures.
* The reference index's ``state()`` carried into the port, then queried by
  both packages (``IndexConfig(use_kernel=False, query_mode="fused")`` on
  the JAX side): pool branch, cluster-restricted branch, unfiltered
  blocks, subset and partial blocks, k > U.  Proxy scores are summed in
  different orders by the two packages, so shortlists are compared
  tie-aware — a candidate may differ only where its proxy score is within
  1e-6 of the row's cut, computed and asserted — and final neighbors bit
  for bit on every row whose shortlist agrees (``pcc_sig`` scores within
  2e-5: the reference's jitted division by β is 1 ulp off, ROADMAP
  Queue 3).
* ``refold`` over three update rounds keeps ``check_consistent`` and
  matches the reference's refold of the same carried state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index.clustered as jcl
import repro_torch.index.clustered as tcl
from _torch_parity import assert_parity, int_ratings, to_np
from repro.core import neighbors as jnb
from repro.core import similarity as jsim
from repro.index import ClusteredIndex as JaxIndex
from repro.index import IndexConfig as JaxConfig
from repro_torch.core import neighbors as nb
from repro_torch.core import similarity as sim
from repro_torch.index import ClusteredIndex, IndexConfig

MEASURES = ("cosine", "jaccard", "pcc", "pcc_sig")


def _data(seed, u, d, density=0.35):
    r = int_ratings(np.random.default_rng(seed), u, d, density)
    rt = torch.from_numpy(r)
    return r, rt, sim.user_stats(rt)[2]


def _score_tol(measure):
    return 2e-5 if measure == "pcc_sig" else 0.0


# -- degenerate mode ----------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
def test_degenerate_mode_is_bit_identical_to_exact(measure):
    r, rt, means = _data(0, 96, 64)
    ix = ClusteredIndex(IndexConfig(n_clusters=8, n_probe=8,
                                    rerank_frac=0.0)).fit(rt, means)
    s_ap, i_ap = ix.query(rt, means, k=10, measure=measure)
    s_ex, i_ex = nb.topk_neighbors(rt, 10, measure=measure, block_size=32)
    assert torch.equal(i_ap, i_ex) and torch.equal(s_ap, s_ex)
    j_s, j_i = jnb.topk_neighbors(jnp.asarray(r), 10, measure=measure,
                                  block_size=32)
    assert_parity(f"index.degenerate.{measure}.ids", i_ap, j_i)
    assert_parity(f"index.degenerate.{measure}.scores", s_ap, j_s,
                  atol=_score_tol(measure))
    st = ix.last_query
    assert st.n_reranked == 96 * 95 and st.scan_mode == ""


# -- the reference's state carried into the port ------------------------------

def _carried(seed, u, d, **kw):
    """A reference index fitted on numpy-seeded ratings (its XLA twins,
    fused mode), and the port's index loaded from its ``state()``."""
    r, rt, means = _data(seed, u, d)
    cfg = dict(n_clusters=12, n_probe=12, seed=0, features="raw",
               rerank_frac=0.3, project_dim=24, use_kernel=False,
               query_mode="fused", shortlist_scan_mode="kernel")
    cfg.update(kw)
    rj = jnp.asarray(r)
    jix = JaxIndex(JaxConfig(**cfg)).fit(rj, jsim.user_stats(rj)[2])
    tix = ClusteredIndex(IndexConfig(**cfg)).load_state(jix.state())
    return r, rt, means, jix, tix


def _capture(monkeypatch, module):
    """Record the (query ids, shortlists) each fused rerank consumes."""
    got = []
    orig = module._fused_rerank_block

    def grab(*args, **kw):
        q_ids, shorts = args[-2:]        # the last two in both packages
        got.append((to_np(q_ids), to_np(shorts)))
        return orig(*args, **kw)

    monkeypatch.setattr(module, "_fused_rerank_block", grab)
    return got


def _shortlists(captured, n):
    out = {}
    for q_ids, shorts in captured:
        for q, row in zip(q_ids, shorts):
            if q < n:
                out[int(q)] = set(int(x) for x in row if x < n)
    return out


def _compare_carried(name, jix, tix, r, rt, means, monkeypatch, *, k,
                     measure, users=None):
    n = r.shape[0]
    rj = jnp.asarray(r)
    j_cap = _capture(monkeypatch, jcl)
    t_cap = _capture(monkeypatch, tcl)
    j_s, j_i = jix.query(rj, jsim.user_stats(rj)[2], users, k=k,
                         measure=measure)
    t_s, t_i = tix.query(rt, means, users, k=k, measure=measure)
    j_short, t_short = _shortlists(j_cap, n), _shortlists(t_cap, n)
    assert j_short.keys() == t_short.keys()
    prox = np.asarray(jix.proxies, np.float64)
    differ = set()
    for q in j_short:
        a, b = j_short[q], t_short[q]
        if a == b:
            continue
        differ.add(q)
        sc = prox[q] @ prox.T
        cut = min(sc[x] for x in a)
        for x in a ^ b:
            assert abs(sc[x] - cut) <= 1e-6, (name, q, x, sc[x], cut)
    rows = np.arange(n) if users is None else np.asarray(users)
    keep = np.array([q not in differ for q in rows], bool)
    assert_parity(f"{name}.ids", to_np(t_i)[keep], np.asarray(j_i)[keep])
    assert_parity(f"{name}.scores", to_np(t_s)[keep], np.asarray(j_s)[keep],
                  atol=_score_tol(measure))
    print(f"PARITY {name} shortlist_rows_differing_at_near_ties="
          f"{len(differ)}")
    js, ts = jix.last_query, tix.last_query
    assert (ts.n_probed, ts.scan_mode, ts.query_mode) == \
        (js.n_probed, js.scan_mode, js.query_mode)
    if not differ:
        assert ts.n_reranked == js.n_reranked
    assert ts.seconds_total == ts.seconds_shortlist + ts.seconds_rerank
    return t_s, t_i


@pytest.mark.parametrize("measure", MEASURES)
def test_carried_state_pool_branch(measure, monkeypatch):
    r, rt, means, jix, tix = _carried(1, 220, 72)
    _compare_carried(f"index.carried.pool.{measure}", jix, tix, r, rt, means,
                     monkeypatch, k=8, measure=measure)
    assert tix.last_query.scan_mode == "kernel"


@pytest.mark.parametrize("measure", ("cosine", "pcc_sig"))
def test_carried_state_cluster_branch(measure, monkeypatch):
    r, rt, means, jix, tix = _carried(
        2, 420, 56, n_clusters=24, n_probe=2, spill=1, rerank_frac=0.05,
        project_dim=16, query_block=64, shortlist_scan_mode="cluster")
    _compare_carried(f"index.carried.cluster.{measure}", jix, tix, r, rt,
                     means, monkeypatch, k=5, measure=measure)
    assert tix.last_query.scan_mode == "cluster"


def test_carried_state_unfiltered_blocks(monkeypatch):
    r, rt, means, jix, tix = _carried(
        3, 300, 56, n_clusters=20, n_probe=2, spill=1, rerank_frac=0.9,
        query_block=64, shortlist_scan_mode="cluster")
    _compare_carried("index.carried.unfiltered", jix, tix, r, rt, means,
                     monkeypatch, k=6, measure="pcc")


def test_carried_state_subset_and_partial_blocks(monkeypatch):
    r, rt, means, jix, tix = _carried(4, 200, 72)
    sub = np.asarray([0, 7, 63, 64, 199], np.int32)
    _, t_i = _compare_carried("index.carried.subset", jix, tix, r, rt, means,
                              monkeypatch, k=8, measure="cosine", users=sub)
    assert (t_i < 200).all()


def test_carried_state_k_exceeds_population(monkeypatch):
    r, rt, means, jix, tix = _carried(5, 10, 40, n_clusters=2, n_probe=2,
                                      project_dim=8, rerank_frac=0.9)
    _, t_i = _compare_carried("index.carried.k_gt_u", jix, tix, r, rt,
                              means, monkeypatch, k=12, measure="cosine")
    assert (t_i[:, -1] == -1).all()


# -- the fused rerank over the block's real union and rows --------------------

def _padded_rerank_block(ratings, r_gather, norms, counts, q_ids, shorts, *,
                         ku, k, measure):
    """The fused rerank as it scored a block before: f32 query rows from
    the ratings, every (padding included) row of the block, and the union
    padded with the sentinel to the power of two ``ku``."""
    from repro_torch.kernels.rerank import rerank_scores_plain
    n = r_gather.shape[0]
    u = torch.unique(shorts.long())
    u = torch.cat([u, u.new_full((ku - u.numel(),), n)])
    safe_u = u.clamp_max(n - 1)
    s = rerank_scores_plain(ratings[q_ids.long().clamp_max(n - 1)],
                            r_gather[safe_u], norms[safe_u], counts[safe_u],
                            measure=measure)
    col = torch.searchsorted(u, shorts.long()).clamp(0, ku - 1)
    sc = torch.gather(s, 1, col)
    invalid = (shorts >= n) | (shorts == q_ids[:, None])
    sc = sc.masked_fill(invalid, nb.NEG_INF)
    ci = torch.where(invalid, torch.full_like(shorts, n), shorts)
    return tcl._topk_with_padding(sc, ci.to(torch.int32), k, n)


@pytest.mark.parametrize("measure", MEASURES)
def test_fused_rerank_block_real_union_equals_padded(measure):
    """Scoring only the block's real query rows against the real union
    columns (int8 query rows from the gather source) gives the padded
    form's top-k bit for bit, ids and scores."""
    from repro_torch.core import predict as pred
    rng = np.random.default_rng(23)
    n, bq, m, k = 90, 16, 21, 7
    _, rt, _ = _data(23, n, 64)
    src = pred.make_gather_source(rt)
    assert src.dtype == torch.int8
    norms, counts = tcl._user_norms_counts(rt)
    nv = 11                                      # real rows; then padding
    q_ids = torch.full((bq,), n, dtype=torch.int32)
    q_ids[:nv] = torch.from_numpy(rng.choice(n, nv, replace=False)
                                  .astype(np.int32))
    shorts = torch.from_numpy(rng.integers(0, n, (bq, m)).astype(np.int32))
    shorts[rng.random((bq, m)) < 0.2] = n        # sentinel slots
    shorts[:nv, 0] = q_ids[:nv]                  # self pairs
    shorts[3] = n                                # a row with no candidates
    ku = tcl._bucket(min(bq * m, n) + 1)
    want_s, want_i = _padded_rerank_block(rt, src, norms, counts, q_ids,
                                          shorts, ku=ku, k=k,
                                          measure=measure)
    got_s, got_i = tcl._fused_rerank_block(
        src, norms, counts, q_ids[:nv], shorts[:nv], k=k, measure=measure,
        beta=None, use_kernel=False)
    assert torch.equal(got_i, want_i[:nv])
    assert torch.equal(got_s.view(torch.int32), want_s[:nv].view(torch.int32))
    assert (got_i[3] == -1).all()


@pytest.mark.parametrize("measure", ("cosine", "pcc"))
def test_fused_query_reranks_int8_rows_of_real_blocks(measure, monkeypatch):
    """Integer ratings: the fused rerank gets the int8 gather source and
    only its block's real rows (the pool branch's one tall block of 256
    rows holds the 150 users), and the query still equals the
    reference's."""
    r, rt, means, jix, tix = _carried(6, 150, 48)
    seen = []
    orig = tcl._fused_rerank_block

    def spy(r_gather, norms, counts, q_ids, shorts, **kw):
        seen.append((r_gather.dtype, q_ids.shape[0], shorts.shape[0]))
        return orig(r_gather, norms, counts, q_ids, shorts, **kw)

    monkeypatch.setattr(tcl, "_fused_rerank_block", spy)
    _compare_carried(f"index.carried.int8_rows.{measure}", jix, tix, r, rt,
                     means, monkeypatch, k=6, measure=measure)
    assert seen == [(torch.int8, 150, 150)]


# -- refold -------------------------------------------------------------------

def _deltas(rng, u, d, rounds=3, n=5):
    for _ in range(rounds):
        us = np.sort(rng.choice(u, n, replace=False)).astype(np.int32)
        yield (us, rng.integers(0, d, n).astype(np.int32),
               rng.integers(0, 6, n).astype(np.float32))


def _apply(r, us, its, vals):
    r = r.copy()
    r[us, its] = vals
    return r


def test_refold_keeps_index_consistent():
    r, rt, means = _data(6, 128, 48)
    ix = ClusteredIndex(IndexConfig(n_clusters=12, seed=0, features="raw",
                                    project_dim=16)).fit(rt, means)
    rng = np.random.default_rng(0)
    for version, (us, its, vals) in enumerate(_deltas(rng, 128, 48), 1):
        r = _apply(r, us, its, vals)
        rt = torch.from_numpy(r)
        means = sim.user_stats(rt)[2]
        st = ix.refold(rt, means, np.unique(us), version=version)
        assert st.n_touched == len(np.unique(us))
        assert ix.check_consistent(rt, means)
    s, i = ix.query(rt, means, k=6, measure="cosine")
    full = sim.pairwise_similarity(rt, rt, measure="cosine")
    for row in range(0, 128, 17):
        for col in range(6):
            if i[row, col] >= 0:
                assert s[row, col] == full[row, i[row, col]]


def test_refold_matches_reference_on_carried_state():
    r, rt, means, jix, tix = _carried(7, 160, 48, n_clusters=10,
                                      project_dim=16)
    rng = np.random.default_rng(1)
    for version, (us, its, vals) in enumerate(_deltas(rng, 160, 48), 1):
        r = _apply(r, us, its, vals)
        rt = torch.from_numpy(r)
        means = sim.user_stats(rt)[2]
        rj = jnp.asarray(r)
        jst = jix.refold(rj, jsim.user_stats(rj)[2], np.unique(us),
                         version=version)
        tst = tix.refold(rt, means, np.unique(us), version=version)
        assert (tst.n_changed_clusters, tst.n_full_rows) == \
            (jst.n_changed_clusters, jst.n_full_rows)
        assert_parity(f"index.refold.round{version}.spill_ids",
                      tix.spill_ids, jix.spill_ids)
        assert_parity(f"index.refold.round{version}.spill_dist",
                      tix.spill_dist, jix.spill_dist, atol=1e-5)
        assert_parity(f"index.refold.round{version}.centroids",
                      tix.centroids, jix.centroids, atol=1e-6)
        np.testing.assert_array_equal(tix._counts, jix._counts)


def test_fresh_fit_close_to_reference():
    """A cold fit of both packages from the same seed: same proxies to
    float rounding, the same clusters and spill lists."""
    r, rt, means = _data(8, 200, 60)
    cfg = dict(n_clusters=10, seed=0, project_dim=24, use_kernel=False,
               query_mode="fused")
    rj = jnp.asarray(r)
    jix = JaxIndex(JaxConfig(**cfg)).fit(rj, jsim.user_stats(rj)[2])
    tix = ClusteredIndex(IndexConfig(**cfg)).fit(rt, means)
    assert_parity("index.fit.proxies", tix.proxies, jix.proxies, atol=1e-5)
    assert_parity("index.fit.centroids", tix.centroids, jix.centroids,
                  atol=1e-5)
    assert_parity("index.fit.spill_ids", tix.spill_ids, jix.spill_ids)
    assert (tix.n_clusters, tix.n_probe) == (jix.n_clusters, jix.n_probe)


# -- state, stats, validation -------------------------------------------------

def test_state_round_trip():
    r, rt, means = _data(9, 150, 40)
    ix = ClusteredIndex(IndexConfig(n_clusters=9, project_dim=12,
                                    rerank_frac=0.2)).fit(rt, means)
    s1, i1 = ix.query(rt, means, k=5, measure="jaccard")
    tree = ix.state()
    assert set(tree) == set(ClusteredIndex.state_template())
    ix2 = ClusteredIndex(ix.cfg).load_state(tree)
    s2, i2 = ix2.query(rt, means, k=5, measure="jaccard")
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    np.testing.assert_array_equal(ix2.member_counts(), ix.member_counts())
    assert ix2.check_consistent(rt, means)


def test_query_stats_partition_and_fractions():
    r, rt, means = _data(10, 120, 40)
    ix = ClusteredIndex(IndexConfig(n_clusters=8, project_dim=12,
                                    rerank_frac=0.25, query_mode="fused")
                        ).fit(rt, means)
    ix.query(rt, means, k=4, measure="cosine")
    st = ix.last_query
    assert st.seconds_total == st.seconds_shortlist + st.seconds_rerank
    assert st.seconds_rerank > 0.0
    assert st.query_mode == "fused" and st.rerank_mode == "fused"
    assert st.scan_gate == "sym:off:fused"
    assert 0 < st.rerank_fraction <= st.probed_fraction


def test_config_validation():
    r, rt, means = _data(11, 16, 8)
    with pytest.raises(ValueError):
        ClusteredIndex(IndexConfig(features="whitened"))
    with pytest.raises(ValueError):
        ClusteredIndex(IndexConfig(spill=0))
    with pytest.raises(ValueError, match="query_mode"):
        ClusteredIndex(IndexConfig(query_mode="magic"))
    assert ClusteredIndex(IndexConfig(query_mode="staged")
                          )._query_mode() == "staged"
    from types import SimpleNamespace
    meshed = ClusteredIndex(IndexConfig(n_clusters=4),
                            mesh=SimpleNamespace(device_type="cuda"))
    with pytest.raises(ValueError, match="collectives"):
        meshed.fit(rt, means)
    ix = ClusteredIndex(IndexConfig(n_clusters=4))
    with pytest.raises(RuntimeError):
        ix.query(rt, means, k=3)
    # a forced symmetric scan raises under the fused chain and runs under
    # the staged pipeline (the CPU's auto mode)
    forced = ClusteredIndex(IndexConfig(n_clusters=4, project_dim=4,
                                        scan_symmetric=True,
                                        query_mode="fused")).fit(rt, means)
    with pytest.raises(ValueError, match="scan_symmetric"):
        forced.query(rt, means, k=3)
    forced.query_mode_override = "staged"
    forced.query(rt, means, k=3)
    assert forced.last_query.scan_gate.startswith("sym:on")
    auto = ClusteredIndex(dataclasses.replace(IndexConfig(), n_clusters=4))
    assert auto._query_mode() == "staged"
    auto.query_mode_override = "fused"
    assert auto._query_mode() == "fused"
