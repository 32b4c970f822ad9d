"""The user index's staged query pipeline on the port against the JAX
reference's, on the CPU.

* The reference index (``query_mode="staged"``, its XLA twins) is fitted
  on numpy-seeded integer ratings and its ``state()`` carried into the
  port, as ``test_torch_index.py`` does; both then query in the staged
  mode.  Every route — the host ``pool`` scan, the ``cluster``-restricted
  scan, the symmetric-pair scan (auto and forced, with its survivor
  compaction), the block-union scan and the unfiltered blocks, reranked by
  ``gather`` (with its support split) or ``grouped`` — gives the same ids
  and scores bit for bit, and the same ``QueryStats`` strings and counts.
  The one exception is ``pcc_sig`` through the reference's jitted gather
  walk, which is one ulp off its eager form (ROADMAP Queue 3): there the
  scores are held to 2e-5 and the ids may differ only between scores
  within 2e-5.
* The port's staged pipeline (the device scan, through the scan kernel's
  plain version here) equals the port's fused chain bit for bit, on
  every measure.
* After ``update_ratings`` the delta-patched CSR, pair tables and gather
  operand equal a cold rebuild; a broken version chain drops them.
* ``_topm_rows`` is the reference's selection, ties included.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index.clustered as jcl
import repro_torch.index.clustered as tcl
from _torch_parity import assert_parity, int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core import similarity as jsim
from repro.index import ClusteredIndex as JaxIndex
from repro.index import IndexConfig as JaxConfig
from repro_torch.core import predict as pred_mod
from repro_torch.core import similarity as sim
from repro_torch.core.facade import CFEngine
from repro_torch.index import ClusteredIndex, IndexConfig

# fitted indexes: name → (ratings shape, fit config)
FITS = {"A": ((220, 72), dict(n_clusters=12)),
        "B": ((300, 56), dict(n_clusters=20, spill=1, query_block=64)),
        "wide": ((300, 400), dict(n_clusters=12))}
# route → (fit, k, query-time config); each runs the staged pipeline
ROUTES = {
    "pool-gather": ("A", 8, dict(n_probe=12, rerank_mode="gather",
                                 shortlist_scan_mode="pool")),
    "pool-grouped": ("A", 8, dict(n_probe=12, rerank_mode="grouped",
                                  shortlist_scan_mode="pool")),
    "symmetric-auto": ("A", 8, dict(n_probe=12, rerank_frac=0.05,
                                    shortlist_scan_mode="pool")),
    "symmetric-forced": ("A", 8, dict(n_probe=12, scan_symmetric=True)),
    "cluster": ("B", 5, dict(n_probe=2, rerank_frac=0.05,
                             shortlist_scan_mode="cluster")),
    "union": ("B", 5, dict(n_probe=3, rerank_frac=0.05,
                           shortlist_scan_mode="pool")),
    "unfiltered": ("B", 6, dict(n_probe=2, rerank_frac=0.9,
                                shortlist_scan_mode="cluster")),
    "support-split": ("wide", 8, dict(n_probe=12, rerank_frac=0.1,
                                      rerank_mode="gather",
                                      shortlist_scan_mode="pool")),
}
# (route, measure) pairs held against the reference
CASES = [("pool-gather", "cosine"), ("pool-gather", "pcc"),
         ("pool-grouped", "jaccard"), ("pool-grouped", "pcc_sig"),
         ("symmetric-auto", "cosine"), ("symmetric-auto", "pcc_sig"),
         ("symmetric-forced", "pcc"), ("cluster", "jaccard"),
         ("cluster", "pcc_sig"), ("union", "cosine"),
         ("unfiltered", "pcc"), ("support-split", "pcc"),
         ("support-split", "jaccard")]
WANT = {"pool-gather": ("pool", "sym:off:fat-budget", "gather"),
        "pool-grouped": ("pool", "sym:off:fat-budget", "grouped"),
        "symmetric-auto": ("pool", "sym:on:level=1.50", "gather"),
        "symmetric-forced": ("pool", "sym:on:level=1.50", "grouped"),
        "cluster": ("cluster", "sym:off:scan-mode", "gather"),
        "union": ("pool", "sym:off:scan-mode", "gather"),
        "unfiltered": ("cluster", "sym:off:scan-mode", "grouped"),
        "support-split": ("pool", "sym:off:fat-budget", "gather")}


def _base(**kw):
    cfg = dict(n_clusters=12, seed=0, features="raw", rerank_frac=0.3,
               project_dim=24, query_mode="staged", use_kernel=False)
    cfg.update(kw)
    return cfg


@functools.lru_cache(maxsize=None)
def _fitted(fit):
    """The reference index fitted on ``fit``'s ratings and the port's
    index loaded from its ``state()``."""
    (u, d), kw = FITS[fit]
    r = int_ratings(np.random.default_rng(0), u, d, 0.35)
    rj = jnp.asarray(r)
    jix = JaxIndex(JaxConfig(**_base(**kw))).fit(rj, jsim.user_stats(rj)[2])
    tix = ClusteredIndex(IndexConfig(**_base(**kw))).load_state(
        jix.state(), device="cpu")
    return r, jix, tix


def _carried(route):
    """``route``'s fitted pair with its query-time config on both."""
    fit, k, kw = ROUTES[route]
    r, jix, tix = _fitted(fit)
    jix.cfg = dataclasses.replace(JaxConfig(**_base(**FITS[fit][1])), **kw)
    tix.cfg = dataclasses.replace(IndexConfig(**_base(**FITS[fit][1])), **kw)
    return r, jix, tix, k


def _stats(st):
    return (st.scan_mode, st.query_mode, st.scan_gate, st.rerank_mode,
            st.n_probed, st.n_reranked, st.n_queries)


def _assert_ulp_ties(name, t_s, t_i, j_s, j_i, tol=2e-5):
    """Scores within ``tol``; where the ids differ, the port's neighbor at
    that rank has a reference score within ``tol`` of the reference's
    score at that rank (a swap of near-equal scores), or falls off the
    end of the reference's list."""
    assert_parity(f"{name}.scores", t_s, j_s, atol=tol)
    t_i, j_i, j_s = t_i.numpy(), np.asarray(j_i), np.asarray(j_s)
    rows, cols = np.nonzero(t_i != j_i)
    for row, col in zip(rows, cols):
        hit = np.nonzero(j_i[row] == t_i[row, col])[0]
        if len(hit):
            assert abs(j_s[row, hit[0]] - j_s[row, col]) <= tol, (row, col)
        else:
            assert col == t_i.shape[1] - 1, (row, col)
    print(f"PARITY {name}.ids near-tie swaps={len(rows)}")


@pytest.mark.parametrize("route,measure", CASES,
                         ids=[f"{r}-{m}" for r, m in CASES])
def test_staged_matches_reference(route, measure):
    r, jix, tix, k = _carried(route)
    rj, rt = jnp.asarray(r), torch.from_numpy(r)
    j_s, j_i = jix.query(rj, jsim.user_stats(rj)[2], k=k, measure=measure)
    t_s, t_i = tix.query(rt, sim.user_stats(rt)[2], k=k, measure=measure)
    assert _stats(tix.last_query) == _stats(jix.last_query)
    st = tix.last_query
    assert (st.query_mode, st.scan_mode, st.scan_gate, st.rerank_mode) == \
        ("staged",) + WANT[route]
    name = f"staged.{route}.{measure}"
    if measure == "pcc_sig" and st.rerank_mode == "gather":
        _assert_ulp_ties(name, t_s, t_i, j_s, j_i)
        return
    assert_parity(f"{name}.ids", t_i, j_i)
    assert_parity(f"{name}.scores", t_s, j_s)


def test_staged_subset_queries_match_reference():
    """Subset queries (a trailing partial block): the symmetric scan is
    off for a subset, and padding never leaks into real rows."""
    r, jix, tix, k = _carried("pool-grouped")
    sub = np.asarray([0, 7, 63, 64, 199], np.int32)
    rj, rt = jnp.asarray(r), torch.from_numpy(r)
    j_s, j_i = jix.query(rj, jsim.user_stats(rj)[2], sub, k=k,
                         measure="cosine")
    t_s, t_i = tix.query(rt, sim.user_stats(rt)[2], sub, k=k,
                         measure="cosine")
    assert tix.last_query.scan_gate == "sym:off:subset-queries"
    assert_parity("staged.subset.ids", t_i, j_i)
    assert_parity("staged.subset.scores", t_s, j_s)
    assert (t_i.numpy() < 220).all()


def test_symmetric_compaction_is_exact(monkeypatch):
    """A tiny compaction floor folds the survivor panels many times; the
    shortlists still equal the plain pool scan's, row for row."""
    _, _, tix, _ = _carried("symmetric-forced")
    monkeypatch.setattr(tcl, "_SYM_COMPACT_MIN", 1)
    monkeypatch.setattr(tcl, "_SYM_COMPACT_FACTOR", 1)
    p_np = tix._proxies_np()
    m = tix._max_rerank(8)
    sym = tix._scan_symmetric(p_np, m, 64, oversample=1.1)
    ids = np.arange(tix.n_users, dtype=np.int32)
    dense = tix._scan_dense_block(p_np, ids, None, m)
    np.testing.assert_array_equal(np.sort(sym, 1), np.sort(dense, 1))


@pytest.mark.parametrize("measure", ["cosine", "jaccard", "pcc", "pcc_sig"])
def test_port_staged_equals_fused(measure):
    """The staged pipeline on the device scan (the fused chain's own
    scan) and either rerank equals the fused chain bit for bit."""
    r = int_ratings(np.random.default_rng(1), 220, 72, 0.35)
    rt = torch.from_numpy(r)
    means = sim.user_stats(rt)[2]
    cfg = IndexConfig(**_base(n_probe=12, shortlist_scan_mode="kernel",
                              query_mode="fused"))
    ix = ClusteredIndex(cfg).fit(rt, means)
    s_f, i_f = ix.query(rt, means, k=8, measure=measure)
    assert ix.last_query.rerank_mode == "fused"
    for rerank in ("gather", "grouped"):
        ix.cfg = dataclasses.replace(cfg, rerank_mode=rerank)
        ix.query_mode_override = "staged"
        s_s, i_s = ix.query(rt, means, k=8, measure=measure)
        st = ix.last_query
        assert (st.query_mode, st.scan_mode, st.rerank_mode) == \
            ("staged", "kernel", rerank)
        assert torch.equal(i_s, i_f) and torch.equal(s_s, s_f), rerank
        ix.query_mode_override = None


def test_patched_caches_equal_cold_rebuild():
    """CSR, pair tables and gather operand follow the version chain
    through update_ratings and stay equal to cold rebuilds."""
    rng = np.random.default_rng(2)
    r = int_ratings(rng, 128, 64, 0.4)
    eng = CFEngine(r, measure="cosine", k=6, neighbor_mode="approx",
                   device="cpu",
                   index_cfg=IndexConfig(n_clusters=8, seed=0,
                                         features="raw",
                                         refit_reassign_frac=0.0)).fit()
    ix = eng.index
    ix._ratings_csr(eng.ratings)
    ix._item_tables(eng.ratings)
    ix._gather_source(eng.ratings)
    for _ in range(3):
        us = rng.choice(128, 5, replace=False).astype(np.int32)
        eng.update_ratings(us, rng.integers(0, 64, 5).astype(np.int32),
                           rng.integers(0, 6, 5).astype(np.float32))
        assert ix.last_refold.caches_patched >= 3
        assert ix._csr_cache[0] is eng.ratings
        key, op = ix._gather_cache.entry
        assert key is eng.ratings
        cold = ClusteredIndex(IndexConfig(n_clusters=8))
        for got, want in zip(ix._csr_cache[1],
                             cold._ratings_csr(eng.ratings)):
            np.testing.assert_array_equal(got, want)
        cold_op = pred_mod.make_gather_operand(eng.ratings)
        assert torch.equal(op.src, cold_op.src)
        assert op.max_value == cold_op.max_value
        b_got, l_got, t_got = ix._csr_cache[2]
        b_want, l_want, t_want = cold._item_tables(eng.ratings)
        np.testing.assert_array_equal(b_got, b_want)
        np.testing.assert_array_equal(l_got, l_want)
        assert set(t_got) == set(t_want)
        for b in t_want:
            assert torch.equal(t_got[b][0], t_want[b][0])
            assert torch.equal(t_got[b][1], t_want[b][1])
    # a refold off the chain (a version jump) drops the caches
    r2 = eng.ratings.clone()
    r2[1, 1] = 4.0
    st = ix.refold(r2, sim.user_stats(r2)[2], np.array([1], np.int32),
                   version=eng.ratings_version + 5)
    assert st.caches_patched == 0 and ix._csr_cache is None


@pytest.mark.parametrize("m", [0, 1, 7, 40])
def test_topm_rows_matches_reference(m):
    """Heavy ties (values on a 0.25 grid, -inf knockouts), with and
    without a column-id map: the selection sets are the reference's."""
    rng = np.random.default_rng(m)
    sp = (rng.integers(0, 6, (70, 40)) / 4).astype(np.float32)
    sp[rng.random(sp.shape) < 0.1] = -np.inf
    col_ids = rng.permutation(40)
    for cid in (None, col_ids):
        tv, ts = tcl._topm_rows(sp.copy(), m, cid)
        jv, js = jcl._topm_rows(sp.copy(), m, cid)
        np.testing.assert_array_equal(np.sort(ts, 1), np.sort(js, 1))
        np.testing.assert_array_equal(np.sort(tv, 1), np.sort(jv, 1))
    # the threaded argpartition (≥ 64 rows) selects a top-m value set
    sel = tcl._argpartition_rows(sp, max(m, 1))
    np.testing.assert_array_equal(
        np.sort(np.take_along_axis(sp, sel, 1), 1),
        np.sort(sp, 1)[:, sp.shape[1] - max(m, 1):])
