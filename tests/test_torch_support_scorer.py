"""Port parity: the item index's host support scorer
(``ItemIndexConfig(shortlist_mode="support")``) against the reference's,
on the reference's own case (``tests/test_support_kernel.py``: 180 × 140,
cosine, k 8, 8 item clusters, shortlist 32, n 5).

Both packages run the same numpy and scipy calls on the same arrays, so
the shortlists that reach the exact rerank are equal bit for bit; the
recommended ids are then equal bit for bit, and the scores within 1e-6
(the reference's jitted predictor is one ulp off its eager form, ROADMAP
Queue 3).  Within the port the support scorer equals the kernel scorer
bit for bit, ids and scores — after ``fit`` and after an oracle-checked
``update_ratings`` that splices the CSR's rows — also with several score
chunks going through the two-thread pipeline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index.item_index as jii
import repro_torch.index.item_index as tii
from _torch_parity import assert_parity, to_np
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core.facade import CFEngine as RefEngine
from repro.index import ItemClusteredIndex as RefItemIndex
from repro.index import ItemIndexConfig as RefCfg
from repro_torch.core.facade import CFEngine
from repro_torch.index import ItemClusteredIndex, ItemIndexConfig

CASE = dict(n_clusters=8, seed=0, shortlist=32)
DELTA = ([3, 3, 100, 150], [5, 6, 7, 139], [4.0, 0.0, 2.0, 5.0])


@pytest.fixture(scope="module")
def ratings():
    rng = np.random.default_rng(0)
    return (rng.integers(1, 6, (180, 140))
            * (rng.random((180, 140)) < 0.3)).astype(np.float32)


def _port(r, mode, **cfg):
    return CFEngine(r, measure="cosine", k=8, recommend_mode="approx",
                    device="cpu", item_index_cfg=ItemIndexConfig(
                        shortlist_mode=mode, **{**CASE, **cfg})).fit()


def _ref(r, **cfg):
    return RefEngine(jnp.asarray(r), measure="cosine", k=8,
                     recommend_mode="approx", item_index_cfg=RefCfg(
                         shortlist_mode="support", **{**CASE, **cfg})).fit()


def _capture(monkeypatch, module):
    """{query id: shortlist} of every row the rerank consumes."""
    got = {}
    orig = module._rerank_items

    def grab(ratings, gather_src, nb_scores, nb_idx, means, q_means, q_ids,
             cand_items, **kw):
        for q, row in zip(to_np(q_ids), to_np(cand_items)):
            got[int(q)] = row.copy()
        return orig(ratings, gather_src, nb_scores, nb_idx, means, q_means,
                    q_ids, cand_items, **kw)

    monkeypatch.setattr(module, "_rerank_items", grab)
    return got


def _assert_case(name, eng, ref, monkeypatch):
    """Shortlists bitwise the reference's; recommendations bitwise the
    port's kernel scorer's (given as ``eng``'s ``kernel`` twin) and the
    reference's ids, scores within 1e-6."""
    p_short = _capture(monkeypatch, tii)
    r_short = _capture(monkeypatch, jii)
    s, i = eng.recommend(n=5)
    j_s, j_i = ref.recommend(n=5)
    n_users = eng.n_users
    assert sorted(p_short) == list(range(n_users))
    for u in range(n_users):
        np.testing.assert_array_equal(p_short[u], r_short[u],
                                      err_msg=f"{name} shortlist {u}")
    assert_parity(f"{name}.ids", i, j_i)
    assert_parity(f"{name}.scores", s, j_s, atol=1e-6)
    return s, i


def test_support_matches_reference_and_kernel(ratings, monkeypatch):
    eng = _port(ratings, "support")
    assert eng.item_index._shortlist_mode() == "support"
    s, i = _assert_case("support.fit", eng, _ref(ratings), monkeypatch)
    k_s, k_i = _port(ratings, "kernel").recommend(n=5)
    assert torch.equal(s, k_s) and torch.equal(i, k_i)
    st = eng.item_index.last_recommend
    assert st.n_probed == 180 * 140 and st.rerank_fraction <= 32 / 140


def test_support_after_update_splices_the_csr(ratings, monkeypatch):
    eng, ker, ref = (_port(ratings, "support"), _port(ratings, "kernel"),
                     _ref(ratings))
    eng.recommend(n=5)                        # the table is live
    for e in (eng, ker, ref):
        st = e.update_ratings(*DELTA, oracle_check=True)
        assert st.oracle_ok is True
    # the CSR was spliced, not rebuilt, and equals a cold build
    assert eng.item_index.last_refold.caches_patched >= 2
    cache = eng.item_index._support_cache
    assert cache is not None and cache[0] is eng.ratings
    cold = tii._support_csr(eng.ratings.numpy(), eng.means.numpy())
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(cache[1], a),
                                      getattr(cold, a))
    s, i = _assert_case("support.update", eng, ref, monkeypatch)
    k_s, k_i = ker.recommend(n=5)
    assert torch.equal(s, k_s) and torch.equal(i, k_i)


def test_pipeline_over_several_chunks(ratings, monkeypatch):
    """score_block 48 → four chunks, the last one short, each halved over
    the two host threads only when it has ≥ 64 rows (here: never at 48,
    so also a chunk of 100 rows); rerank batches of 20."""
    for sb in (48, 100):
        cfg = dict(score_block=sb, rerank_block=20)
        eng = _port(ratings, "support", **cfg)
        s, i = _assert_case(f"support.chunks{sb}", eng, _ref(ratings, **cfg),
                            monkeypatch)
        k_s, k_i = _port(ratings, "kernel").recommend(n=5)
        assert torch.equal(s, k_s) and torch.equal(i, k_i)
        sub = np.array([7, 3, 150, 3])
        s2, i2 = eng.recommend(sub, n=5)
        assert torch.equal(s2, s[sub]) and torch.equal(i2, i[sub])


def test_support_table_equals_reference(ratings):
    means = CFEngine(ratings, k=8, device="cpu").fit().means.numpy()
    got = tii._support_csr(ratings, means)
    want = jii._support_csr(ratings, means)
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    np.testing.assert_array_equal(tii._support_rows(ratings[:9], means[:9]),
                                  jii._support_rows(ratings[:9], means[:9]))


@pytest.mark.parametrize("m", [1, 7, 30, 60])
def test_select_shortlist_tie_repair_equals_reference(m):
    """Rows full of ties at the cut (the clip and fallback groups) and
    rows with fewer finite scores than m: the canonical selection equals
    the reference's bit for bit, for single rows and blocks of ≥ 64."""
    rng = np.random.default_rng(m)
    num = rng.choice(np.array([1.0, 2.5, 3.0, 5.0, -np.inf], np.float32),
                     size=(70, 60), p=[0.2, 0.2, 0.2, 0.3, 0.1])
    num[5, :] = -np.inf
    num[6, 3:] = -np.inf
    port = ItemClusteredIndex(ItemIndexConfig())
    ref = RefItemIndex(RefCfg())
    port.n_rows = ref.n_rows = 60
    for rows in (num[:1], num[:9], num):
        np.testing.assert_array_equal(
            port._select_shortlist(rows.copy(), m),
            ref._select_shortlist(rows.copy(), m))


def test_load_state_drops_the_table(ratings):
    eng = _port(ratings, "support")
    want = eng.recommend(n=5)
    assert eng.item_index._support_cache is not None
    fresh = CFEngine(np.zeros((1, 1), np.float32), measure="cosine", k=8,
                     recommend_mode="approx", device="cpu",
                     item_index_cfg=ItemIndexConfig(shortlist_mode="support",
                                                    **CASE))
    fresh.load_state(eng.state())
    assert fresh.item_index._support_cache is None
    got = fresh.recommend(n=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
