"""Port parity: the blocked, one-shot and candidate-list predictors, the
int8 gather source and its copy-on-write patch, the fused tile predictor
(its plain CPU path) against the Pallas kernel in interpret mode and the
reference oracle (atol 2e-5, as the reference's own tests), and the top-n
unseen contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from repro.core import neighbors as ref_nb
from repro.core import predict as ref_pr
from repro.core import similarity as ref_sim
from repro.kernels.predict import fused_tile_predict as ref_fused_tile
from repro.kernels.ref import tile_predict_ref as ref_tile_predict_ref
from repro_torch.core import predict as pr
from repro_torch.kernels import ref as kref
from repro_torch.kernels.predict import (fused_tile_predict,
                                         tile_predict_plain)


def _setup(seed, u=37, d=100, k=7, measure="pcc"):
    rng = np.random.default_rng(seed)
    r = int_ratings(rng, u, d)
    s, i = ref_nb.topk_neighbors(jnp.asarray(r), k, measure=measure,
                                 block_size=16)
    s, i = np.array(s), np.array(i)
    i[0, -2:] = -1                      # some empty neighbor slots
    s[0, -2:] = float(ref_nb.NEG_INF)
    return r, s, i


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_forms_match_reference(seed):
    r, s, i = _setup(seed)
    tr, ts, ti = _t(r, s, i)
    want = ref_pr.predict_from_neighbors(jnp.asarray(r), jnp.asarray(s),
                                         jnp.asarray(i))
    one = pr.predict_from_neighbors(tr, ts, ti)
    blk = pr.predict_from_neighbors_blocked(tr, ts, ti, item_block=32)
    kblk = pr.predict_from_neighbors_blocked(tr, ts, ti, item_block=48,
                                             use_kernel=True)
    assert_parity("predict.one_shot.vs_jax", one, want, atol=2e-5)
    assert_parity("predict.blocked.vs_one_shot", blk, one)
    assert_parity("predict.kernel_path_cpu.vs_one_shot", kblk, one)
    items = torch.arange(100).expand(37, 100)
    full = pr.predict_items(tr, ts, ti, items, item_block=32)
    assert_parity("predict_items.full.vs_blocked", full, blk)
    ref_items = ref_pr.predict_items(jnp.asarray(r), jnp.asarray(s),
                                     jnp.asarray(i), jnp.asarray(items),
                                     item_block=32)
    assert_parity("predict_items.vs_jax", full, ref_items, atol=2e-5)


def test_predict_subset_and_dense_oracle():
    r, s, i = _setup(2, u=24, d=50, k=5)
    tr, ts, ti = _t(r, s, i)
    users = torch.tensor([3, 0, 11])
    means = pr.user_means(tr)
    got = pr.predict_from_neighbors_blocked(
        tr, ts[users], ti[users], means=means, query_means=means[users],
        item_block=16)
    full = pr.predict_from_neighbors(tr, ts, ti)
    assert_parity("predict.subset.vs_full_rows", got, full[users])
    with pytest.raises(ValueError, match="query_means"):
        pr.predict_from_neighbors(tr, ts[users], ti[users])
    wmat = ref_nb.neighbor_weight_matrix(jnp.asarray(s), jnp.asarray(i), 24)
    want = ref_pr.predict_dense(jnp.asarray(r), wmat)
    dense = pr.predict_dense(tr, torch.from_numpy(np.array(wmat)))
    assert_parity("predict_dense.vs_jax", dense, want, atol=2e-5)
    assert_parity("predict_dense.vs_gather", dense, full, atol=2e-5)


@pytest.mark.parametrize("k,t_lo,t_hi", [(1, 0, 100), (7, 13, 77),
                                         (12, 50, 51)])
def test_fused_tile_predict_plain_vs_pallas_interpret(k, t_lo, t_hi):
    r, s, i = _setup(3, k=k)
    safe = np.where(i >= 0, i, 0)
    w = np.where((s > 0) & (i >= 0), s, 0.0).astype(np.float32)
    means = np.asarray(ref_sim.user_means(jnp.asarray(r)))
    nbm = means[safe]
    nbr = r[safe][:, :, t_lo:t_hi]
    want = ref_fused_tile(jnp.asarray(nbr), jnp.asarray(w),
                          jnp.asarray(nbm), jnp.asarray(means), bm=16,
                          bt=64, interpret=True)
    oracle = ref_tile_predict_ref(jnp.asarray(nbr), jnp.asarray(w),
                                  jnp.asarray(nbm), jnp.asarray(means))
    tag = f"fused_tile_predict.k{k}.[{t_lo},{t_hi})"
    for src in (r, r.astype(np.int8)):
        tsrc, tids, tw, tnbm, tq = _t(src, safe.astype(np.int32), w, nbm,
                                      means)
        got = fused_tile_predict(tsrc, tids, tw, tnbm, tq, t_lo, t_hi)
        assert_parity(tag + f".{src.dtype}.vs_pallas", got, want, atol=2e-5)
        assert_parity(tag + f".{src.dtype}.vs_ref", got, oracle, atol=2e-5)
        port_oracle = kref.tile_predict_ref(torch.from_numpy(nbr), tw, tnbm,
                                            tq)
        assert_parity(tag + f".{src.dtype}.port_ref", got, port_oracle)


def test_fused_tile_predict_wrapper_contract():
    src = torch.zeros(5, 9, dtype=torch.int8)
    ids = torch.zeros(3, 2, dtype=torch.int32)
    w = torch.zeros(3, 2)
    q = torch.full((3,), 2.5)
    out = tile_predict_plain(src, ids, w, w, q, 0, 9)
    assert torch.equal(out, torch.full((3, 9), 2.5))
    with pytest.raises(ValueError, match="item range"):
        fused_tile_predict(src, ids, w, w, q, 4, 4)
    with pytest.raises(ValueError):
        fused_tile_predict(src, ids, w, w, q[:2], 0, 9)
    # CPU: the plain version on either source dtype, no launch and no
    # route counted; the route names are the card's two
    assert tuple(fused_tile_predict.routes) == ("int8", "f32")
    before = (fused_tile_predict.launches, dict(fused_tile_predict.routes))
    r = torch.from_numpy(int_ratings(np.random.default_rng(8), 5, 9))
    wr, nbm = torch.full((3, 2), 0.5), torch.full((3, 2), 2.75)
    outs = [fused_tile_predict(r.to(dt), ids + 1, wr, nbm, q, 3, 8)
            for dt in (torch.int8, torch.float32)]
    assert_parity("fused_tile_predict.cpu.int8_vs_f32", outs[0], outs[1])
    assert outs[0].shape == (3, 5)
    assert (fused_tile_predict.launches,
            dict(fused_tile_predict.routes)) == before


@pytest.mark.parametrize("item_block", [7, 32, 100, 512])
def test_blocked_kernel_path_on_cpu_tiles_like_plain(item_block):
    """``use_kernel=True`` on CPU tensors tiles the items by
    ``item_block`` through the gathered tile, no launch: bit for bit the
    ``use_kernel=False`` form (int8 and f32 sources, a block past I), and
    the reference's blocked predict within the 1-ulp tolerance of
    ``test_predict_forms_match_reference``."""
    r, s, i = _setup(7)
    tr, ts, ti = _t(r, s, i)
    want = ref_pr.predict_from_neighbors_blocked(
        jnp.asarray(r), jnp.asarray(s), jnp.asarray(i),
        item_block=item_block)
    plain = pr.predict_from_neighbors_blocked(tr, ts, ti,
                                              item_block=item_block)
    before = (fused_tile_predict.launches, dict(fused_tile_predict.routes))
    for src in (None, pr.make_gather_source(tr)):
        got = pr.predict_from_neighbors_blocked(
            tr, ts, ti, item_block=item_block, gather_src=src,
            use_kernel=True)
        tag = f"predict.blocked{item_block}.kernel_cpu"
        assert_parity(tag + ".vs_plain", got, plain)
        assert_parity(tag + ".vs_jax", got, want, atol=2e-5)
    assert (fused_tile_predict.launches,
            dict(fused_tile_predict.routes)) == before


def test_gather_source_int8_and_copy_on_write_patch():
    rng = np.random.default_rng(4)
    r = torch.from_numpy(int_ratings(rng, 20, 15))
    src = pr.make_gather_source(r)
    assert src.dtype == torch.int8 and torch.equal(src.float(), r)
    want_ref = ref_pr.make_gather_source(jnp.asarray(r.numpy()))
    assert_parity("make_gather_source", src, want_ref)
    r2 = r.clone()
    r2[3, 4] = 5.0
    r2[7] = 0.0
    touched = torch.tensor([3, 7, 20, 20])           # padded with U
    before = src.clone()
    patched = pr.patch_gather_source(src, r2, touched)
    assert torch.equal(src, before)                  # old operand intact
    assert torch.equal(patched, pr.make_gather_source(r2))
    r3 = r2.clone()
    r3[1, 1] = 2.5                                   # breaks int8 exactness
    rebuilt = pr.patch_gather_source(patched, r3, torch.tensor([1, 20]))
    assert rebuilt.dtype == torch.float32 and torch.equal(rebuilt, r3)
    assert pr.patch_gather_source(r3, r2, touched) is r2


def test_topn_unseen_contract():
    # ties at the cut, a user with fewer unseen items than n, seen items
    pred = torch.tensor([[3.0, 4.0, 4.0, 2.0, 4.0, 1.0],
                         [5.0, 5.0, 5.0, 5.0, 5.0, 5.0],
                         [1.0, 2.0, 3.0, 4.0, 5.0, 5.0]])
    seen = torch.tensor([[False, False, True, False, False, False],
                         [True, True, True, True, False, True],
                         [False] * 6])
    s, i = pr.topn_unseen(pred, seen, 3)
    assert i.tolist() == [[1, 4, 0], [4, -1, -1], [4, 5, 3]]
    assert s[1, 1] == float("-inf")
    r_s, r_i = ref_pr.topn_unseen(jnp.asarray(pred.numpy()),
                                  jnp.asarray(seen.numpy()), 3)
    assert_parity("topn_unseen.ids", i, r_i)
    assert_parity("topn_unseen.scores", s, r_s)
    for u in range(3):
        row = i[u][i[u] >= 0]
        assert not seen[u, row].any()


@pytest.mark.parametrize("seed", [5, 6])
def test_topn_unseen_matches_reference_with_ties(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(1, 4, (16, 40)).astype(np.float32)   # heavy ties
    seen = rng.random((16, 40)) < 0.5
    seen[0, :38] = True                                       # 2 unseen
    s, i = pr.topn_unseen(torch.from_numpy(pred), torch.from_numpy(seen), 5)
    r_s, r_i = ref_pr.topn_unseen(jnp.asarray(pred), jnp.asarray(seen), 5)
    assert_parity("topn_unseen.ties.ids", i, r_i)
    assert_parity("topn_unseen.ties.scores", s, r_s)
