"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a); the ``cuda``
fixture skips them, with a reason, when ``torch.cuda.is_available()`` is
false.  On the card:  ``PYTHONPATH=src python -m pytest -q
tests/test_torch_kernels_cuda.py``.  Integer ratings make every Gram sum
exact, and both kernels keep their plain version's operation order, so
the comparisons are bitwise.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, int_ratings
from repro_torch.core import predict as pr
from repro_torch.core.facade import CFEngine
from repro_torch.kernels.predict import (fused_tile_predict,
                                         tile_predict_plain)
from repro_torch.kernels.similarity import (fused_similarity,
                                            similarity_plain)
from repro_torch.serving.engine import BatchingServer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


SIM_MEASURES = ("jaccard", "cosine", "pcc", "pcc_sig", "all")


def _similarity_bitwise(name, ra, rb, route, **kw):
    """Every measure through the kernel on ``route`` against the plain
    version, bit for bit; one launch and one route count each."""
    for measure in SIM_MEASURES:
        before = dict(fused_similarity.routes)
        launches = fused_similarity.launches
        got = fused_similarity(ra, rb, measure=measure, beta=7.3, **kw)
        assert fused_similarity.launches == launches + 1
        assert fused_similarity.routes == {
            k: v + (k == route) for k, v in before.items()}
        want = similarity_plain(ra, rb, measure=measure, beta=7.3)
        torch.cuda.synchronize()
        if measure != "all":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                f"{name}.{measure}"


@pytest.mark.parametrize("m,n,d", [(257, 131, 3952), (1, 33, 17),
                                   (64, 64, 32), (70, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_similarity_kernel_matches_plain(cuda, m, n, d, dtype):
    """Both routes on 1..5 ratings: f32 → "simt", int8 → "imma" (with
    the ratings' bound as max_value: 128² · 3952 leaves the domain)."""
    rng = np.random.default_rng(m + n + d)
    ra = torch.from_numpy(int_ratings(rng, m, d)).to(cuda, dtype)
    rb = torch.from_numpy(int_ratings(rng, n, d)).to(cuda, dtype)
    route, kw = (("imma", {"max_value": 5}) if dtype == torch.int8
                 else ("simt", {}))
    _similarity_bitwise(f"cuda.similarity.{m}x{n}x{d}.{route}", ra, rb,
                        route, **kw)


@pytest.mark.parametrize("m,n,d", [(129, 65, 3952), (17, 200, 100),
                                   (300, 129, 4000), (5, 1, 3)])
@pytest.mark.parametrize("max_value", [15, 16])
def test_similarity_imma_route_ragged(cuda, m, n, d, max_value):
    """The int8 route at m, n off its 128 / 64 tiles, D off 16 (the
    wrapper pads), signed values up to ±max_value: 15 keeps each square
    in one u8 plane, 16 adds the hi plane."""
    rng = np.random.default_rng(m * n + d + max_value)

    def block(rows):
        x = rng.integers(-max_value, max_value + 1, (rows, d))
        x = x * (rng.random((rows, d)) < 0.6)
        x[0, :] = max_value                      # a full row at the bound
        return torch.from_numpy(x.astype(np.float32)).to(cuda)

    ra, rb = block(m), block(n)
    ra[-1] = 0.0                                 # an all-zero row
    _similarity_bitwise(f"cuda.similarity.imma.{m}x{n}x{d}.v{max_value}",
                        ra.to(torch.int8), rb.to(torch.int8), "imma",
                        max_value=max_value)


def test_similarity_imma_domain_edge(cuda):
    """max_value² · D = 2^24 exactly is inside the int8 route's domain
    (a dot of two all-64 rows is 2^24, still exact in f32); one item
    more, or no max_value, raises."""
    rng = np.random.default_rng(9)
    d = 4096
    x = rng.integers(-64, 65, (40, d)) * (rng.random((40, d)) < 0.5)
    x[0], x[1] = 64, 64
    x[2] = -64
    ra = torch.from_numpy(x.astype(np.float32)).to(cuda)
    _similarity_bitwise("cuda.similarity.imma.edge", ra.to(torch.int8),
                        ra[:23].contiguous().to(torch.int8), "imma",
                        max_value=64)
    dot = fused_similarity(ra[:2].to(torch.int8), ra[:2].to(torch.int8),
                           measure="cosine", max_value=64)
    assert bool((dot == 1.0).all())
    big = torch.zeros(3, d + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="exact domain"):
        fused_similarity(big, big, measure="pcc", max_value=64)
    with pytest.raises(ValueError, match="exact domain"):
        fused_similarity(ra.to(torch.int8), ra.to(torch.int8))


@pytest.mark.parametrize("max_value,planted", [(15, 16), (15, -16), (5, 6),
                                               (5, -6), (126, 127),
                                               (127, -128)])
@pytest.mark.parametrize("measure", ["pcc", "cosine"])
def test_similarity_imma_checks_max_value(cuda, max_value, planted, measure):
    """A max_value below the data is caught on the device: the wrapper
    raises, or counts the offending rows of both blocks into the caller's
    n_bad without waiting; values at ±max_value count nothing."""
    rng = np.random.default_rng(max_value + abs(planted))
    x = rng.integers(-max_value, max_value + 1, (70, 200))
    ra = torch.from_numpy(x).to(cuda, torch.int8)
    rb = ra[:33].clone()
    n_bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    fused_similarity(ra, rb, measure=measure, max_value=max_value,
                     n_bad=n_bad)
    assert int(n_bad.item()) == 0
    ra[3, 150] = planted
    ra[69, 0] = planted
    rb[32, 199] = planted
    fused_similarity(ra, rb, measure=measure, max_value=max_value,
                     n_bad=n_bad)
    assert int(n_bad.item()) == 3
    with pytest.raises(ValueError, match="past max_value"):
        fused_similarity(ra, rb, measure=measure, max_value=max_value)
    with pytest.raises(ValueError, match="past max_value"):
        fused_similarity(rb[:1].contiguous(), rb, measure=measure,
                         max_value=max_value)
    fused_similarity(ra, rb, measure=measure, max_value=abs(planted))
    _similarity_bitwise(f"cuda.similarity.imma.bound{planted}", ra, rb,
                        "imma", max_value=abs(planted))


def test_similarity_kernel_rejects_bad_inputs(cuda):
    a = torch.ones(4, 8, device=cuda)
    with pytest.raises(TypeError):
        fused_similarity(a.double(), a.double())
    with pytest.raises(TypeError):               # one route per launch
        fused_similarity(a, a.to(torch.int8))
    with pytest.raises(ValueError):
        fused_similarity(a.T, a.T)               # not contiguous
    with pytest.raises(ValueError):
        fused_similarity(a, a.cpu())


@pytest.mark.parametrize("k", [1, 7, 40, 65, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_tile_predict_kernel_matches_plain(cuda, k, dtype):
    """Both routes (f32 → "f32", int8 → "int8"), k past one 32- and one
    64-neighbor chunk, 16-aligned ranges (the int8 route's 16-byte loads)
    and ranges starting at 3 or 13 or with widths off 16 (its byte loads),
    a zero-weight slot, ids outside [0, U) (they contribute nothing: the
    plain version with that slot at id 0 and weight 0) and, on the int8
    route, negative bytes (unrated, as r ≤ 0 is); bit for bit."""
    rng = np.random.default_rng(k)
    u, items, m = 300, 700, 37
    r = torch.from_numpy(int_ratings(rng, u, items)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, u, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.random((m, k)).astype(np.float32))
    w[:, -1] = 0.0                                # an empty (-1) slot
    ids, w = ids.to(cuda), w.to(cuda)
    means = pr.user_means(r)
    nbm = means[ids.long()].contiguous()
    qm = means[:m].contiguous()
    bad = ids.clone()
    bad[::4, k // 2] = u + 5                      # ids outside [0, U)
    bad[1::4, 0] = -3
    w0 = torch.where(bad == ids, w, torch.zeros_like(w)).contiguous()
    src = r.to(dtype)
    if dtype == torch.int8:
        src[5, ::3] = -3                          # negative bytes: unrated
    route = "int8" if dtype == torch.int8 else "f32"
    for lo, hi in ((0, 700), (0, 512), (512, 700), (16, 528), (3, 260),
                   (13, 346), (0, 1), (699, 700)):
        before = dict(fused_tile_predict.routes)
        got = fused_tile_predict(src, ids, w, nbm, qm, lo, hi)
        assert fused_tile_predict.routes == {
            key: v + (key == route) for key, v in before.items()}
        want = tile_predict_plain(src, ids, w, nbm, qm, lo, hi)
        got_bad = fused_tile_predict(src, bad, w, nbm, qm, lo, hi)
        want_bad = tile_predict_plain(src, ids, w0, nbm, qm, lo, hi)
        torch.cuda.synchronize()
        assert_parity(f"cuda.tile_predict.{route}.k{k}.[{lo},{hi})", got,
                      want)
        assert_parity(f"cuda.tile_predict.{route}.k{k}.[{lo},{hi}).bad_ids",
                      got_bad, want_bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_blocked_predict_one_launch_on_card(cuda, dtype):
    """``predict_from_neighbors_blocked(use_kernel=True)`` on the card is
    one launch over every item, whatever ``item_block``, bit for bit the
    plain tiled form; the f32 source takes the "f32" route."""
    rng = np.random.default_rng(9)
    r = torch.from_numpy(int_ratings(rng, 200, 1000)).to(cuda)
    eng = CFEngine(r, k=20, block_size=128, device="cuda").fit()
    src = r.to(dtype)
    route = "int8" if dtype == torch.int8 else "f32"
    for item_block in (64, 512, 4096):
        launches = fused_tile_predict.launches
        before = dict(fused_tile_predict.routes)
        got = pr.predict_from_neighbors_blocked(
            r, eng.scores, eng.idx, means=eng.means, item_block=item_block,
            gather_src=src, use_kernel=True)
        assert fused_tile_predict.launches == launches + 1
        assert fused_tile_predict.routes[route] == before[route] + 1
        want = pr.predict_from_neighbors_blocked(
            r, eng.scores, eng.idx, means=eng.means, item_block=item_block,
            gather_src=src)
        torch.cuda.synchronize()
        assert_parity(f"cuda.blocked_predict.{route}.ib{item_block}", got,
                      want)


def test_engine_backends_agree_on_card(cuda):
    rng = np.random.default_rng(3)
    r = int_ratings(rng, 300, 200)
    seq = CFEngine(r, k=12, block_size=128, backend="sequential",
                   device="cuda").fit()
    before = dict(fused_similarity.routes)
    ker = CFEngine(r, k=12, block_size=128, backend="kernel",
                   device="cuda").fit()
    # integer ratings: every candidate block on the int8 route
    assert fused_similarity.routes["imma"] == before["imma"] + 3
    assert fused_similarity.routes["simt"] == before["simt"]
    assert torch.equal(seq.idx, ker.idx)
    assert torch.equal(seq.scores, ker.scores)
    assert torch.equal(seq.recommend(n=10)[1], ker.recommend(n=10)[1])
    cpu = CFEngine(r, k=12, block_size=128, backend="sequential",
                   device="cpu").fit()
    assert torch.equal(cpu.idx, seq.idx.cpu())
    st = ker.update_ratings([4, 4, 9], [1, 2, 3], [5.0, 0.0, 2.0],
                            oracle_check=True)
    assert st.oracle_ok
    with pytest.raises(ValueError, match="engine lives on"):
        BatchingServer(cpu, device="cuda")


# -- the approximate index's kernels (centroid distances, scan/select
#    top-M, co-rated rerank) against their plain versions -------------------

def _unit(rng, n, d, cuda):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("m,n,d", [(257, 78, 256), (1, 33, 17),
                                   (6040, 78, 256), (70, 5, 1)])
def test_centroid_kernel_matches_plain(cuda, m, n, d):
    from repro_torch.kernels.cluster import (centroid_distances_plain,
                                             fused_centroid_distances)
    rng = np.random.default_rng(m + n + d)
    x, c = _unit(rng, m, d, cuda), _unit(rng, n, d, cuda)
    before = fused_centroid_distances.launches
    got = fused_centroid_distances(x, c)
    assert fused_centroid_distances.launches == before + 1
    want = centroid_distances_plain(x, c)
    torch.cuda.synchronize()
    assert_parity(f"cuda.centroid.{m}x{n}x{d}", got, want)
    rows = torch.tensor([0, m - 1, m // 2], device=cuda)
    assert torch.equal(fused_centroid_distances(x[rows].contiguous(), c),
                       got[rows])


@pytest.mark.parametrize("n", [1, 78, 97, 182])
@pytest.mark.parametrize("d", [1, 17, 256, 512])
def test_centroid_kernel_tiles(cuda, n, d):
    """Centroid counts of one tile (1, 78), of two balanced tiles (97,
    182) and widths off 4 (1, 17: plain staging) or of several stages
    (256, 512); bit for bit, and a row subset bit for bit the full call."""
    from repro_torch.kernels.cluster import (centroid_distances_plain,
                                             fused_centroid_distances)
    rng = np.random.default_rng(n * 1000 + d)
    x, c = _unit(rng, 301, d, cuda), _unit(rng, n, d, cuda)
    got = fused_centroid_distances(x, c)
    want = centroid_distances_plain(x, c)
    torch.cuda.synchronize()
    assert_parity(f"cuda.centroid.tiles.301x{n}x{d}", got, want)
    rows = torch.arange(3, 301, 5, device=cuda)
    assert torch.equal(fused_centroid_distances(x[rows].contiguous(), c),
                       got[rows])


@pytest.mark.parametrize("q_n,n,p,m,dup,dead", [
    (130, 257, 33, 17, 1, False), (37, 300, 24, 17, 1, False),
    (21, 240, 12, 25, 8, False), (9, 40, 8, 999, 1, False),
    (300, 6040, 256, 906, 1, False), (64, 4000, 512, 656, 1, False),
    (2048, 6040, 256, 906, 1, False),       # the approx path's block
    (2048, 32768, 512, 655, 1, False),      # the U = 32768 index's block
    (70, 900, 64, 300, 30, False),          # 30 copies of each proxy: ties
    (40, 500, 16, 50, 1, True),             # rows of −inf scores
    (33, 60, 16, 60, 1, False),             # m = N
    (33, 61, 13, 200, 1, False),            # m > N, P not a multiple of 4
])
def test_scan_kernel_matches_plain(cuda, q_n, n, p, m, dup, dead):
    """Ids equal and values equal bit for bit; one launch counted for
    the two on the card (scores, then the radix select)."""
    from repro_torch.kernels.select import fused_scan_topm, scan_topm_plain
    rng = np.random.default_rng(q_n + n + p)
    q = _unit(rng, q_n, p, cuda)
    prox = _unit(rng, n // dup, p, cuda).repeat_interleave(dup, 0)
    prox = prox.contiguous()
    if dead:                                 # −inf · positive = −inf
        q[::3] = float("inf")
        prox = -prox.abs()
    q_ids = torch.arange(q_n, dtype=torch.int32, device=cuda)
    q_ids[::4] = n
    before = fused_scan_topm.launches
    got_v, got_i = fused_scan_topm(q, prox, q_ids, m=m)
    assert fused_scan_topm.launches == before + 1
    want_v, want_i = scan_topm_plain(q, prox, q_ids, min(m, n))
    torch.cuda.synchronize()
    name = f"cuda.scan.{q_n}x{n}x{p}.m{m}.dup{dup}"
    assert_parity(name + ".ids", got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32)), \
        name + ".vals"
    if dead:
        assert bool((got_i[::3] == n).all())


def test_scan_kernel_raises_past_the_select_domain(cuda):
    from repro_torch.kernels.select import SELECT_M_MAX, fused_scan_topm
    rng = np.random.default_rng(3)
    q, prox = _unit(rng, 4, 16, cuda), _unit(rng, SELECT_M_MAX + 10, 16, cuda)
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    before = fused_scan_topm.launches
    with pytest.raises(ValueError, match="domain"):
        fused_scan_topm(q, prox, ids, m=SELECT_M_MAX + 1)
    assert fused_scan_topm.launches == before
    got_v, got_i = fused_scan_topm(q, prox, ids, m=SELECT_M_MAX)
    assert got_i.shape == (4, SELECT_M_MAX)


@pytest.mark.parametrize("q_n,n,m", [(19, 140, 23), (256, 3000, 906),
                                     (40, 513, 128), (7, 30, 64)])
def test_select_kernel_matches_plain(cuda, q_n, n, m):
    from repro_torch.kernels.select import select_topm, select_topm_twin
    rng = np.random.default_rng(n)
    s = rng.integers(-40, 41, (q_n, n)).astype(np.float32) / 8
    s[rng.random(s.shape) < 0.1] = -np.inf
    s[2] = -np.inf                                   # an all -inf row
    s = torch.from_numpy(s).to(cuda)
    q_ids = torch.full((q_n,), -1, dtype=torch.int32, device=cuda)
    q_ids[1] = 5
    got_v, got_i = select_topm(s, q_ids, m=m)
    want_v, want_i = select_topm_twin(s, q_ids, m=m)
    torch.cuda.synchronize()
    assert_parity(f"cuda.select.{q_n}x{n}.m{m}.ids", got_i, want_i)
    assert_parity(f"cuda.select.{q_n}x{n}.m{m}.vals", got_v, want_v)
    assert bool((got_i[2] == n).all())


def _select_bitwise(name, s, q_ids, m):
    """The radix-select kernel against its plain version: ids equal and
    values equal bit for bit (the sign of a zero included); one launch."""
    from repro_torch.kernels.select import select_topm, select_topm_twin
    before = select_topm.launches
    got_v, got_i = select_topm(s, q_ids, m=m)
    assert select_topm.launches == before + 1
    want_v, want_i = select_topm_twin(s, q_ids, m=m)
    torch.cuda.synchronize()
    assert_parity(name + ".ids", got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32)), \
        f"{name}: values differ in their bits"
    return got_v, got_i


@pytest.mark.parametrize("case", ["ties", "signed_zeros", "all_neg_inf",
                                  "m1", "m_eq_L", "m_past_finite"])
def test_select_radix_edge_cases(cuda, case):
    """Ties across the threshold, ±0.0 (equal keys, ties to the lower id,
    each value's sign kept), all −inf rows, m = 1, m = L and m above the
    finite count (the tail is (−inf, L))."""
    rng = np.random.default_rng(len(case))
    q_n, n, m = 9, 300, 40
    s = rng.integers(-3, 4, (q_n, n)).astype(np.float32)
    if case == "ties":
        s[0] = 1.0                                   # one value everywhere
        s[1] = np.minimum(s[1], 1.0)
        s[1, ::2] = 2.0                              # the cut inside a run
    elif case == "signed_zeros":
        s = np.where(rng.random((q_n, n)) < 0.5, -0.0, 0.0).astype(
            np.float32)
        s[:, ::7] = -1.0
        s[3, :5] = 1.0
    elif case == "all_neg_inf":
        s[:] = -np.inf
        s[4, 10] = 0.5
    elif case == "m1":
        m = 1
    elif case == "m_eq_L":
        m = n
        s[rng.random(s.shape) < 0.2] = -np.inf
    else:
        s[rng.random(s.shape) < 0.9] = -np.inf       # ~30 finite a row
        s[5] = np.nan                                # NaN is never taken
        s[5, 3] = 2.0
    st = torch.from_numpy(s).to(cuda)
    q_ids = torch.full((q_n,), -1, dtype=torch.int32, device=cuda)
    q_ids[6] = 7                                     # a knocked-out column
    if case == "m_past_finite":
        from repro_torch.kernels.select import select_topm
        got_v, got_i = select_topm(st, q_ids, m=m)
        torch.cuda.synchronize()
        fin = np.isfinite(s)
        for r in range(q_n):
            c = int(fin[r].sum()) - int(r == 6 and fin[6, 7])
            assert bool((got_i[r, c:] == n).all())
            assert bool(torch.isneginf(got_v[r, c:]).all())
        assert got_i[5, 0].item() == 3 and got_i[5, 1].item() == n
        s[5] = -np.inf                               # the plain sorts NaN
        s[5, 3] = 2.0                                # past −inf; compare
        st = torch.from_numpy(s).to(cuda)            # without it
    got_v, got_i = _select_bitwise(f"cuda.select.radix.{case}", st, q_ids, m)
    if case == "ties":
        assert got_i[0].tolist() == list(range(m))
        assert got_i[1].tolist() == list(range(0, 2 * m, 2))
    if case == "signed_zeros":
        z = got_v[0] == 0
        assert bool(z.any())
        ids = got_i[0][z]
        assert bool((ids[1:] > ids[:-1]).all())      # zeros by ascending id
    if case == "all_neg_inf":
        assert bool((got_i[0] == n).all())
        assert got_i[4, 0].item() == 10 and bool((got_i[4, 1:] == n).all())


@pytest.mark.parametrize("q_n,n,m", [
    (256, 8192, 906),      # the cluster query's select
    (6040, 3952, 512),     # the item index's select
    (3, 40000, 100),       # a row too long for shared memory (streamed)
    (5, 40000, 3000),
])
def test_select_radix_at_path_shapes(cuda, q_n, n, m):
    """Proxy-like scores with −inf padding (the bucketed candidate pool's
    tail) and knockouts, at both path shapes and past the staging limit."""
    rng = np.random.default_rng(q_n + n)
    s = (rng.normal(size=(q_n, n)) / 8).astype(np.float32)
    s = np.round(s * 4096) / 4096                   # exact ties
    s[:, n - n // 7:] = -np.inf
    s[rng.random(s.shape) < 0.05] = -np.inf
    q_ids = torch.from_numpy(rng.integers(-1, n, q_n).astype(np.int32))
    _select_bitwise(f"cuda.select.radix.{q_n}x{n}.m{m}",
                    torch.from_numpy(s).to(cuda), q_ids.to(cuda), m)


@pytest.mark.parametrize("t,e,k", [(8192, 128, 8), (8192, 160, 6)])
def test_router_topk_at_the_router_shapes(cuda, t, e, k):
    """The MoE router's top-k (Qwen3-30B-A3B's 128 experts top-8 and
    DeepSeek-V2's 160 top-6, 8192 tokens) on kernel 5: softmax gates
    rounded to a grid of 2⁻¹² so that many tie, and uniform rows (every
    gate 1/E: experts 0..k-1); ids and values bit for bit the plain
    selection's, one launch a call."""
    from repro_torch.kernels.select import router_topk, select_topm
    rng = np.random.default_rng(t + e)
    logits = torch.from_numpy(rng.normal(0, 1, (t, e)).astype(np.float32))
    probs = torch.softmax(logits, -1)
    probs = torch.round(probs * 4096) / 4096
    probs[::97] = 1.0 / e
    probs = probs.to(cuda)
    before = select_topm.launches
    got_v, got_i = router_topk(probs, k)
    assert select_topm.launches == before + 1
    want_v, want_i = router_topk(probs, k, use_kernel=False)
    torch.cuda.synchronize()
    assert_parity(f"cuda.router_topk.{t}x{e}.k{k}.ids", got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert bool((got_i[::97] == torch.arange(k, device=cuda)).all())
    _select_bitwise(f"cuda.router_select.{t}x{e}.k{k}", probs,
                    torch.full((t,), -1, dtype=torch.int32, device=cuda), k)


def test_select_radix_rejects_past_its_domain(cuda):
    from repro_torch.kernels.select import select_topm
    s = torch.zeros((2, 20000), device=cuda)
    q_ids = torch.full((2,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        select_topm(s, q_ids, m=16385)
    got_v, got_i = select_topm(s, q_ids, m=16384)
    torch.cuda.synchronize()
    assert got_i[0].tolist() == list(range(16384))


def _rerank_case(case, rng, cuda):
    """(query rows, candidate rows, max_value) of one rerank test case."""
    if case == "path":          # int8 × int8 at J = 3952, G, Kc off tiles
        q = int_ratings(rng, 133, 3952)
        c = int_ratings(rng, 141, 3952)
        bound = 5
    elif case == "wide":        # |values| up to 128: the squares' hi halves
        q = rng.integers(-128, 128, (37, 300)) * (rng.random((37, 300)) < .5)
        c = rng.integers(-128, 128, (70, 300)) * (rng.random((70, 300)) < .5)
        q[:, 0], c[:, 0] = 127, -128
        bound = 128
    else:                       # "small", as the f32 cases
        q, c = int_ratings(rng, 70, 300), int_ratings(rng, 130, 300)
        bound = 5
    q, c = np.array(q, np.float32), np.array(c, np.float32)
    q[1] = 0.0                  # all-zero rows on both sides
    c[2] = 0.0
    return (torch.from_numpy(q).to(cuda), torch.from_numpy(c).to(cuda),
            bound)


@pytest.mark.parametrize("measure", ["jaccard", "cosine", "pcc", "pcc_sig"])
@pytest.mark.parametrize("beta", [50.0, 7.3])
@pytest.mark.parametrize("case,dtype", [
    ("small", torch.float32), ("small", torch.int8), ("small", "int8xint8"),
    ("path", torch.float32), ("path", torch.int8), ("path", "int8xint8"),
    ("wide", "int8xint8")])
def test_rerank_kernel_matches_plain(cuda, measure, beta, case, dtype):
    """f32 queries with f32 or int8 candidates (the "simt" route) and
    int8 × int8 (the "imma" route): bit for bit, every measure."""
    from repro_torch.kernels.rerank import (fused_rerank_scores,
                                            rerank_scores_plain)
    rng = np.random.default_rng(11)
    q, c, bound = _rerank_case(case, rng, cuda)
    norms = torch.sqrt((c.double() ** 2).sum(1)).float()
    counts = (c > 0).sum(1).float()
    if dtype == "int8xint8":
        q, c, route = q.to(torch.int8), c.to(torch.int8), "imma"
    else:
        c, route = c.to(dtype), "simt"
    before = dict(fused_rerank_scores.routes)
    got = fused_rerank_scores(q, c, norms, counts, measure=measure,
                              beta=beta, max_value=bound)
    assert fused_rerank_scores.routes[route] == before[route] + 1
    want = rerank_scores_plain(q, c, norms, counts, measure=measure,
                               beta=beta)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        f"cuda.rerank.{case}.{measure}.{dtype}.{beta}"


def test_rerank_kernel_routes_and_domain(cuda):
    """The route follows the dtypes: int8 × int8 → "imma"; f32 queries
    (f32 or int8 candidates) → "simt"; int8 queries need int8
    candidates; the int8 route raises outside its exact domain."""
    from repro_torch.kernels.rerank import fused_rerank_scores
    rng = np.random.default_rng(4)
    r = torch.from_numpy(int_ratings(rng, 40, 3952)).to(cuda)
    q, c = r[:8].contiguous(), r[8:].contiguous()
    norms = torch.sqrt((c.double() ** 2).sum(1)).float()
    counts = (c > 0).sum(1).float()
    for qq, cc, route in ((q, c, "simt"), (q, c.to(torch.int8), "simt"),
                          (q.to(torch.int8), c.to(torch.int8), "imma")):
        before = dict(fused_rerank_scores.routes)
        fused_rerank_scores(qq, cc, norms, counts, measure="pcc",
                            max_value=5)
        assert fused_rerank_scores.routes == {
            k: v + (k == route) for k, v in before.items()}
    with pytest.raises(TypeError):
        fused_rerank_scores(q.to(torch.int8), c, norms, counts)
    with pytest.raises(ValueError, match="exact domain"):   # 128² · 3952
        fused_rerank_scores(q.to(torch.int8), c.to(torch.int8), norms,
                            counts)
    with pytest.raises(ValueError, match="exact domain"):   # 66² · 3952
        fused_rerank_scores(q.to(torch.int8), c.to(torch.int8), norms,
                            counts, max_value=66)


def test_approx_engine_kernel_equals_plain_on_card(cuda):
    from repro_torch.index import IndexConfig
    rng = np.random.default_rng(5)
    r = int_ratings(rng, 400, 300)
    engines = [CFEngine(r, k=10, neighbor_mode="approx", device="cuda",
                        index_cfg=IndexConfig(n_clusters=16, project_dim=32,
                                              use_kernel=flag)).fit()
               for flag in (None, False)]
    ker, plain = engines
    assert ker.index.last_query.scan_mode == "kernel"
    assert torch.equal(ker.idx, plain.idx)
    assert torch.equal(ker.scores, plain.scores)
    assert torch.equal(ker.index.centroids, plain.index.centroids)
    assert np.array_equal(ker.index.spill_dist, plain.index.spill_dist)
    st = ker.update_ratings([4, 4, 9], [1, 2, 3], [5.0, 0.0, 2.0],
                            oracle_check=True)
    assert st.oracle_ok


# -- the item index's support scorer (segmented SpMM) ------------------------

def _support_inputs(rng, b, k, u, i, cuda, masked=False):
    dev = (rng.normal(size=(u, i)).astype(np.float32)
           * (rng.random((u, i)) < 0.3))
    msk = (dev != 0).astype(np.float32)
    idx = rng.integers(0, u, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) < 0.8)).astype(np.float32)
    if masked:
        w[:] = 0.0
    qm = rng.uniform(2, 4, b).astype(np.float32)
    return tuple(torch.from_numpy(x).to(cuda) for x in (dev, msk, idx, w, qm))


@pytest.mark.parametrize("b,k,u,i,masked", [
    (5, 7, 40, 130, False), (1, 1, 17, 7, False), (9, 3, 25, 64, False),
    (3, 4, 20, 48, True), (33, 40, 300, 1024, False),
    (257, 40, 6040, 4096, False), (2, 12, 50, 513, False)])
def test_support_kernel_matches_plain(cuda, b, k, u, i, masked):
    from repro_torch.kernels.support import (fused_support_scores,
                                             support_scores_plain)
    rng = np.random.default_rng(b + k + u + i)
    args = _support_inputs(rng, b, k, u, i, cuda, masked)
    before = fused_support_scores.launches
    got = fused_support_scores(*args)
    assert fused_support_scores.launches == before + 1
    want = support_scores_plain(*args)
    torch.cuda.synchronize()
    assert_parity(f"cuda.support.{b}x{k}x{u}x{i}", got, want)
    if masked:
        assert torch.equal(got, args[4][:, None].clamp(1, 5).expand_as(got))


def _support_int8_inputs(rng, b, k, u, i, cuda, negative=False):
    """(U, I) int8 ratings, (U,) means, (b, k) ids, masked weights and
    query means; ``negative`` adds negative ratings and weights (w·0 = −0:
    the kernel's general path, beside its fast path for w·0 = +0)."""
    r = int_ratings(rng, u, i, 0.3)
    w = (rng.random((b, k)) * (rng.random((b, k)) < 0.8)).astype(np.float32)
    if negative:
        r = r - 2.0 * (rng.random((u, i)) < 0.1)
        w = w - 0.5 * (rng.random((b, k)) < 0.3).astype(np.float32)
    means = rng.uniform(2, 4, u).astype(np.float32)
    idx = rng.integers(0, u, (b, k)).astype(np.int32)
    qm = rng.uniform(2, 4, b).astype(np.float32)
    t = [torch.from_numpy(x).to(cuda) for x in (r, means, idx, w, qm)]
    t[0] = t[0].to(torch.int8)
    return tuple(t)


@pytest.mark.parametrize("b,k,u,i,negative", [
    (5, 7, 40, 130, False), (1, 1, 17, 7, False), (9, 3, 25, 64, True),
    (33, 40, 300, 1024, False), (257, 40, 6040, 3952, False),
    (2, 12, 50, 513, True), (3, 70, 90, 2100, False)])
def test_support_int8_route_matches_plain(cuda, b, k, u, i, negative):
    """The int8 route (ratings and means in place of the tables) against
    its plain version and the table route's kernel on the tables of the
    same data: bit for bit, at widths off 16 and off the 2048-column
    tile, k past the 64-neighbor staging chunk, negative ratings and
    weights."""
    from repro_torch.kernels.support import (fused_support_scores,
                                             support_scores_int8_plain,
                                             support_tables, support_width)
    rng = np.random.default_rng(b + k + u + i)
    r8, means, idx, w, qm = _support_int8_inputs(rng, b, k, u, i, cuda,
                                                 negative)
    before = dict(fused_support_scores.routes)
    got = fused_support_scores(r8, means, idx, w, qm)
    assert fused_support_scores.routes == {
        key: v + (key == "int8") for key, v in before.items()}
    width = support_width(i)
    assert got.shape == (b, width)
    want = support_scores_int8_plain(r8, means, idx, w, qm)
    dev, msk = support_tables(r8, means, width)
    table = fused_support_scores(dev, msk, idx, w, qm)
    assert fused_support_scores.routes["table"] == before["table"] + 1
    torch.cuda.synchronize()
    assert_parity(f"cuda.support.int8.{b}x{k}x{u}x{i}", got, want)
    assert_parity(f"cuda.support.int8_vs_table.{b}x{k}x{u}x{i}", got,
                  table)


def test_support_int8_route_mean_fallback(cuda):
    """Columns no neighbor rated (and the padding past I, out to the
    next 512-column tile) score the query mean, clipped."""
    from repro_torch.kernels.support import (fused_support_scores,
                                             support_scores_int8_plain)
    rng = np.random.default_rng(12)
    r8, means, idx, w, qm = _support_int8_inputs(rng, 6, 5, 30, 600, cuda)
    r8[:, :32] = 0                          # nobody rated items 0..31
    qm[0], qm[1] = 0.5, 6.0                 # clipped to 1 and 5
    got = fused_support_scores(r8, means, idx, w, qm)
    want = support_scores_int8_plain(r8, means, idx, w, qm)
    torch.cuda.synchronize()
    assert got.shape == (6, 1024)
    assert_parity("cuda.support.int8.fallback", got, want)
    fallback = qm[:, None].clamp(1, 5)
    assert torch.equal(got[:, :32], fallback.expand(-1, 32))
    assert torch.equal(got[:, 600:], fallback.expand(-1, 424))
    with pytest.raises(ValueError):
        fused_support_scores(r8, means[:-1], idx, w, qm)
    with pytest.raises(TypeError):
        fused_support_scores(r8, means.double(), idx, w, qm)


def test_support_kernel_equals_tile_predict(cuda):
    """The support score is the exact prediction: the same ordered k-loop
    on the same rounded r − r̄ values as the tile-predict kernel."""
    from repro_torch.kernels.support import (BT, fused_support_scores,
                                             support_tables)
    rng = np.random.default_rng(4)
    r = torch.from_numpy(int_ratings(rng, 300, 700)).to(cuda)
    eng = CFEngine(r, k=12, block_size=128, device="cuda").fit()
    scores, idx, means = eng.scores, eng.idx, eng.means
    dev, msk = support_tables(r, means, 700 + (-700) % BT)
    safe = torch.where(idx >= 0, idx, 0).to(torch.int32).contiguous()
    w = torch.where((scores > 0) & (idx >= 0), scores,
                    torch.zeros_like(scores)).contiguous()
    got = fused_support_scores(dev, msk, safe, w, means)[:, :700]
    src = pr.make_gather_source(r)
    got8 = fused_support_scores(src, means, safe, w, means)[:, :700]
    want = pr.predict_from_neighbors_blocked(
        r, scores, idx, means=means, item_block=512, gather_src=src,
        use_kernel=True)
    torch.cuda.synchronize()
    assert_parity("cuda.support.identity_tile_predict", got, want)
    assert_parity("cuda.support.int8.identity_tile_predict", got8, want)


def test_support_kernel_rejects_bad_inputs(cuda):
    from repro_torch.kernels.support import fused_support_scores
    rng = np.random.default_rng(0)
    dev, msk, idx, w, qm = _support_inputs(rng, 3, 4, 20, 48, cuda)
    with pytest.raises(TypeError):
        fused_support_scores(dev, msk, idx.long(), w, qm)
    with pytest.raises(ValueError):
        fused_support_scores(dev, msk[:, :40], idx, w, qm)
    with pytest.raises(ValueError):
        fused_support_scores(dev, msk, idx, w.cpu(), qm)
    with pytest.raises(ValueError):
        fused_support_scores(dev.T.contiguous().T, msk, idx, w, qm)


def test_approx_recommend_equals_exact_on_card(cuda):
    from repro_torch.index import ItemIndexConfig
    rng = np.random.default_rng(6)
    r = int_ratings(rng, 400, 700)
    engines = [CFEngine(r, k=10, recommend_mode="approx", device="cuda",
                        item_index_cfg=ItemIndexConfig(use_kernel=flag)
                        ).fit() for flag in (None, False)]
    ker, plain = engines
    from repro_torch.kernels.support import fused_support_scores
    before = dict(fused_support_scores.routes)
    s_ex, i_ex = ker.recommend(n=10, mode="exact")
    for shortlist in (512, 64, 10):
        s_k, i_k = ker.recommend(n=10, shortlist=shortlist)
        s_p, i_p = plain.recommend(n=10, shortlist=shortlist)
        assert torch.equal(s_k, s_ex) and torch.equal(i_k, i_ex)
        assert torch.equal(s_p, s_ex) and torch.equal(i_p, i_ex)
    # integer ratings: every support launch on the int8 route
    assert fused_support_scores.routes["int8"] == before["int8"] + 3
    assert fused_support_scores.routes["table"] == before["table"]
    assert ker.recommend_recall_vs_exact(sample=64) == 1.0
    st = ker.update_ratings([4, 4, 9], [1, 2, 3], [5.0, 0.0, 2.0],
                            oracle_check=True)
    assert st.oracle_ok and ker.item_index.last_refold.caches_patched >= 1
    s_ex, i_ex = ker.recommend(n=10, mode="exact")
    s_k, i_k = ker.recommend(n=10)
    assert torch.equal(s_k, s_ex) and torch.equal(i_k, i_ex)


def test_approx_recommend_f32_route_on_card(cuda):
    """Half-star ratings leave int8: both kernels take their f32 routes
    (similarity "simt", support "table"), and approx still equals exact
    bit for bit."""
    from repro_torch.kernels.support import fused_support_scores
    rng = np.random.default_rng(7)
    r = int_ratings(rng, 300, 520)
    r[r == 4] = 3.5
    sim_before = dict(fused_similarity.routes)
    sup_before = dict(fused_support_scores.routes)
    eng = CFEngine(r, k=10, recommend_mode="approx", device="cuda").fit()
    s_ap, i_ap = eng.recommend(n=10, shortlist=32)
    s_ex, i_ex = eng.recommend(n=10, mode="exact")
    assert torch.equal(s_ap, s_ex) and torch.equal(i_ap, i_ex)
    assert fused_similarity.routes["simt"] > sim_before["simt"]
    assert fused_similarity.routes["imma"] == sim_before["imma"]
    assert fused_support_scores.routes["table"] > sup_before["table"]
    assert fused_support_scores.routes["int8"] == sup_before["int8"]
    seq = CFEngine(r, k=10, backend="sequential", device="cuda").fit()
    assert torch.equal(seq.idx, eng.idx)
    assert torch.equal(seq.scores, eng.scores)


# -- the flash-attention kernel (LM serving) against its plain version ------

def _attn_inputs(seed, b, hq, hkv, sq, skv, d, dv, dtype, cuda):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, sq, d, generator=g)
    k = torch.randn(b, hkv, skv, d, generator=g)
    v = torch.randn(b, hkv, skv, dv, generator=g)
    return [x.to(cuda, dtype) for x in (q, k, v)]


def _attn_close(name, got, q, k, v, **kw):
    """f32: atol 1e-5 against the plain version; bf16: against the plain
    f32 result on the same (bf16) inputs, rounded to bf16, atol 2e-2 and,
    elementwise, one bf16 unit in the last place (≤ |x|·2⁻⁷) plus 1e-5:
    both accumulate in f32, so they round to the same or adjacent bf16."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    want = want.to(q.dtype).float()
    tol = 1e-5 if q.dtype == torch.float32 else 2e-2
    assert got.dtype == q.dtype
    assert_parity(name, got.float(), want, tol)
    if q.dtype == torch.bfloat16:
        g = got.float()
        ulp = 2.0 ** -7 * torch.maximum(g.abs(), want.abs()) + 1e-5
        assert bool(((g - want).abs() <= ulp).all()), f"{name}: > 1 bf16 ulp"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,group,sq,skv,d,dv", [
    (2, 2, 1, 77, 77, 64, 64),        # ragged tails, Sq == Skv
    (1, 2, 4, 50, 130, 128, 128),     # Sq != Skv
    (2, 1, 8, 33, 200, 64, 64),       # group 8
    (1, 2, 4, 40, 100, 192, 128),     # dv != d
    (1, 1, 2, 20, 8, 64, 64),         # Sq > Skv: fully masked rows
    (4, 8, 4, 1, 300, 64, 64),        # decode shape
])
def test_flash_kernel_matches_plain(cuda, dtype, b, hkv, group, sq, skv, d,
                                    dv):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(sq + skv + d, b, hkv * group, hkv, sq, skv, d, dv,
                           dtype, cuda)
    for causal in (True, False):
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        assert flash_attention.launches == before + 1
        torch.cuda.synchronize()
        _attn_close(f"cuda.flash.{b}x{hkv}x{group}x{sq}x{skv}x{d}x{dv}."
                    f"{str(dtype)[6:]}.causal={causal}", got, q, k, v,
                    causal=causal)
        if causal and sq > skv:
            masked = got[:, :, :sq - skv]
            assert torch.equal(masked, torch.zeros_like(masked))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_kv_len(cuda, dtype):
    """Decode (Sq = 1) and a prefill chunk against ragged caches; keys past
    kv_len hold NaN and must not be read."""
    from repro_torch.kernels.flash_attention import flash_attention
    for sq, kv in ((1, [1, 77, 300, 150]), (5, [5, 64, 200, 9])):
        q, k, v = _attn_inputs(sq, 4, 32, 8, sq, 300, 64, 64, dtype, cuda)
        kv_len = torch.tensor(kv, dtype=torch.int32, device=cuda)
        for row, n in enumerate(kv):
            k[row, :, n:] = float("nan")
            v[row, :, n:] = float("nan")
        got = flash_attention(q, k, v, causal=True, kv_len=kv_len)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        _attn_close(f"cuda.flash.kv_len.sq{sq}.{str(dtype)[6:]}", got, q, k,
                    v, causal=True, kv_len=kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_llama_serving_shapes(cuda, dtype):
    """Llama-3.2-1B's prefill launch (B 4, Hq 32, Hkv 8, S 2048, d 64,
    causal: up to 32 KV tiles a row) and its decode launch (Sq = 1 against
    2049 of 2080 cached keys), unit-variance scores as at layer 0."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(7, 4, 32, 8, 2048, 2048, 64, 64, dtype, cuda)
    _attn_close(f"cuda.flash.llama_prefill.{str(dtype)[6:]}",
                flash_attention(q, k, v), q, k, v, causal=True)
    q, k, v = _attn_inputs(8, 4, 32, 8, 1, 2080, 64, 64, dtype, cuda)
    kv_len = torch.full((4,), 2049, dtype=torch.int32, device=cuda)
    _attn_close(f"cuda.flash.llama_decode.{str(dtype)[6:]}",
                flash_attention(q, k, v, kv_len=kv_len), q, k, v,
                causal=True, kv_len=kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_mla_prefill_shape(cuda, dtype):
    """DeepSeek-V2's MLA prefill launch: q·k width 192, v width 128, no
    grouping (g = 1), S 2048, causal, at 1/1/2048 scale 1/√192; the bf16
    call on the tensor-core route's own ``<192, 128>`` tile (no padding
    to 256); 16 of the 128 heads."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(9, 1, 16, 16, 2048, 2048, 192, 128, dtype, cuda)
    want = "simt" if dtype == torch.float32 else "mma"
    tiles = dict(flash_attention.tiles)
    got = _routed(q, k, v, want, scale=1.0 / 192 ** 0.5)
    if dtype == torch.bfloat16:
        assert flash_attention.tiles.get("192x128", 0) == \
            tiles.get("192x128", 0) + 1
    _attn_close(f"cuda.flash.mla_prefill.{str(dtype)[6:]}", got, q, k, v,
                causal=True, scale=1.0 / 192 ** 0.5)


def test_flash_kernel_strided_inputs_and_rejects(cuda):
    """(B, S, H, d) projections viewed as (B, H, S, d) — the model's layout —
    need no copy; unsupported inputs raise."""
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 37, 8, 64, generator=g).to(cuda, torch.bfloat16)
    kv = torch.randn(2, 37, 2, 64, generator=g).to(cuda, torch.bfloat16)
    qt, kt = q.transpose(1, 2), kv.transpose(1, 2)
    got = flash_attention(qt, kt, kt)
    _attn_close("cuda.flash.strided", got, qt.contiguous(), kt.contiguous(),
                kt.contiguous(), causal=True)
    with pytest.raises(TypeError):
        flash_attention(qt, kt.float(), kt)
    with pytest.raises(ValueError):
        flash_attention(qt, kt, kt.cpu())
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 1, 4, 300, device=cuda),
                        torch.zeros(1, 1, 4, 300, device=cuda),
                        torch.zeros(1, 1, 4, 300, device=cuda))


def _routed(q, k, v, want_route, **kw):
    """One flash call; asserts it took ``want_route`` (and one launch)."""
    from repro_torch.kernels.flash_attention import flash_attention
    before = dict(flash_attention.routes)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = flash_attention.routes
    assert after[want_route] == before[want_route] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return got


@pytest.mark.parametrize("sq,group,want", [(1, 4, "split"), (5, 4, "mma")])
def test_flash_bf16_kv_len_sweep(cuda, sq, group, want):
    """Per-row kv_len of 0, 1, less than a split (128 keys), exactly one
    split, past one split and every split of the cache, mixed across the
    batch; keys past kv_len hold NaN and are never read; kv_len 0 gives
    exact zeros."""
    lens = [0, 1, 100, 128, 257, 384]
    q, k, v = _attn_inputs(sq + group, len(lens), 2 * group, 2, sq, 384,
                           64, 64, torch.bfloat16, cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for row, n in enumerate(lens):
        k[row, :, n:] = float("nan")
        v[row, :, n:] = float("nan")
    got = _routed(q, k, v, want, causal=True, kv_len=kv_len)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _attn_close(f"cuda.flash.bf16.kv_len.{want}", got, q, k, v, causal=True,
                kv_len=kv_len)


@pytest.mark.parametrize("hkv,group,sq,want", [
    (2, 8, 2, "split"), (1, 1, 16, "split"), (2, 4, 4, "split"),
    (1, 1, 17, "mma"), (2, 17, 1, "mma"), (1, 4, 5, "mma"),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_route_boundary(cuda, hkv, group, sq, want, causal):
    """Sq·group = 16 goes to the split-K decode, 17 to the tensor-core
    prefill; both against the plain version."""
    q, k, v = _attn_inputs(hkv + group + sq, 2, hkv * group, hkv, sq, 200,
                           64, 64, torch.bfloat16, cuda)
    got = _routed(q, k, v, want, causal=causal)
    _attn_close(f"cuda.flash.bf16.route.{hkv}x{group}x{sq}.{want}", got, q,
                k, v, causal=causal)


@pytest.mark.parametrize("d,dv", [(40, 72), (72, 40), (256, 256), (256, 40),
                                  (72, 256)])
@pytest.mark.parametrize("sq,want", [(1, "split"), (33, "mma")])
def test_flash_bf16_head_dims(cuda, d, dv, sq, want):
    """d and dv of 40, 72 and 256, dv ≠ d, zero-padded in shared memory,
    on both bf16 routes, causal and not."""
    q, k, v = _attn_inputs(d + dv + sq, 2, 8, 2, sq, 150, d, dv,
                           torch.bfloat16, cuda)
    for causal in (True, False):
        got = _routed(q, k, v, want, causal=causal)
        _attn_close(f"cuda.flash.bf16.d{d}.dv{dv}.{want}.causal={causal}",
                    got, q, k, v, causal=causal)


@pytest.mark.parametrize("sq,want", [(1, "split"), (40, "mma")])
def test_flash_bf16_unaligned_strides(cuda, sq, want):
    """Rows 65 elements apart (not 16-byte aligned) take the scalar staging
    path of both bf16 routes."""
    g = torch.Generator().manual_seed(sq)
    buf = [torch.randn(2, h, s, 65, generator=g).to(cuda, torch.bfloat16)
           for h, s in ((8, sq), (2, 90), (2, 90))]
    q, k, v = (x[..., :64] for x in buf)
    kv_len = torch.tensor([90, 37], dtype=torch.int32, device=cuda)
    got = _routed(q, k, v, want, causal=True, kv_len=kv_len)
    _attn_close(f"cuda.flash.bf16.unaligned.{want}", got, q.contiguous(),
                k.contiguous(), v.contiguous(), causal=True, kv_len=kv_len)


def test_llama_smoke_serving_on_card(cuda):
    """The smoke Llama config in f32 on the card (kernel) equals the same
    model on the CPU (plain) within 1e-4, prefill and 3 decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tx
    cfg = get_arch("llama3_2_1b").smoke_config()
    params = tx.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    cpu = tx.Transformer(cfg, params)
    gpu = tx.Transformer(cfg, tx._map(lambda t: t.to(cuda), params))
    toks = torch.randint(0, cfg.vocab, (3, 21), dtype=torch.int32)
    before = flash_attention.launches
    lc, cc = cpu.prefill(toks, max_len=25)
    lg, cg = gpu.prefill(toks.to(cuda), max_len=25)
    assert_parity("cuda.llama_smoke.prefill", lg.cpu(), lc, 1e-4)
    for step in range(3):
        nxt = lc.argmax(-1, keepdim=True).to(torch.int32)
        lc, cc = cpu.decode_step(nxt, cc)
        lg, cg = gpu.decode_step(nxt.to(cuda), cg)
        assert_parity(f"cuda.llama_smoke.decode{step}", lg.cpu(), lc, 1e-4)
    assert flash_attention.launches == before + 4 * cfg.n_layers


@pytest.mark.parametrize("name", ["qwen3_moe_30b_a3b", "deepseek_v2_236b"])
def test_moe_mla_smoke_serving_on_card(cuda, name):
    """The MoE / MLA smoke configs in f32 on the card (kernels 5 and 8)
    equal the same model on the CPU (plain) within 1e-4, prefill and 3
    decode steps; kernel 5 runs once a MoE layer and call."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.select import select_topm
    from repro_torch.models import transformer as tx
    cfg = get_arch(name).smoke_config()
    params = tx.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    cpu = tx.Transformer(cfg, params)
    gpu = tx.Transformer(cfg, tx._map(lambda t: t.to(cuda), params))
    toks = torch.randint(0, cfg.vocab, (3, 21), dtype=torch.int32)
    before = select_topm.launches
    lc, cc = cpu.prefill(toks, max_len=25)
    lg, cg = gpu.prefill(toks.to(cuda), max_len=25)
    assert_parity(f"cuda.{name}_smoke.prefill", lg.cpu(), lc, 1e-4)
    for step in range(3):
        nxt = lc.argmax(-1, keepdim=True).to(torch.int32)
        lc, cc = cpu.decode_step(nxt, cc)
        lg, cg = gpu.decode_step(nxt.to(cuda), cg)
        assert_parity(f"cuda.{name}_smoke.decode{step}", lg.cpu(), lc, 1e-4)
    for key in cc:
        assert_parity(f"cuda.{name}_smoke.cache.{key}", cg[key].cpu(),
                      cc[key], 1e-4)
    assert select_topm.launches == before + 4 * cfg.layer_counts()[1]


# -- the embedding-bag kernel (recsys) against its plain version ------------

def _bag_inputs(seed, v, d, b, l, dtype, cuda, pad=0.3):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0, 1, (v, d)).astype(np.float32))
    idx = rng.integers(0, v, (b, l))
    idx[rng.random((b, l)) < pad] = -1
    return table.to(cuda, dtype), torch.from_numpy(idx.astype(np.int32)).to(
        cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,l", [
    (50, 1, 1, 1), (50, 10, 1, 1), (300, 128, 1, 1),     # B = L = 1
    (1000, 1, 37, 9), (1000, 10, 37, 9),                 # FM / xDeepFM D
    (5000, 128, 513, 100), (777, 12, 5, 33),             # multi-hot; D % 8
    (64, 300, 7, 40), (64, 36, 3, 70),                   # D > 32 lanes · 8
    (3000, 10, 2051, 100), (3000, 1, 2051, 17),          # slots, 4 warps
])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bag_kernel_matches_plain(cuda, dtype, v, d, b, l, combiner):
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    table, idx = _bag_inputs(v + d + b + l, v, d, b, l, dtype, cuda)
    idx[0, -1] = -1                                    # a padded last slot
    if b > 2:
        idx[2] = -1                                    # an all-padding bag
    before = embedding_bag.launches
    got = embedding_bag(table, idx, combiner=combiner)
    assert embedding_bag.launches == before + 1
    want = embedding_bag_plain(table, idx, combiner=combiner)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, d)
    assert_parity(f"cuda.bag.{combiner}.{str(dtype)[6:]}.V{v}.D{d}.B{b}.L{l}",
                  got.float(), want.float())
    if b > 2:
        assert bool((got[2] == 0).all())
    # int64 ids launch the same arithmetic
    assert torch.equal(embedding_bag(table, idx.long(), combiner=combiner),
                       got)


def test_bag_kernel_rejects_ids_past_the_table(cuda):
    from repro_torch.kernels.embedding_bag import embedding_bag
    table, idx = _bag_inputs(0, 100, 16, 8, 4, torch.float32, cuda)
    idx[3, 2] = 100
    with pytest.raises(ValueError, match="≥ the table's 100 rows"):
        embedding_bag(table, idx)
    with pytest.raises(ValueError, match="≥ the table's 100 rows"):
        embedding_bag(table, idx.long() + 2**40)
    with pytest.raises(TypeError):
        embedding_bag(table.double(), idx)
    with pytest.raises(ValueError):
        embedding_bag(table.T, idx)                    # not contiguous
    with pytest.raises(ValueError):
        embedding_bag(table, idx.cpu())
    from repro_torch.kernels import ops
    with pytest.raises(ValueError):
        ops.embedding_bag(table.cpu(), idx.cpu(), impl="kernel")


def _bag_expected_routes(before, route):
    from repro_torch.kernels.embedding_bag import embedding_bag
    return embedding_bag.routes == {k: v + (k == route)
                                    for k, v in before.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 10, 12, 36, 128, 300])
@pytest.mark.parametrize("b,l", [(37, 1), (2051, 1), (37, 17), (2051, 100),
                                 (5, 33)])
def test_bag_routes_bitwise(cuda, dtype, d, b, l):
    """Each route of the plan (the warp kernel, the slot kernel) against
    the plain version bit for bit: B of one and of four warps a block and
    off a block, L = 1 and L off the prefetch depth, an all-padding bag
    (exactly 0), a padded last slot, sum and mean, int32 and int64 ids;
    the route counted once a launch."""
    from repro_torch.kernels.embedding_bag import (_align, embedding_bag,
                                                   embedding_bag_plain,
                                                   plan)
    table, idx = _bag_inputs(d * b + l, 4000, d, b, l, dtype, cuda, pad=0.1)
    idx[0, -1] = -1                                    # a padded last slot
    idx[2] = -1                                        # an all-padding bag
    route = plan(d, table.element_size(), l, _align(table)).route
    for combiner in ("sum", "mean"):
        for ids in (idx, idx.long()):
            before = dict(embedding_bag.routes)
            got = embedding_bag(table, ids, combiner=combiner)
            assert _bag_expected_routes(before, route)
            want = embedding_bag_plain(table, ids, combiner=combiner)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (b, d)
            assert torch.equal(got.float().view(torch.int32),
                               want.float().view(torch.int32)), \
                (d, b, l, combiner)
            assert bool((got[2] == 0).all())


def _bag_plans(d, elem):
    """Every plan the kernel takes for rows of ``d`` elements: each word
    width that divides the row, the warp kernel at each depth, and the
    slot kernel where the row has at most SLOT_WORDS words."""
    from repro_torch.kernels.embedding_bag import DEPTH, SLOT_WORDS, Plan
    out = []
    for word in (16, 8, 4, 2):
        if word < elem or (d * elem) % word:
            continue
        out += [Plan(word, depth) for depth in (1, 4, DEPTH)]
        if d * elem // word <= SLOT_WORDS:
            out.append(Plan(word, DEPTH, slots=True))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 4, 10, 36, 128, 300])
@pytest.mark.parametrize("b", [45, 300, 700])
def test_bag_every_plan_bitwise(cuda, dtype, d, b):
    """The kernel under every plan it accepts (word widths, depths, both
    kernels) == the plain version bit for bit, mean, int32 ids with
    padding, L off every depth, B of one, two and four warps a block; the
    route follows the plan."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain,
                                                   launch)
    table, idx = _bag_inputs(d + b, 500, d, b, 21, dtype, cuda)
    idx[7] = -1
    want = embedding_bag_plain(table, idx, combiner="mean")
    n_bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    for how in _bag_plans(d, table.element_size()):
        before = dict(embedding_bag.routes)
        got = launch(table, idx, n_bad, combiner="mean", how=how)
        assert _bag_expected_routes(before, how.route)
        torch.cuda.synchronize()
        assert torch.equal(got.float().view(torch.int32),
                           want.float().view(torch.int32)), how
    assert int(n_bad.item()) == 0


@pytest.mark.parametrize("d,dtype", [(128, torch.float32), (10, torch.float32),
                                     (1, torch.float32),
                                     (128, torch.bfloat16)])
@pytest.mark.parametrize("slot", [0, 5, 7, 8, 16, 31, 32, 39])
def test_bag_ids_past_the_table_in_the_window(cuda, d, dtype, slot):
    """An id ≥ V in the first ring window (depth 8), at its edge, one and
    two windows ahead, at the slot kernel's chunk edge (32) and at the
    last slot: the wrapper raises, its check launch counting them as the
    plain count does; the launch alone skips that slot (== the plain
    version with the slot padded) and adds one to its counter a bad
    slot."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain,
                                                   launch)
    table, idx = _bag_inputs(slot + d, 300, d, 70, 40, dtype, cuda)
    bad = torch.zeros_like(idx, dtype=torch.bool)
    bad[3, slot] = bad[64, slot] = bad[69, 39 - slot] = True
    ids = torch.where(bad, torch.full_like(idx, 300), idx)
    ids[64, slot] = 2**31 - 1
    for id_t in (ids, ids.long()):
        with pytest.raises(ValueError, match="^3 id.* ≥ the table's 300 rows"):
            embedding_bag(table, id_t)
        n_bad = torch.zeros(1, dtype=torch.int32, device=cuda)
        for combiner in ("sum", "mean"):
            got = launch(table, id_t, n_bad, combiner=combiner)
            want = embedding_bag_plain(
                table, torch.where(bad, torch.full_like(id_t, -1), id_t),
                combiner=combiner)
            torch.cuda.synchronize()
            assert torch.equal(got.float().view(torch.int32),
                               want.float().view(torch.int32))
        assert int(n_bad.item()) == 2 * int((id_t >= 300).sum()) == 6


def test_bag_wrapper_does_not_wait_for_the_bags(cuda):
    """The wrapper waits for its id check, not for the bag launch: after
    it returns from a launch of several milliseconds the stream still has
    work, and the result is right once it ends."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((1 << 20, 128), generator=g, device=cuda)
    ids = torch.randint(0, 1 << 20, (32768, 256), generator=g, device=cuda,
                        dtype=torch.int32)
    embedding_bag(table, ids[:8])                      # build and load
    torch.cuda.synchronize()
    got = embedding_bag(table, ids)
    pending = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert pending
    want = embedding_bag_plain(table, ids[:512])
    assert torch.equal(got[:512], want)


def test_usercf_runs_kernels_1_and_2(cuda):
    """``UserCF``'s sequential engine on the card: the fit launches the
    similarity kernel on "imma" and equals the facade's kernel backend bit
    for bit; ``predict`` is one tile-predict launch on "int8", bit for
    bit the CPU path; the legacy server answers as ``recommend``."""
    from repro_torch.core.cf_model import CFConfig, UserCF
    r = int_ratings(np.random.default_rng(11), 300, 257, density=0.2)
    cf = UserCF(CFConfig(measure="pcc", top_k=12, block_size=128),
                device=cuda)
    sim0, routes0 = fused_similarity.launches, dict(fused_similarity.routes)
    st = cf.fit(r)
    assert fused_similarity.launches - sim0 == 3
    assert fused_similarity.routes["imma"] - routes0["imma"] == 3
    eng = CFEngine(r, measure="pcc", k=12, block_size=128, device=cuda).fit()
    assert torch.equal(st.idx, eng.idx) and torch.equal(st.scores,
                                                        eng.scores)
    pred0 = fused_tile_predict.launches
    got = cf.predict(r)
    assert fused_tile_predict.launches - pred0 == 1
    cpu = UserCF(CFConfig(measure="pcc", top_k=12, block_size=128),
                 device="cpu")
    cpu.fit(r)
    torch.cuda.synchronize()
    assert torch.equal(cpu.state.idx, st.idx.cpu())
    assert torch.equal(got.cpu().view(torch.int32),
                       cpu.predict(r).view(torch.int32))
    ratings = torch.from_numpy(r).to(cuda)
    server = BatchingServer(cf, ratings, device=cuda, max_batch=8, topn=5)
    server.start()
    res = [f.result(timeout=60) for f in [server.submit(u)
                                          for u in range(0, 300, 7)]]
    server.stop()
    want = cf.recommend(ratings, n=5)[1].cpu().numpy()
    for a in res:
        np.testing.assert_array_equal(a.items, want[a.user])


def test_slope_one_deviation_on_the_card(cuda):
    """The deviation build's matmuls on exact integers: bit for bit the
    CPU's; the prediction within 2e-6."""
    from repro_torch.core import slope_one as so
    r = torch.from_numpy(int_ratings(np.random.default_rng(12), 500, 300,
                                     density=0.1))
    d, c = so.deviation_matrix(r.to(cuda))
    want_d, want_c = so.deviation_matrix(r)
    assert torch.equal(d.cpu(), want_d) and torch.equal(c.cpu(), want_c)
    assert_parity("slope_one.card.predict", so.predict(r.to(cuda), d, c),
                  so.predict(r, want_d, want_c), atol=2e-6)


# -- the flash-attention backward kernel (LM training) ------------------------

def _bwd_close(name, q, k, v, causal=True, route=None):
    """The backward kernel's (dq, dk, dv), from the forward kernel's output
    and log-sum-exp, against the plain backward's recomputed softmax on
    the same inputs (f32 copies of them for bf16), one launch a call on
    ``route`` (when given).  Tolerance, relative to the largest |gradient|
    of each tensor: 2e-5 in f32 (both sum in f32, in another order, over
    up to S·g terms) and 1e-2 in bf16 (the kernel's result is rounded to
    bf16: ≤ 2⁻⁸ of each value; the "mma" route rounds P and dS once to
    bf16 as an operand; plus the f32 copies' order).  Returns the
    gradients, the forward's output, its lse and dO."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(7)
                     ).to(o.device, o.dtype)
    before = flash_attention_bwd.launches
    routes = dict(flash_attention_bwd.routes)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert flash_attention_bwd.launches == before + 1
    if route is not None:
        assert flash_attention_bwd.routes == {
            r: n + (r == route) for r, n in routes.items()}
    want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)),
                                     causal=causal)
    rel = 2e-5 if q.dtype == torch.float32 else 1e-2
    for tag, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert_parity(f"{name}.d{tag}", g.float(), w,
                      rel * max(1.0, float(w.abs().max())))
    return got, o, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,group,sq,skv,d,dv,causal", [
    (2, 2, 1, 77, 77, 64, 64, True),      # ragged tiles, Sq == Skv
    (1, 2, 4, 50, 130, 128, 128, True),   # Sq != Skv, group 4
    (2, 1, 2, 100, 100, 64, 64, False),   # not causal
    (1, 2, 4, 40, 100, 192, 128, True),   # dv != d: MLA's 192 / 128
    (1, 1, 2, 20, 8, 64, 64, True),       # Sq > Skv: fully masked rows
    (1, 2, 2, 65, 65, 40, 40, True),      # d off 16
    (2, 3, 1, 77, 77, 192, 128, True),    # MLA: group 1, S off 64
    (1, 2, 1, 90, 90, 160, 128, True),    # d 160: zero-padded to 192
])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, b, hkv, group, sq, skv,
                                        d, dv, causal):
    """Both dtypes against the plain backward; a bf16 call with d ≤ 192
    and dv ≤ 128 advances ``routes["mma"]`` (MLA's 192 / 128 heads and a
    d of 160 padded to them included), f32 ``routes["simt"]``."""
    q, k, v = _attn_inputs(sq * 7 + skv, b, hkv * group, hkv, sq, skv, d,
                           dv, dtype, cuda)
    route = "simt" if dtype == torch.float32 else "mma"
    _bwd_close(f"cuda.flash_bwd.{b}x{hkv}x{group}x{sq}x{skv}x{d}x{dv}."
               f"{str(dtype)[6:]}", q, k, v, causal=causal, route=route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_at_the_llama_training_shape(cuda, dtype):
    """Llama-3.2-1B's heads (32 / 8, d 64) at a 1024-token sequence, and
    the autograd Function: its gradients are the backward kernel's."""
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention_bwd)
    q, k, v = _attn_inputs(3, 1, 32, 8, 1024, 1024, 64, 64, dtype, cuda)
    _bwd_close(f"cuda.flash_bwd.llama.{str(dtype)[6:]}", q, k, v)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, True, None)
    before = flash_attention_bwd.launches
    out.float().square().sum().backward()
    assert flash_attention_bwd.launches == before + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


def test_flash_bwd_kernel_strided_and_rejects(cuda):
    """(B, S, H, d) storage seen as (B, H, S, d), as the model passes q,
    k, v and the output gradient; mixed dtypes and devices raise."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    g = torch.Generator().manual_seed(5)
    qt = torch.randn(2, 70, 4, 64, generator=g).to(cuda).transpose(1, 2)
    kt = torch.randn(2, 70, 2, 64, generator=g).to(cuda).transpose(1, 2)
    _bwd_close("cuda.flash_bwd.strided", qt, kt, kt)
    _bwd_close("cuda.flash_bwd.strided.bf16", qt.bfloat16(), kt.bfloat16(),
               kt.bfloat16(), route="mma")
    o = torch.zeros_like(qt)
    lse = torch.zeros(qt.shape[:3], device=cuda)
    with pytest.raises(TypeError):
        flash_attention_bwd(qt, kt.bfloat16(), kt, o, o, lse)
    with pytest.raises(TypeError):
        flash_attention_bwd(qt, kt, kt, o, o, lse.bfloat16())
    with pytest.raises(ValueError):
        flash_attention_bwd(qt, kt, kt.cpu(), o, o, lse)


BWD_SHAPES = [
    (2, 2, 1, 77, 77, 64, 64, True),      # ragged tiles, Sq == Skv
    (1, 2, 4, 50, 130, 128, 128, True),   # Sq != Skv, group 4
    (2, 1, 2, 100, 100, 64, 64, False),   # not causal
    (1, 2, 4, 40, 100, 192, 128, True),   # dv != d: MLA's 192 / 128
    (1, 3, 1, 130, 130, 192, 128, True),  # MLA, group 1: 16-row q tiles
    (1, 2, 2, 40, 70, 192, 136, True),    # dv past 128: "simt"
    (1, 1, 2, 20, 8, 64, 64, True),       # Sq > Skv: fully masked rows
    (1, 2, 2, 65, 65, 40, 40, True),      # d off 16
    (1, 8, 4, 256, 256, 64, 64, True),    # Llama-3.2-1B's heads
    (1, 2, 2, 70, 90, 64, 128, True),     # d 64, dv 128: 32-row stages
]


@pytest.mark.parametrize("b,hkv,group,sq,skv,d,dv,causal", BWD_SHAPES)
def test_flash_bwd_bf16_routes_and_determinism(cuda, b, hkv, group, sq, skv,
                                               d, dv, causal):
    """bf16 backward on the route ``bwd_route`` names ("mma" for d ≤ 192
    and dv ≤ 128, "simt" past that), counted once, against the plain
    backward; then the same call again gives the same bits (no atomics,
    fixed sum order); fully masked rows give exact zeros."""
    from repro_torch.kernels.flash_attention import (bwd_route,
                                                     flash_attention_bwd)
    q, k, v = _attn_inputs(sq * 3 + skv + d, b, hkv * group, hkv, sq, skv,
                           d, dv, torch.bfloat16, cuda)
    route = bwd_route(q, v)
    assert route == ("mma" if d <= 192 and dv <= 128 else "simt")
    got, o, lse, do = _bwd_close(
        f"cuda.flash_bwd.route.{b}x{hkv}x{group}x{sq}x{skv}x{d}x{dv}."
        f"{route}", q, k, v, causal=causal, route=route)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
    if causal and sq > skv:
        assert float(got[0][:, :, :sq - skv].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_llama_shape_both_routes(cuda, dtype):
    """Llama-3.2-1B's training attention (B 2, Hq 32, Hkv 8, S 2048, d
    64, causal) in (B, S, H, d) storage seen as (B, H, S, d): f32 on
    "simt", bf16 on "mma", each against the plain backward and bitwise
    equal to itself on a second call."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    g = torch.Generator().manual_seed(25)
    q, k, v = (torch.randn(2, 2048, h, 64, generator=g).to(cuda, dtype)
               .transpose(1, 2) for h in (32, 8, 8))
    route = "simt" if dtype == torch.float32 else "mma"
    got, o, lse, do = _bwd_close(f"cuda.flash_bwd.llama2048.{route}", q, k,
                                 v, route=route)
    again = flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,sq,kv,want", [
    (torch.float32, 77, None, "simt"), (torch.float32, 1, [1, 0, 200], "simt"),
    (torch.bfloat16, 77, None, "mma"), (torch.bfloat16, 9, [9, 40, 200],
                                        "mma"),
    (torch.bfloat16, 1, [1, 0, 200], "split"),
    (torch.bfloat16, 2, [2, 130, 0], "split"),
])
def test_flash_forward_lse_on_every_route(cuda, dtype, sq, kv, want):
    """Each forward route's lse (``return_lse=True``) against the plain
    version's on f32 copies: within 1e-5 absolute for f32 inputs and 1e-4
    for bf16 ones (both sum exp in f32 from the same inputs, in another
    order); a row with no visible key (kv_len 0, or Sq > Skv) gives
    ``NEG_INF`` on both sides.  The output equals the call without lse,
    bit for bit."""
    from repro_torch.kernels.flash_attention import (NEG_INF,
                                                     flash_attention_plain)
    hkv, group = 2, 4
    skv = 200 if kv is not None else 60
    q, k, v = _attn_inputs(sq + skv, 3, hkv * group, hkv, sq, skv, 64, 64,
                           dtype, cuda)
    kw = {"causal": True}
    if kv is not None:
        kw["kv_len"] = torch.tensor(kv, dtype=torch.int32, device=cuda)
    out, lse = _routed(q, k, v, want, return_lse=True, **kw)
    plain_out = _routed(q, k, v, want, **kw)
    assert torch.equal(out, plain_out)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    _, want_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                        return_lse=True, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    assert_parity(f"cuda.flash.lse.{want}.{str(dtype)[6:]}.sq{sq}", lse,
                  want_lse, tol)
    assert torch.equal(lse == NEG_INF, want_lse == NEG_INF)

