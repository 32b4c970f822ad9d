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


@pytest.mark.parametrize("m,n,d", [(257, 131, 3952), (1, 33, 17),
                                   (64, 64, 32), (70, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_similarity_kernel_matches_plain(cuda, m, n, d, dtype):
    rng = np.random.default_rng(m + n + d)
    ra = torch.from_numpy(int_ratings(rng, m, d)).to(cuda, dtype)
    rb = torch.from_numpy(int_ratings(rng, n, d)).to(cuda, dtype)
    for measure in ("jaccard", "cosine", "pcc", "pcc_sig", "all"):
        before = fused_similarity.launches
        got = fused_similarity(ra, rb, measure=measure, beta=7.3)
        assert fused_similarity.launches == before + 1
        want = similarity_plain(ra, rb, measure=measure, beta=7.3)
        torch.cuda.synchronize()
        if measure != "all":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert_parity(f"cuda.similarity.{measure}.{m}x{n}x{d}", g, w)


def test_similarity_kernel_rejects_bad_inputs(cuda):
    a = torch.ones(4, 8, device=cuda)
    with pytest.raises(TypeError):
        fused_similarity(a.double(), a.double())
    with pytest.raises(ValueError):
        fused_similarity(a.T, a.T)               # not contiguous
    with pytest.raises(ValueError):
        fused_similarity(a, a.cpu())


@pytest.mark.parametrize("k", [1, 7, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_tile_predict_kernel_matches_plain(cuda, k, dtype):
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
    src = r.to(dtype)
    for lo, hi in ((0, 700), (512, 700), (3, 260)):
        got = fused_tile_predict(src, ids, w, nbm, qm, lo, hi)
        want = tile_predict_plain(src, ids, w, nbm, qm, lo, hi)
        torch.cuda.synchronize()
        assert_parity(f"cuda.tile_predict.k{k}.[{lo},{hi})", got, want)


def test_engine_backends_agree_on_card(cuda):
    rng = np.random.default_rng(3)
    r = int_ratings(rng, 300, 200)
    seq = CFEngine(r, k=12, block_size=128, backend="sequential",
                   device="cuda").fit()
    ker = CFEngine(r, k=12, block_size=128, backend="kernel",
                   device="cuda").fit()
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
