"""Port parity: the scan/select top-M kernels' plain paths against the
JAX reference's canonical oracle, on the CPU.

On small-integer-valued proxies every dot product is exact in any order,
so ids and values are compared bit for bit against
``repro.kernels.ref.scan_topm_ref`` / ``select_topm_ref`` — duplicated
pool rows (exact ties across merge blocks), knockouts, m ≥ N and the
sentinel id N included.  On random unit proxies the two packages sum in
different orders: values within 1e-6, ids tie-aware (a mismatch only where
the two candidates' scores at the cut are within 1e-6, computed and
asserted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, to_np
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.select import (fused_scan_topm, scan_topm_twin,
                                        select_topm, smallest_k,
                                        topk_canonical)


def _int_case(rng, q_n, n, p, dup=1):
    q = rng.integers(-3, 4, (q_n, p)).astype(np.float32)
    prox = rng.integers(-3, 4, (n // dup, p)).astype(np.float32)
    return q, np.repeat(prox, dup, axis=0)


@pytest.mark.parametrize("q_n,n,p,m,dup", [
    (37, 300, 24, 17, 1), (8, 64, 16, 17, 1), (130, 257, 33, 17, 1),
    (21, 240, 12, 25, 8), (9, 40, 8, 999, 1), (12, 12, 6, 12, 1),
])
def test_scan_topm_bitwise_on_exact_inputs(q_n, n, p, m, dup):
    rng = np.random.default_rng(q_n + n)
    q, prox = _int_case(rng, q_n, n, p, dup)
    q_ids = np.arange(q_n, dtype=np.int32)
    q_ids[::5] = n                              # padding rows: no knockout
    got_v, got_i = fused_scan_topm(torch.from_numpy(q),
                                   torch.from_numpy(prox),
                                   torch.from_numpy(q_ids), m=m)
    want_v, want_i = jref.scan_topm_ref(jnp.asarray(q), jnp.asarray(prox),
                                        jnp.asarray(q_ids), m)
    name = f"select.scan.{q_n}x{n}x{p}.m{m}.dup{dup}"
    assert_parity(name + ".ids", got_i, want_i)
    assert_parity(name + ".vals", got_v, want_v)
    assert got_i.shape == (q_n, min(m, n)) and got_i.dtype == torch.int32
    # knocked-out self pairs surface as (-inf, N), never as the row itself
    for row in range(q_n):
        if q_ids[row] < n:
            live = got_i[row][torch.isfinite(got_v[row])]
            assert int(q_ids[row]) not in live.tolist()


def test_scan_topm_all_dead_rows_carry_the_sentinel():
    """m > finite scores: the starved slots are -inf with id N."""
    q = np.ones((3, 4), np.float32)
    prox = np.ones((5, 4), np.float32)
    v, i = fused_scan_topm(torch.from_numpy(q), torch.from_numpy(prox),
                           torch.tensor([0, 1, 2], dtype=torch.int32), m=5)
    assert torch.isneginf(v[:, -1]).all() and (i[:, -1] == 5).all()
    assert_parity("select.scan.starved",
                  i, jref.scan_topm_ref(jnp.asarray(q), jnp.asarray(prox),
                                        jnp.arange(3), 5)[1])


@pytest.mark.parametrize("q_n,n,m", [(19, 140, 23), (7, 30, 64),
                                     (40, 513, 128)])
def test_select_topm_bitwise_against_oracle(q_n, n, m):
    rng = np.random.default_rng(n)
    scores = rng.integers(-4, 5, (q_n, n)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.1] = -np.inf
    scores[2] = -np.inf                          # an all-knocked-out row
    none = torch.full((q_n,), -1, dtype=torch.int32)
    got_v, got_i = select_topm(torch.from_numpy(scores), none, m=m)
    want_v, want_i = jref.select_topm_ref(jnp.asarray(scores), m)
    assert_parity(f"select.select.{q_n}x{n}.m{m}.ids", got_i, want_i)
    assert_parity(f"select.select.{q_n}x{n}.m{m}.vals", got_v, want_v)
    assert (got_i[2] == n).all()


def test_select_topm_applies_q_id_knockout():
    scores = torch.arange(12, dtype=torch.float32).repeat(3, 1)
    v, i = select_topm(scores, torch.tensor([11, -1, 10],
                                            dtype=torch.int32), m=2)
    assert i.tolist() == [[10, 9], [11, 10], [11, 9]]


def _assert_tie_aware(name, got_v, got_i, want_v, want_i, scores, tol):
    """Ids equal, except where the two candidates at a mismatching slot
    score within ``tol`` of each other (computed from ``scores``)."""
    got_i, want_i, scores = to_np(got_i), to_np(want_i), to_np(scores)
    assert_parity(name + ".vals", got_v, want_v, atol=tol)
    bad = 0
    for row, col in zip(*np.nonzero(got_i != want_i)):
        a, b = got_i[row, col], want_i[row, col]
        assert abs(scores[row, a] - scores[row, b]) <= tol, (name, row, a, b)
        bad += 1
    print(f"PARITY {name}.ids mismatches_at_near_ties={bad}")


@pytest.mark.parametrize("q_n,n,p,m", [(37, 300, 24, 17), (64, 500, 48, 90)])
def test_scan_topm_random_proxies_tie_aware(q_n, n, p, m):
    rng = np.random.default_rng(p)
    # unit rows, as the index's proxies are (scores in [-1, 1])
    q = rng.normal(size=(q_n, p)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    prox = rng.normal(size=(n, p)).astype(np.float32)
    prox /= np.linalg.norm(prox, axis=1, keepdims=True)
    q_ids = np.arange(q_n, dtype=np.int32)
    got_v, got_i = fused_scan_topm(torch.from_numpy(q),
                                   torch.from_numpy(prox),
                                   torch.from_numpy(q_ids), m=m)
    want_v, want_i = jref.scan_topm_ref(jnp.asarray(q), jnp.asarray(prox),
                                        jnp.asarray(q_ids), m)
    _assert_tie_aware(f"select.scan_normal.{q_n}x{n}x{p}", got_v, got_i,
                      want_v, want_i, q.astype(np.float64) @ prox.T.astype(
                          np.float64), 1e-6)


def test_proxy_scores_are_row_independent():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(50, 40)).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(70, 40)).astype(np.float32))
    full = ref.proxy_scores_ref(q, p)
    assert torch.equal(ref.proxy_scores_ref(q[[4, 9]], p), full[[4, 9]])
    assert torch.equal(ref.proxy_scores_ref(q, p[:33])[:, :33], full[:, :33])
    assert_parity("select.proxy_scores_vs_matmul", full, q @ p.T, atol=1e-5)


def test_twin_and_helpers():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    ids = torch.arange(6, dtype=torch.int32)
    a = scan_topm_twin(q, p, ids, m=50)
    b = fused_scan_topm(q, p, ids, m=50)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(NotImplementedError):
        scan_topm_twin(q, p, ids, m=5, approx=True)
    d = torch.tensor([[3.0, 1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0]])
    v, i = smallest_k(d, 3)
    assert i.tolist() == [[3, 1, 2], [0, 1, 2]] and v[0, 0] == 0.5
    s, j = topk_canonical(torch.tensor([[1.0, 2.0, 2.0, 0.0]]),
                          torch.tensor([[7, 9, 3, 1]], dtype=torch.int32), 3)
    assert j.tolist() == [[3, 9, 7]] and s.tolist() == [[2.0, 2.0, 1.0]]


def test_wrappers_reject_bad_input():
    q = torch.zeros(4, 3)
    ids4, ids3 = (torch.zeros(n, dtype=torch.int32) for n in (4, 3))
    with pytest.raises(ValueError):
        fused_scan_topm(q, torch.zeros(5, 2), ids4, m=2)
    with pytest.raises(ValueError):
        fused_scan_topm(q, torch.zeros(5, 3), ids3, m=2)
    with pytest.raises(ValueError):
        select_topm(torch.zeros(4), torch.zeros(4, dtype=torch.int32), m=2)


@pytest.mark.parametrize("p", [1, 12, 33, 255])
def test_proxy_scores_zero_padding_keeps_bits(p):
    """The scan kernel stages P in 16-byte copies, so the wrapper pads the
    proxy rows with zeros to a multiple of 4 (and the kernel's last K
    slice is zero-filled): each pad adds 0·0 = +0 to a sum that starts at
    +0 and so is never −0, which leaves every score's bits as they are —
    infinities and NaN included."""
    rng = np.random.default_rng(p)
    q = rng.normal(size=(7, p)).astype(np.float32)
    prox = rng.normal(size=(30, p)).astype(np.float32)
    q[1] = 0.0
    prox[2, 0] = np.inf
    prox[3, 0] = -np.inf
    prox[4, 0] = np.nan
    prox[5] = -0.0
    qt, pt = torch.from_numpy(q), torch.from_numpy(prox)
    want = ref.proxy_scores_ref(qt, pt)
    pad = (0, -(-p // 32) * 32 - p)
    got = ref.proxy_scores_ref(torch.nn.functional.pad(qt, pad),
                               torch.nn.functional.pad(pt, pad))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not bool((want.view(torch.int32) == -2 ** 31).any())  # no −0.0
