"""Clustered candidate-generation index: sublinear two-stage neighbor
search (port of ``repro.index.clustered``).

Exact all-pairs neighbor search costs O(U²·D).  :class:`ClusteredIndex`
makes candidate generation cheap while keeping the scoring stage exact:

1. **Project** — a seeded randomized-SVD basis (numpy, on the host) maps
   each user's (mean-centered) unit rating row to a ``project_dim``-dim
   unit *proxy* vector.
2. **Cluster** — blocked k-means (``repro_torch.index.kmeans``) partitions
   the proxies; each user is *spill-assigned* to its ``spill`` nearest
   clusters.
3. **Probe** — a query shortlists its ``n_probe`` nearest clusters by
   centroid distance (the CUDA centroid-distance kernel).
4. **Shortlist** — the best ``rerank_frac · U`` candidates by proxy score.
5. **Rerank** — the shortlist is scored with the *true* measure, so
   returned neighbors carry exact similarity scores.

Two orchestrations, as in the reference (``IndexConfig.query_mode``):

* ``"fused"`` — per query block the stages chain through device memory:
  the full pool through the CUDA scan/select kernel or the probed
  clusters' members through the CUDA select kernel, then the block's
  candidate union through the CUDA co-rated Gram rerank kernel;
* ``"staged"`` — shortlists return to the host between the scan and the
  rerank.  The scan is the same device scan (``"kernel"``), a host proxy
  GEMM over the pool (``"pool"``, with the symmetric-pair variant over the
  full population) or over the probed clusters' members (``"cluster"``);
  the rerank is the grouped union-Gram pass (``"grouped"``: the CUDA
  rerank kernel on the card) or the CSR-bucketed gather walk
  (``"gather"``).

``"auto"`` resolves to fused where the kernels run and to staged
elsewhere; ``query_mode_override`` (set by the serving degradation
ladder) wins over both.  With ``n_probe == n_clusters`` and
``rerank_frac == 0`` every probed member is reranked through the exact
engines' ``pairwise_similarity`` and canonical sort: the result is
bit-identical to their top-k.  Every mode implements the canonical
``(-score, id)`` selection, so shortlists agree wherever candidate pools
and proxy scores coincide; on integer ratings every Gram statistic is an
exact f32 integer, so the reranks agree bit for bit.

Every kernel has a plain version with the same arithmetic order
(``IndexConfig(use_kernel=False)`` runs them on the card), and the index
keeps a row's features, proxy and distances independent of the batch it
is computed in (fixed-order sums) — which ``refold``'s certificate and
``check_consistent`` rely on.

Consistency under rating updates: ``refold`` refolds the touched rows'
proxies and centroid mass and repairs spill assignments exactly against
the moved centroids (a row keeps its cluster list when it owns no moved
cluster and no moved centroid beats its cached spill distances; every
other row gets a full distance row).  After ``refold`` the spill lists
equal a cold reassignment against the current centroids
(``check_consistent`` asserts it, bit for bit).  The derived per-ratings
caches (gather operand, host CSR, pair tables) are delta-patched along
the ratings version chain.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

try:                # survivor grouping in the symmetric scan: scipy's
                    # COO→CSR is the O(n) counting sort (np.lexsort
                    # fallback below when absent)
    import scipy.sparse as _scipy_sparse
except ImportError:  # pragma: no cover - both hosts ship scipy
    _scipy_sparse = None

from repro_torch import obs
from repro_torch.core import neighbors as nb
from repro_torch.core import predict as pred_mod
from repro_torch.core import similarity as sim
from repro_torch.index.kmeans import (KMeansStats, center_rows, kmeans,
                                      normalize_rows)
from repro_torch.kernels import select as sel_mod
from repro_torch.kernels.cluster import centroid_distances
from repro_torch.kernels.ref import proxy_scores_ref
from repro_torch.kernels.rerank import (fused_rerank_scores,
                                        rerank_scores_plain)

RERANK_MODES = ("auto", "gather", "grouped")
SCAN_MODES = ("auto", "pool", "cluster", "kernel")
QUERY_MODES = ("auto", "staged", "fused")

# symmetric-pair scan (the reference's constants): each unordered
# query-block pair's P·Pᵀ GEMM runs once and is consumed for both sides;
# per-row thresholds are oversampled so the expected survivor count is
# _SYM_OVERSAMPLE·M, and the path gates on the survivor arrays' bytes
_SYM_OVERSAMPLE = 1.5
_SYM_MAX_BYTES = 8 << 30
# auto prefers the plain streaming scan at rerank budgets past this
# fraction of the pool (the threshold filter stops being selective)
_SYM_FRAC_MAX = 0.06
# fat-budget degrade levels of the threshold oversample, and the survivor
# compaction that bounds peak memory at any level
_SYM_LEVELS = (1.5, 1.25, 1.1)
_SYM_COMPACT_FACTOR = 2
_SYM_COMPACT_MIN = 256         # per-row floor: never fold tiny panels

# gather-mode rerank: queries per call, and the byte budget of the
# (b, M, nnz) gather intermediate
_RERANK_BMAX = 1024
_RERANK_BUDGET = 512 << 20
# support split: queries rating more than this many items score their
# pairs through the pair-major min-side pass
_REHOME_NNZ = 128
_PAIR_BLOCK = 32768            # pair-major pass: pairs per call


def _bucket(n: int, cap: int = 1 << 30) -> int:
    """Next power of two ≥ n (≥ 8), capped — bounds distinct shapes."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Tuning knobs for :class:`ClusteredIndex` (the reference's fields
    and defaults).

    Auto values: ``n_clusters = 0`` → ``⌈√U⌉``; ``n_probe = 0`` → half the
    clusters, rounded up.  ``project_dim`` is clamped to the item count;
    ``0`` disables the projection.  ``rerank_frac = 0`` disables the proxy
    shortlist: every probed member is exactly reranked (the bit-exact
    degenerate mode).  ``use_kernel=None`` runs the CUDA kernels on CUDA
    tensors; ``False`` runs their plain versions on any device.
    ``interpret`` is the reference's Pallas interpret mode: validated,
    with no effect here.
    """
    n_clusters: int = 0
    n_probe: int = 0
    seed: int = 0
    iters: int = 8
    features: str = "centered"            # "centered" (pcc geometry) |
                                          # "raw" (cosine/jaccard geometry)
    project_dim: int = 256
    spill: int = 2
    rerank_frac: float = 0.15
    kmeans_block: int = 2048
    query_block: int = 256
    use_kernel: Optional[bool] = None
    interpret: bool = False
    # staged rerank: "grouped" — queries grouped by taste cluster, each
    # group's candidate union scored once (the CUDA rerank kernel on the
    # card, its plain version elsewhere); "gather" — queries bucketed by
    # rated-item support, the (M, nnz) co-rated gather walk; "auto" —
    # grouped where the kernels run or at budgets ≥ 8 % of the pool,
    # gather below
    rerank_mode: str = "auto"
    rerank_batch: int = 256               # grouped-mode queries per union
    # "kernel": the full-pool device scan (the CUDA scan/select kernel);
    # "pool": the host proxy GEMM over the pool (the symmetric-pair scan
    # over the full population), the block-union scan when probing does
    # not saturate; "cluster": the probed clusters' members; "auto":
    # kernel where the kernels run, else pool when n_probe·spill
    # saturates the clusters, cluster below
    shortlist_scan_mode: str = "auto"
    # None → auto (the symmetric scan on full-population host pool scans
    # at selective budgets), False → never, True → force it (raises where
    # it cannot run: subset queries, a non-pool scan, the fused mode)
    scan_symmetric: Optional[bool] = None
    # "staged" | "fused" | "auto" (fused where the kernels run, staged
    # elsewhere) — see the module docstring
    query_mode: str = "auto"
    refit_reassign_frac: float = 0.5


@dataclasses.dataclass
class QueryStats:
    """Work accounting for one ``query`` call."""
    n_queries: int
    n_users: int           # candidate population the fractions refer to
    n_probed: int          # probed-member rows summed over queries
    n_reranked: int        # rows exactly reranked (true similarity)
    seconds_shortlist: float = 0.0   # probe + proxy scan + selection and
                                     # every other non-rerank cost
                                     # (total − rerank)
    seconds_rerank: float = 0.0      # exact rerank stage (measured)
    seconds_total: float = 0.0       # shortlist + rerank, by construction
    rerank_mode: str = ""            # "gather" | "grouped" | "fused"
    scan_mode: str = ""              # resolved shortlist scan mode
    query_mode: str = ""             # "staged" | "fused"
    scan_gate: str = ""              # "sym:on:level=…" when the symmetric
                                     # scan ran, "sym:off:<reason>" when
                                     # another scan ran ("" without a scan)

    def _frac(self, total: int) -> float:
        pairs = self.n_queries * max(self.n_users - 1, 1)
        return total / max(pairs, 1)

    @property
    def probed_fraction(self) -> float:
        """Proxy-scanned candidates per query over all possible pairs."""
        return self._frac(self.n_probed)

    @property
    def rerank_fraction(self) -> float:
        """Exactly-reranked rows per query over all possible pairs."""
        return self._frac(self.n_reranked)


@dataclasses.dataclass
class RefoldStats:
    """What one ``refold`` call did."""
    n_touched: int
    n_changed_clusters: int
    n_reassigned: int      # rows whose spill list actually changed
    n_full_rows: int       # rows needing a full distance row
    n_certified: int       # rows kept/merged by the cheap certificate
    reassigned_frac: float = 0.0   # cumulative reassigned/rows since fit
    caches_patched: int = 0        # derived per-ratings caches refreshed
                                   # by the delta (vs rebuilt on next use)
    refit: bool = False            # crossed the drift threshold: cold refit
    profile_refold: bool = False   # item index: profiles re-folded cold


def _featurize(ratings, means, *, features, spherical=True):
    """The index's feature map: (centered|raw), unit rows."""
    z = center_rows(ratings, means) if features == "centered" else ratings
    return normalize_rows(z) if spherical else z


def _project(z, basis):
    """Unit proxy vectors: project then re-normalize.  The product sums
    over the feature axis in order d = 0..D−1 (separately rounded), so a
    row's proxy does not depend on the rows projected with it."""
    zt = z.T.contiguous()
    acc = torch.zeros((z.shape[0], basis.shape[1]), dtype=torch.float32,
                      device=z.device)
    for d in range(zt.shape[0]):
        acc = acc + zt[d][:, None] * basis[d][None, :]
    return normalize_rows(acc)


def _svd_basis(z: np.ndarray, dim: int, seed: int) -> np.ndarray:
    """Seeded randomized range-finder SVD basis, (D, dim), deterministic:
    two matmul passes + a small QR/SVD on the host, in numpy (the
    reference's function, copied)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(z.shape[1], min(dim + 16, z.shape[1]))
                   ).astype(np.float32)
    q, _ = np.linalg.qr(z @ g)
    _, _, vt = np.linalg.svd(q.T @ z, full_matrices=False)
    return np.ascontiguousarray(vt[:dim].T)


def _spill_assign(proxies, centroids, *, spill, block_size, use_kernel):
    """Canonical top-``spill`` clusters (ids + distances) per proxy row,
    nearest first, ties to the lowest cluster id."""
    ids, dist = [], []
    for b0 in range(0, proxies.shape[0], block_size):
        d = centroid_distances(proxies[b0:b0 + block_size], centroids,
                               use_kernel=use_kernel)
        v, i = sel_mod.smallest_k(d, spill)
        ids.append(i)
        dist.append(v)
    return torch.cat(ids), torch.cat(dist)


def _probe_clusters(proxies, centroids, q_ids, *, n_probe, use_kernel):
    """Nearest ``n_probe`` cluster ids for each (padded) query row."""
    zq = proxies[q_ids.clamp(0, proxies.shape[0] - 1)]
    d = centroid_distances(zq, centroids, use_kernel=use_kernel)
    return sel_mod.smallest_k(d, n_probe)[1]


def _argpartition_rows(sp: np.ndarray, m: int) -> np.ndarray:
    """Row-wise top-m argpartition, split over two host threads (numpy's
    partition releases the GIL).  Partitions the *upper* side instead of
    negating the matrix.  Returns the selected column ids (tie order at
    the cut is whatever introselect leaves — :func:`_topm_rows` repairs
    it); ``m >= width`` selects every column."""
    n, w = sp.shape
    if m >= w:
        return np.broadcast_to(np.arange(w), (n, w)).copy()
    kth = w - m
    if n < 64:
        return np.argpartition(sp, kth, axis=1)[:, kth:]
    from concurrent.futures import ThreadPoolExecutor
    half = n // 2
    with ThreadPoolExecutor(max_workers=2) as pool:
        top = pool.submit(np.argpartition, sp[:half], kth, 1)
        bot = np.argpartition(sp[half:], kth, axis=1)
        return np.concatenate([top.result()[:, kth:], bot[:, kth:]], axis=0)


def _topm_rows(sp: np.ndarray, m: int,
               col_ids: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical row-wise top-``m`` of a host score matrix: ``(values,
    column ids)``, the selection set under the exact engines' ``(-score,
    id)`` order.

    ``torch.topk`` (or the threaded argpartition on an empty matrix)
    picks an *arbitrary* subset of a tie group straddling the cut, so a
    boundary repair follows: rows whose cut value also appears just below
    the cut are re-selected canonically — everything strictly above the
    cut stays, and the tie group gives its lowest candidate ids
    (``col_ids`` maps columns to candidate ids when the column order is
    not ascending by id).  ``-inf`` columns may be selected when a row has
    fewer than ``m`` finite scores; callers map them to their padding id.
    ``m >= width`` returns every column.  Order within the selection is
    unspecified."""
    n, w = sp.shape
    if m >= w:
        ids = np.broadcast_to(np.arange(w), (n, w)).copy()
        return sp.copy(), ids
    if m == 0:
        return (np.empty((n, 0), np.float32), np.empty((n, 0), np.int64))
    if n:
        sp_t = sp if isinstance(sp, torch.Tensor) else torch.from_numpy(sp)
        v1, i1 = torch.topk(sp_t, m + 1, dim=1, sorted=True)
        v1, i1 = v1.numpy(), i1.numpy()
        selv, sel = v1[:, :m].copy(), i1[:, :m].astype(np.int64)
        cut, below = v1[:, m - 1], v1[:, m]
    else:
        sel1 = _argpartition_rows(sp, m + 1)                  # (n, m+1)
        v1 = np.take_along_axis(sp, sel1, 1)
        drop = v1.argmin(axis=1)                              # (m+1)-th best
        below = v1[np.arange(n), drop]
        keep = np.arange(m + 1)[None, :] != drop[:, None]
        sel = sel1[keep].reshape(n, m)
        selv = v1[keep].reshape(n, m)
        cut = selv.min(axis=1) if m else below
    # canonical boundary repair: only rows whose cut value is tied across
    # the selection boundary need the full-row pass
    need = np.nonzero((below == cut) & np.isfinite(cut))[0]
    for row in need:
        above = np.nonzero(sp[row] > cut[row])[0]
        tied = np.nonzero(sp[row] == cut[row])[0]
        if col_ids is not None:       # canonical order is by candidate id
            tied = tied[np.argsort(col_ids[tied], kind="stable")]
        tied = tied[:m - len(above)]
        sel[row, :len(above)] = above
        sel[row, len(above):len(above) + len(tied)] = tied
        selv[row] = sp[row, sel[row]]
    return selv, sel


def _patch_csr(csr, touched: np.ndarray, rows_new: np.ndarray):
    """Row-splice a host CSR for a rating delta: ``touched`` (sorted
    unique row ids) get fresh rows from the dense ``rows_new`` (T, I)
    slab; every untouched row's span is bulk-copied — O(nnz) memcpy per
    delta instead of a cold rebuild's full ``np.nonzero`` scan."""
    indptr, indices, data = csr
    n_rows = len(indptr) - 1
    rr, cc = np.nonzero(rows_new)
    t_lens = np.bincount(rr, minlength=len(touched)).astype(np.int64)
    t_off = np.cumsum(t_lens) - t_lens
    t_vals = rows_new[rr, cc].astype(data.dtype)
    counts = np.diff(indptr)
    counts[touched] = t_lens
    indptr_new = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=indptr_new[1:])
    idx_new = np.empty(indptr_new[-1], indices.dtype)
    data_new = np.empty(indptr_new[-1], data.dtype)
    prev = 0
    for t_pos, t in enumerate(touched):
        if t > prev:        # bulk-copy the untouched run [prev, t)
            idx_new[indptr_new[prev]:indptr_new[t]] = \
                indices[indptr[prev]:indptr[t]]
            data_new[indptr_new[prev]:indptr_new[t]] = \
                data[indptr[prev]:indptr[t]]
        lo, n = indptr_new[t], t_lens[t_pos]
        src = slice(t_off[t_pos], t_off[t_pos] + n)
        idx_new[lo:lo + n] = cc[src].astype(indices.dtype)
        data_new[lo:lo + n] = t_vals[src]
        prev = t + 1
    if prev < n_rows:
        idx_new[indptr_new[prev]:] = indices[indptr[prev]:]
        data_new[indptr_new[prev]:] = data[indptr[prev]:]
    return indptr_new, idx_new, data_new


def _sym_group(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               nv: int, n: int):
    """COO survivor triplets → CSR groups per row with ascending candidate
    ids (an O(n) counting sort), so the padded table is canonical for the
    tie repair.  ``(rows, cols)`` pairs are unique by construction."""
    if _scipy_sparse is not None:
        a = _scipy_sparse.coo_matrix((vals, (rows, cols)),
                                     shape=(nv, n)).tocsr()
        return a.indptr, a.indices, a.data
    order = np.lexsort((cols, rows))
    indptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(rows[order], minlength=nv), out=indptr[1:])
    return indptr, cols[order], vals[order]


def _sym_pad(indptr, grp_i, grp_v, nv: int, n: int):
    """CSR survivor groups → padded ``(nv, w)`` value/id tables
    (``-inf`` / sentinel-``n`` padding) ready for ``_topm_rows``."""
    cnt = np.diff(indptr)
    w = max(int(cnt.max()), 1)
    padv = np.full((nv, w), -np.inf, np.float32)
    padi = np.full((nv, w), n, np.int32)
    rr = np.repeat(np.arange(nv), cnt)
    within = np.arange(len(grp_v)) - np.repeat(
        indptr[:-1].astype(np.int64), cnt)
    padv[rr, within] = grp_v
    padi[rr, within] = grp_i
    return padv, padi


def _user_norms_counts(ratings):
    """Per-user full-row L2 norms (correctly rounded root) and rated-item
    counts (one cheap pass)."""
    return (sim._sqrt((ratings * ratings).sum(-1)),
            (ratings > 0).sum(-1).float())


def _topk_with_padding(s, ids, k, n):
    """Canonical top-``k`` of (b, w) scores/ids, padding to ``k`` columns
    with (NEG_INF, n) first; NEG_INF slots surface as id -1, the exact
    engines' padding convention."""
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.cat([s, s.new_full((s.shape[0], pad), nb.NEG_INF)], 1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), n)], 1)
    top_s, top_i = sel_mod.topk_canonical(s, ids, k)
    return top_s, torch.where(top_s <= nb.NEG_INF,
                              torch.full_like(top_i, -1), top_i)


def _rerank_shared(ratings, q_ids, cand_ids, allowed, *, k, measure,
                   beta=sim.PCC_SIG_BETA):
    """Exact top-k over a block-shared candidate set (the unfiltered
    path): the exact engines' ``pairwise_similarity`` Gram pass and
    canonical sort — what makes ``n_probe == n_clusters`` bit-identical to
    ``block_topk``.  Padding/self/unprobed pairs get NEG_INF."""
    n_users = ratings.shape[0]
    q = ratings[q_ids.clamp(0, n_users - 1)]
    cand = ratings[cand_ids.clamp(0, n_users - 1)]
    s = sim.pairwise_similarity(q, cand, measure=measure, beta=beta)
    invalid = (~allowed) | (cand_ids[None, :] >= n_users) | \
              (cand_ids[None, :] == q_ids[:, None])
    s = s.masked_fill(invalid, nb.NEG_INF)
    ids = cand_ids.to(torch.int32)[None, :].expand(s.shape[0], -1)
    return _topk_with_padding(s, ids, k, n_users)


def _pcc_scores(n, dot, sum_a, sum_b, sq_a, sq_b, *, measure, beta):
    """pcc / pcc_sig over co-rated items from the six Gram sums,
    normalised to [0, 1] (the reference's epilogue order, correctly
    rounded root)."""
    eps = 1e-8
    cov = n * dot - sum_a * sum_b
    var_a = n * sq_a - sum_a * sum_a
    var_b = n * sq_b - sum_b * sum_b
    denom = sim._sqrt(var_a.clamp_min(0.0) * var_b.clamp_min(0.0))
    valid = (n >= 2) & (denom > eps)
    pcc = (cov / denom.clamp_min(eps)).clamp(-1.0, 1.0)
    s = torch.where(valid, (pcc + 1.0) * 0.5, torch.zeros_like(pcc))
    if measure == "pcc_sig":
        b = torch.full((), beta, dtype=torch.float32, device=n.device)
        s = s * (n.clamp_max(beta) / b)
    return s


def _rerank_sparse(r_gather, norms, counts, q_ids, q_items, q_vals,
                   cand_ids, *, k, measure, beta=sim.PCC_SIG_BETA):
    """Exact top-k over per-query candidate lists via the co-rated gather.

    Every similarity term between a query and a candidate lives on the
    query's *rated* items, so the (b, M, nnz) sub-block ``ratings[cand,
    items_q]`` is gathered instead of full (M, D) rows.  ``r_gather`` is
    the rating matrix as the gather source (int8 when exact).
    ``q_items`` / ``q_vals``: (b, nnz) the query's rated item ids and
    values, zero-padded (a zero value knocks the slot out of every term).
    ``cand_ids``: (b, M) global ids, padding = ``n_users``.  Selection is
    the canonical ``(-score, id)`` sort; NEG_INF slots surface as id -1.
    """
    n_users = r_gather.shape[0]
    safe_c = cand_ids.long().clamp(0, n_users - 1)
    rc = r_gather[safe_c[:, :, None],
                  q_items.long()[:, None, :]].float()        # (b, M, nnz)
    vq = q_vals                                              # (b, nnz)
    vq_pos = (vq > 0).float()
    mc = (rc > 0).float()

    def pe(a, v):
        return torch.einsum("bmn,bn->bm", a, v)

    eps = 1e-8
    if measure == "cosine":
        dot = pe(rc, vq)
        nq = sim._sqrt((vq * vq).sum(-1))[:, None]
        s = dot / (nq * norms[safe_c]).clamp_min(eps)
    elif measure == "jaccard":
        n = pe(mc, vq_pos)
        union = vq_pos.sum(-1)[:, None] + counts[safe_c] - n
        s = n / union.clamp_min(eps)
    else:
        s = _pcc_scores(pe(mc, vq_pos), pe(rc, vq), pe(mc, vq),
                        pe(rc, vq_pos), pe(mc, vq * vq),
                        pe(rc * rc, vq_pos), measure=measure, beta=beta)
    invalid = (cand_ids >= n_users) | (cand_ids == q_ids[:, None])
    s = s.masked_fill(invalid, nb.NEG_INF)
    return _topk_with_padding(s, cand_ids.to(torch.int32), k, n_users)


def _pair_scores_sparse(r_gather, norms, counts, tbl_items, tbl_vals,
                        w_local, w_ids, v_ids, *, measure,
                        beta=sim.PCC_SIG_BETA):
    """Exact similarity of independent (walk, other) user pairs: the
    pair-major leg of the support-split rerank, each pair walking the
    *thinner* side's rated items.  ``tbl_items`` / ``tbl_vals``: the walk
    bucket's padded per-user tables (rows ``w_local``); ``w_ids`` /
    ``v_ids``: global ids of the walk / other side.  The statistics are
    symmetric in the pair and exact integers on integer ratings, so which
    side walks cannot change the score.  Returns (P,) scores."""
    n_users = r_gather.shape[0]
    it = tbl_items[w_local]                                  # (P, nnz)
    vq = tbl_vals[w_local]
    safe_v = v_ids.long().clamp(0, n_users - 1)
    rc = r_gather[safe_v[:, None], it.long()].float()        # (P, nnz)
    vq_pos = (vq > 0).float()
    mc = (rc > 0).float()
    eps = 1e-8
    if measure == "cosine":
        dot = (rc * vq).sum(-1)
        return dot / (norms[w_ids] * norms[safe_v]).clamp_min(eps)
    if measure == "jaccard":
        n = (mc * vq_pos).sum(-1)
        union = counts[w_ids] + counts[safe_v] - n
        return n / union.clamp_min(eps)
    return _pcc_scores((mc * vq_pos).sum(-1), (rc * vq).sum(-1),
                       (mc * vq).sum(-1), (rc * vq_pos).sum(-1),
                       (mc * vq * vq).sum(-1), (rc * rc * vq_pos).sum(-1),
                       measure=measure, beta=beta)


# -- fused query pipeline (device-resident stage chain) -----------------------

def _fused_scan_pool(proxies, q_ids, *, m, use_kernel):
    """Device full-pool proxy scan of one query block: (Q,) padded global
    query ids → canonical top-``m`` ``(values, global shortlist ids)``,
    the sentinel id ``U`` on every ``-inf`` slot — the CUDA scan kernel,
    or its plain version.  Padded query rows (id ``U``) are sliced off by
    the caller."""
    n = proxies.shape[0]
    q = proxies[q_ids.clamp_max(n - 1)].contiguous()
    q_ids = q_ids.to(torch.int32).contiguous()
    if use_kernel:
        return sel_mod.fused_scan_topm(q, proxies, q_ids, m=m)
    return sel_mod.scan_topm_twin(q, proxies, q_ids, m=m)


def _fused_scan_restricted(proxies, cand_pad, q_ids, *, m, use_kernel):
    """Device cluster-restricted proxy scan of one query block.

    ``cand_pad``: (L,) *ascending* dup-free candidate ids (padding ``U``),
    so the block-local tie-break is the canonical global-id order.  The
    block's scores against the gathered candidate proxies (fixed-order
    sums) go through the CUDA select kernel or its plain version; the
    block-local selection maps back to global ids on the device, masking
    sentinels before the gather.
    """
    n = proxies.shape[0]
    big_l = cand_pad.shape[0]
    q = proxies[q_ids.clamp_max(n - 1)]
    cp = proxies[cand_pad.clamp_max(n - 1)]
    sp = proxy_scores_ref(q, cp)
    invalid = (cand_pad[None, :] >= n) | (cand_pad[None, :] == q_ids[:, None])
    sp = sp.masked_fill(invalid, float("-inf")).contiguous()
    none = torch.full(q_ids.shape, -1, dtype=torch.int32, device=q.device)
    if use_kernel:
        v, sel = sel_mod.select_topm(sp, none, m=m)
    else:
        v, sel = sel_mod.select_topm_twin(sp, none, m=m)
    shorts = torch.where(torch.isneginf(v),
                         torch.full_like(sel, n),
                         cand_pad.to(torch.int32)[sel.long().clamp_max(
                             big_l - 1)])
    return v, shorts


def _fused_rerank_block(r_gather, norms, counts, q_ids, shorts, *, k,
                        measure, beta, use_kernel, max_value=None):
    """Device union-Gram rerank of one query block's shortlists.

    ``q_ids`` / ``shorts``: the block's real query rows and their (b, M)
    global shortlist ids with sentinel ``U`` padding.  The block's sorted
    candidate union (the sentinel included when present) and the query
    rows are gathered once from ``r_gather`` (int8 when the ratings are
    int8-exact) and the whole (rows, union) slab is scored by the CUDA
    rerank kernel (its plain version with ``use_kernel=False``);
    ``max_value`` bounds |rating| for the kernel's int8 route.  Each
    query's own shortlist is restricted back out by ``searchsorted``, and
    the epilogue is the canonical ``(-score, id)`` sort with NEG_INF slots
    as id -1.
    """
    n = r_gather.shape[0]
    u = torch.unique(shorts.long())
    safe_u = u.clamp_max(n - 1)
    q_rows = r_gather[q_ids.long().clamp_max(n - 1)].contiguous()
    args = (q_rows, r_gather[safe_u].contiguous(),
            norms[safe_u].contiguous(), counts[safe_u].contiguous())
    if use_kernel:
        s = fused_rerank_scores(*args, measure=measure, beta=beta,
                                max_value=max_value)
    else:
        s = rerank_scores_plain(*args, measure=measure, beta=beta)
    # every real shortlist id is in the union, so searchsorted lands on
    # its column; sentinel slots are masked (the clamp is for them)
    col = torch.searchsorted(u, shorts.long()).clamp_max(u.numel() - 1)
    sc = torch.gather(s, 1, col)
    invalid = (shorts >= n) | (shorts == q_ids[:, None])
    sc = sc.masked_fill(invalid, nb.NEG_INF)
    ci = torch.where(invalid, torch.full_like(shorts, n), shorts)
    return _topk_with_padding(sc, ci.to(torch.int32), k, n)


class _SpillClusterCore:
    """Axis-agnostic core of the user-side :class:`ClusteredIndex` and the
    item-side :class:`repro_torch.index.item_index.ItemClusteredIndex`:
    k-means fit + spill assignment, the exact certificate-based refold of
    assignments and the centroid-mass ledger, the auto-refit drift guard,
    the ratings version chain with its per-ratings caches, and
    checkpointable state.  Subclasses hook their own per-ratings caches
    into the version chain (``_patch_extra_row_caches`` /
    ``_drop_extra_row_caches``) and their own state
    (``_extra_state`` / ``_load_extra_state``).

    Proxies and centroids live on the device; spill lists, distances and
    the mass ledger are host (numpy) arrays, as in the reference.
    """

    def __init__(self, cfg, mesh=None, mesh_axis: str = "data"):
        if cfg.features not in ("centered", "raw"):
            raise ValueError(f"unknown features {cfg.features!r}; "
                             "want 'centered' or 'raw'")
        if cfg.spill < 1:
            raise ValueError("spill must be ≥ 1")
        if getattr(cfg, "rerank_mode", "auto") not in RERANK_MODES:
            raise ValueError(f"unknown rerank_mode {cfg.rerank_mode!r}; "
                             f"want one of {RERANK_MODES}")
        if getattr(cfg, "shortlist_scan_mode", "auto") not in SCAN_MODES:
            raise ValueError(
                f"unknown shortlist_scan_mode {cfg.shortlist_scan_mode!r}; "
                f"want one of {SCAN_MODES}")
        if getattr(cfg, "query_mode", "auto") not in QUERY_MODES:
            raise ValueError(f"unknown query_mode {cfg.query_mode!r}; "
                             f"want one of {QUERY_MODES}")
        self.cfg = cfg
        self.mesh = mesh              # the k-means fit shards over this mesh
        self.mesh_axis = mesh_axis
        self.device = torch.device("cpu")
        self.n_rows = 0
        self.n_clusters = 0
        self.n_probe = 0
        self.basis: Optional[torch.Tensor] = None       # (D, p) or None
        self.proxies: Optional[torch.Tensor] = None     # (R, p) unit rows
        self.centroids: Optional[torch.Tensor] = None   # (C, p)
        self.spill_ids: Optional[np.ndarray] = None     # (R, spill) int32
        self.spill_dist: Optional[np.ndarray] = None    # (R, spill) f32
        self._sums: Optional[np.ndarray] = None         # (C, p) mass
        self._counts: Optional[np.ndarray] = None       # (C,)
        self._members: List[np.ndarray] = []            # per-cluster rows
        self.kmeans_stats: Optional[KMeansStats] = None
        self.last_refold: Optional[RefoldStats] = None
        self._reassigned_since_fit = 0
        self._gather_cache = pred_mod.GatherCache()     # per-ratings operand
        self._csr_cache: Optional[tuple] = None        # per-ratings CSR
        self._proxies_np_cache: Optional[tuple] = None # per-proxies host copy
        self._short_buf = None                         # host GEMM output
        # ratings version chain: the caches above are keyed by tensor
        # identity; ``refold`` advances the chain and patches caches
        # keyed to the previous tensor instead of dropping them
        self._ratings_key = None
        self._ratings_version = 0
        self._member_table_cache = None
        # chaos hook: a FaultInjector armed here fires mid-refold (after
        # ledger mass is removed, before it is re-added) — the torn-index
        # case the checkpoint-restore drill recovers from
        self.fault_injector = None
        self._refold_seq = 0

    def _ratings_csr(self, ratings):
        """Host CSR view of the rating matrix ``(indptr, indices, data)``:
        the rerank's query-side item lists come straight from it.  Cached
        per ratings tensor."""
        if self._csr_cache is not None and self._csr_cache[0] is ratings:
            return self._csr_cache[1]
        rnp = ratings.cpu().numpy()
        rows, cols = np.nonzero(rnp)
        counts = np.bincount(rows, minlength=rnp.shape[0])
        indptr = np.zeros(rnp.shape[0] + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        csr = (indptr, cols.astype(np.int32),
               rnp[rows, cols].astype(np.float32))
        self._csr_cache = (ratings, csr)
        return csr

    @staticmethod
    def _rerank_bucket(nnz: int, n_items: int) -> int:
        """Rated-item support bucket: multiples of 64 to 256, of 128 to
        512, then powers of two."""
        if nnz <= 256:
            b = 64 * -(-nnz // 64)
        elif nnz <= 512:
            b = 128 * -(-nnz // 128)
        else:
            b = _bucket(nnz)
        return min(b, n_items)

    @staticmethod
    def _bucket_table(indptr, indices, data, rows, b, device):
        """One padded (len(rows), b) item/value table sliced out of the
        CSR arrays (vectorized variable-length row copy), on ``device``."""
        items = np.zeros((len(rows), b), np.int32)
        vals = np.zeros((len(rows), b), np.float32)
        lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
        total = int(lens.sum())
        if total:
            dst_row = np.repeat(np.arange(len(rows)), lens)
            off = np.cumsum(lens) - lens
            dst_col = np.arange(total) - np.repeat(off, lens)
            src = np.arange(total) + np.repeat(indptr[rows] - off, lens)
            items[dst_row, dst_col] = indices[src]
            vals[dst_row, dst_col] = data[src]
        return (torch.as_tensor(items, device=device),
                torch.as_tensor(vals, device=device))

    def _item_tables(self, ratings):
        """Padded per-user item/value tables on the ratings' device,
        bucketed by rated-item support — the walk side of the pair-major
        rerank.  ``(bucket_of (U,), local_of (U,), {bucket: (items,
        vals)})``, cached per ratings tensor beside the CSR."""
        if self._csr_cache is not None and len(self._csr_cache) > 2 and \
                self._csr_cache[0] is ratings:
            return self._csr_cache[2]
        indptr, indices, data = self._ratings_csr(ratings)
        n_users = len(indptr) - 1
        n_items = ratings.shape[1]
        nnz = (indptr[1:] - indptr[:-1]).astype(np.int64)
        bucket_of = np.array([self._rerank_bucket(max(int(v), 1), n_items)
                              for v in nnz], np.int32)
        local_of = np.empty(n_users, np.int32)
        tables = {}
        for b in np.unique(bucket_of):
            rows = np.nonzero(bucket_of == b)[0]
            local_of[rows] = np.arange(len(rows))
            tables[int(b)] = self._bucket_table(indptr, indices, data,
                                                rows, int(b), ratings.device)
        out = (bucket_of, local_of, tables)
        self._csr_cache = (ratings, self._csr_cache[1], out)
        return out

    def _proxies_np(self) -> np.ndarray:
        """Host copy of the proxy table for the host shortlist scans
        (cached per proxies tensor — refolds replace it)."""
        if self._proxies_np_cache is not None and \
                self._proxies_np_cache[0] is self.proxies:
            return self._proxies_np_cache[1]
        p_np = np.array(self.proxies.cpu().numpy(), np.float32, order="C")
        self._proxies_np_cache = (self.proxies, p_np)
        return p_np

    def _gather_source(self, ratings):
        """The rerank gather operand's tensor, cached per ratings tensor."""
        return self._gather_cache.get(ratings).src

    def _patch_row_caches(self, ratings, touched: np.ndarray,
                          version: Optional[int], means=None) -> int:
        """Advance the ratings version chain and delta-patch the derived
        per-ratings caches (gather operand, host CSR, pair tables) and the
        subclass's for a user-row delta (``touched``: sorted unique changed
        user rows; ``means``: the post-delta user means, for caches
        derived from them); a broken chain drops them all.  Returns the
        number of caches patched."""
        old = self._ratings_key
        chain_ok = (old is not None and ratings is not old
                    and (version is None
                         or version == self._ratings_version + 1))
        self._ratings_key = ratings
        self._ratings_version = (version if version is not None
                                 else self._ratings_version + 1)
        if not chain_ok:
            self._gather_cache.clear()
            self._csr_cache = None
            self._drop_extra_row_caches()
            return 0
        rows = torch.as_tensor(touched, device=ratings.device)
        patched = int(self._gather_cache.advance(old, ratings, rows))
        csr_cache = self._csr_cache
        if csr_cache is not None and csr_cache[0] is old:
            csr = _patch_csr(csr_cache[1], touched,
                             ratings[rows.long()].cpu().numpy())
            entry = (ratings, csr)
            patched += 1
            if len(csr_cache) > 2:
                entry = entry + (self._patch_item_tables(
                    csr_cache[2], csr, touched, ratings.shape[1],
                    ratings.device),)
                patched += 1
            self._csr_cache = entry
        else:
            self._csr_cache = None
        return patched + self._patch_extra_row_caches(ratings, means,
                                                      touched, old)

    def _patch_item_tables(self, old_tables, csr, touched: np.ndarray,
                           n_items: int, device):
        """Refresh the bucketed pair tables for a row delta: only buckets
        holding a touched row (before or after its support moved) are
        rebuilt from the patched CSR; every other bucket is reused."""
        bucket_of, local_of, tables = old_tables
        indptr, indices, data = csr
        nnz_t = (indptr[touched + 1] - indptr[touched]).astype(np.int64)
        new_b = np.array([self._rerank_bucket(max(int(v), 1), n_items)
                          for v in nnz_t], np.int32)
        affected = np.unique(np.concatenate([bucket_of[touched], new_b]))
        bucket_of = bucket_of.copy()
        bucket_of[touched] = new_b
        local_of = local_of.copy()
        tables = dict(tables)
        for b in affected:
            rows = np.nonzero(bucket_of == b)[0]
            if not len(rows):
                tables.pop(int(b), None)
                continue
            local_of[rows] = np.arange(len(rows))
            tables[int(b)] = self._bucket_table(indptr, indices, data,
                                                rows, int(b), device)
        return bucket_of, local_of, tables

    def _patch_extra_row_caches(self, ratings, means, touched: np.ndarray,
                                old) -> int:
        """Subclass hook: delta-patch the per-ratings caches the core does
        not own; returns how many were patched."""
        return 0

    def _drop_extra_row_caches(self) -> None:
        """Subclass hook: drop those caches on a broken chain."""

    # -- resolution --------------------------------------------------------
    @property
    def fitted(self) -> bool:
        return self.centroids is not None

    @property
    def assign(self) -> np.ndarray:
        """Primary (nearest-centroid) cluster per row."""
        return self.spill_ids[:, 0]

    def _use_kernel(self) -> bool:
        if self.cfg.use_kernel is None:
            return self.device.type == "cuda"
        return bool(self.cfg.use_kernel)

    def _distances(self, x, c):
        return centroid_distances(x, c, use_kernel=self._use_kernel())

    def _proxy_rows(self, ratings, means):
        raise NotImplementedError

    # -- shared fit tail ---------------------------------------------------
    def _resolve_sizes(self) -> None:
        """``n_clusters``/``n_probe`` auto values against ``n_rows``."""
        c = self.cfg.n_clusters or int(np.ceil(np.sqrt(self.n_rows)))
        self.n_clusters = max(1, min(c, self.n_rows))
        self.n_probe = self.cfg.n_probe or max(1, -(-self.n_clusters // 2))
        self.n_probe = min(self.n_probe, self.n_clusters)

    def _fit_clusters(self) -> None:
        """k-means over ``self.proxies`` + spill assignment + mass ledger;
        resets the auto-refit drift counter."""
        spill = min(self.cfg.spill, self.n_clusters)
        self.centroids, _, _, self.kmeans_stats = kmeans(
            self.proxies, self.n_clusters, seed=self.cfg.seed,
            iters=self.cfg.iters, block_size=self.cfg.kmeans_block,
            use_kernel=self._use_kernel(), mesh=self.mesh,
            axis=self.mesh_axis)
        ids, dist = _spill_assign(
            self.proxies, self.centroids, spill=spill,
            block_size=min(self.cfg.kmeans_block, self.n_rows),
            use_kernel=self._use_kernel())
        self.spill_ids = ids.cpu().numpy().copy()
        self.spill_dist = dist.cpu().numpy().copy()
        self._fold_mass()
        self._rebuild_members()
        self._reassigned_since_fit = 0

    def _fold_mass(self) -> None:
        p_np = self.proxies.cpu().numpy()
        self._sums = np.zeros((self.n_clusters, p_np.shape[1]), np.float32)
        np.add.at(self._sums, self.assign, p_np)
        self._counts = np.bincount(self.assign,
                                   minlength=self.n_clusters).astype(np.int64)

    def _rebuild_members(self) -> None:
        """Per-cluster member lists from the spill assignment (ascending)."""
        flat = self.spill_ids.reshape(-1)
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int32),
                         self.spill_ids.shape[1])
        order = np.lexsort((rows, flat))
        flat, rows = flat[order], rows[order]
        splits = np.searchsorted(flat, np.arange(1, self.n_clusters))
        self._members = list(np.split(rows, splits))
        self._member_table_cache = None

    # -- incremental maintenance (shared core) -----------------------------
    def _refold_rows(self, touched: np.ndarray, p_new: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Fold refreshed proxy rows into the ledger and repair spill
        assignments exactly.  ``touched``: sorted unique row ids;
        ``p_new``: their fresh proxy rows.  Returns ``(changed_clusters,
        full_rows, n_reassigned)``.  The mass ledger keeps every row's
        stored proxy at its *current primary cluster*, so removal always
        subtracts the very value that was added."""
        spill = self.spill_ids.shape[1]
        dev = self.device
        t_dev = torch.as_tensor(touched, device=dev).long()

        # 1. refold proxies and centroid mass for the touched rows
        p_old = self.proxies[t_dev].cpu().numpy()
        p_new_np = p_new.cpu().numpy()
        p_host = None
        if self._proxies_np_cache is not None and \
                self._proxies_np_cache[0] is self.proxies:
            # delta-patch the host proxy copy alongside the device update
            # (copy-on-write: a reader mid-scan keeps the pre-delta table)
            p_host = self._proxies_np_cache[1].copy()
            p_host[touched] = p_new_np
        proxies = self.proxies.clone()             # copy-on-write
        proxies[t_dev] = p_new
        self.proxies = proxies
        if p_host is not None:
            self._proxies_np_cache = (self.proxies, p_host)
        a_old = self.assign[touched].copy()
        np.add.at(self._sums, a_old, -p_old)
        np.add.at(self._counts, a_old, -1)
        self._refold_seq += 1
        if self.fault_injector is not None:
            # chaos hook: fire with the ledger torn — the touched rows'
            # mass removed but not yet re-added, so check_consistent fails
            # until the caller restores a committed checkpoint
            self.fault_injector.check(self._refold_seq)
        d_new = self._distances(p_new, self.centroids).cpu().numpy()
        a_prov = d_new.argmin(axis=1).astype(np.int32)
        np.add.at(self._sums, a_prov, p_new_np)
        np.add.at(self._counts, a_prov, 1)

        # 2. recompute the moved centroids (empty → keep position)
        changed = np.unique(np.concatenate([a_old, a_prov]))
        cent = self.centroids.cpu().numpy().copy()
        upd = changed[self._counts[changed] > 0]
        cent[upd] = self._sums[upd] / self._counts[upd, None]
        self.centroids = torch.as_tensor(cent, device=dev)

        # 3. exact spill repair: full rows for touched rows and rows
        #    owning a moved cluster; the certificate merge for the rest
        old_ids = self.spill_ids.copy()
        need_full = np.isin(self.spill_ids, changed).any(axis=1)
        need_full[touched] = True
        cb = _bucket(len(changed))
        cent_ch = cent[np.pad(changed, (0, cb - len(changed)),
                              constant_values=changed[0])]
        d_ch = self._distances(self.proxies, torch.as_tensor(
            cent_ch, device=dev)).cpu().numpy()[:, :len(changed)]
        merge_d = np.concatenate([self.spill_dist, d_ch], axis=1)
        merge_i = np.concatenate(
            [self.spill_ids,
             np.broadcast_to(changed[None, :],
                             (self.n_rows, len(changed)))], axis=1)
        order = np.lexsort((merge_i, merge_d), axis=1)[:, :spill]
        rows = np.nonzero(~need_full)[0]
        self.spill_ids[rows] = np.take_along_axis(
            merge_i, order, axis=1)[rows]
        self.spill_dist[rows] = np.take_along_axis(
            merge_d, order, axis=1)[rows]

        full_rows = np.nonzero(need_full)[0].astype(np.int32)
        if len(full_rows):
            fb = _bucket(len(full_rows))
            rows_pad = np.pad(full_rows, (0, fb - len(full_rows)),
                              constant_values=full_rows[0])
            ids, dist = _spill_assign(
                self.proxies[torch.as_tensor(rows_pad, device=dev).long()],
                self.centroids, spill=spill, block_size=fb,
                use_kernel=self._use_kernel())
            self.spill_ids[full_rows] = ids.cpu().numpy()[:len(full_rows)]
            self.spill_dist[full_rows] = dist.cpu().numpy()[:len(full_rows)]

        # 4. re-home the mass ledger of rows whose primary moved (the
        #    receiving centroids are not recomputed: the no-cascade rule)
        ledger = old_ids[:, 0].copy()
        ledger[touched] = a_prov
        new_prim = self.spill_ids[:, 0]
        moved = np.nonzero(ledger != new_prim)[0]
        if len(moved):
            pm = self.proxies[torch.as_tensor(moved, device=dev).long()
                              ].cpu().numpy()
            np.add.at(self._sums, ledger[moved], -pm)
            np.add.at(self._counts, ledger[moved], -1)
            np.add.at(self._sums, new_prim[moved], pm)
            np.add.at(self._counts, new_prim[moved], 1)

        reassigned = int((self.spill_ids != old_ids).any(axis=1).sum())
        if reassigned:
            self._rebuild_members()
        self._reassigned_since_fit += reassigned
        return changed, full_rows, reassigned

    def _maybe_refit(self, ratings, means, stats: RefoldStats) -> None:
        """The drift guard: cold-refit when cumulative reassignment since
        the last fit crosses ``cfg.refit_reassign_frac`` (0 disables)."""
        stats.reassigned_frac = self._reassigned_since_fit / max(
            self.n_rows, 1)
        thr = self.cfg.refit_reassign_frac
        if thr and stats.reassigned_frac >= thr:
            self.fit(ratings, means)
            stats.refit = True

    # -- diagnostics (shared core) -----------------------------------------
    def _check_spill_state(self, p_cold: torch.Tensor) -> List[str]:
        """Refold invariants: proxies, mass ledger, and spill assignments
        all equal a cold recomputation (bit for bit, the sums to 1e-3)."""
        errs = []
        if not torch.equal(p_cold, self.proxies):
            errs.append("proxies")
        cold_counts = np.bincount(self.assign, minlength=self.n_clusters)
        if not np.array_equal(cold_counts, self._counts):
            errs.append("mass counts")
        cold_sums = np.zeros_like(self._sums)
        np.add.at(cold_sums, self.assign, p_cold.cpu().numpy())
        if not np.allclose(cold_sums, self._sums, atol=1e-3):
            errs.append("mass sums")
        ids, dist = _spill_assign(
            p_cold, self.centroids, spill=self.spill_ids.shape[1],
            block_size=min(self.cfg.kmeans_block, self.n_rows),
            use_kernel=self._use_kernel())
        if not np.array_equal(ids.cpu().numpy(), self.spill_ids):
            errs.append("spill assignments")
        if not np.array_equal(dist.cpu().numpy(), self.spill_dist):
            errs.append("spill distances")
        return errs

    def member_counts(self) -> np.ndarray:
        return np.array([len(m) for m in self._members])

    # -- persistence -------------------------------------------------------
    _STATE_KEYS = ("basis", "centroids", "counts", "meta", "proxies",
                   "spill_dist", "spill_ids", "sums")

    def state(self) -> dict:
        """Checkpointable state: a flat dict of host arrays in the
        reference's layout (``basis=None`` as an empty array)."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        return {
            "basis": (np.zeros((0, 0), np.float32) if self.basis is None
                      else self.basis.cpu().numpy()),
            "centroids": self.centroids.cpu().numpy(),
            "counts": np.asarray(self._counts),
            "meta": np.asarray([self.n_rows, self.n_clusters, self.n_probe,
                                self._reassigned_since_fit], np.int64),
            "proxies": self.proxies.cpu().numpy(),
            "spill_dist": self.spill_dist,
            "spill_ids": self.spill_ids,
            "sums": self._sums,
            **self._extra_state(),
        }

    @classmethod
    def state_template(cls) -> dict:
        """Structure-only tree mirroring :meth:`state`."""
        return {k: 0 for k in cls._STATE_KEYS}

    def load_state(self, tree: dict, device=None) -> "_SpillClusterCore":
        """Restore :meth:`state` output — the port's own or the
        reference's ``ClusteredIndex.state()`` — onto ``device`` (default:
        the index's); the k-means fit is skipped.  Writable copies are
        taken."""
        if device is not None:
            self.device = torch.device(device)
        meta = np.asarray(tree["meta"]).reshape(-1)
        self.n_rows = int(meta[0])
        self.n_clusters = int(meta[1])
        self.n_probe = int(meta[2])
        self._reassigned_since_fit = int(meta[3])

        def dev(key):
            return torch.as_tensor(np.array(tree[key], np.float32),
                                   device=self.device)

        basis = np.asarray(tree["basis"], np.float32)
        self.basis = dev("basis") if basis.size else None
        self.proxies = dev("proxies")
        self.centroids = dev("centroids")
        self.spill_ids = np.array(tree["spill_ids"], np.int32)
        self.spill_dist = np.array(tree["spill_dist"], np.float32)
        self._sums = np.array(tree["sums"], np.float32)
        self._counts = np.array(tree["counts"], np.int64)
        self.kmeans_stats = None
        self._rebuild_members()
        self._load_extra_state(tree)
        return self

    def _extra_state(self) -> dict:
        """Subclass hook: extra host arrays for :meth:`state`."""
        return {}

    def _load_extra_state(self, tree: dict) -> None:
        """Subclass hook: restore what :meth:`_extra_state` saved."""


class ClusteredIndex(_SpillClusterCore):
    """User-clustering ANN index with exact rerank (see module docstring).

    The index never owns the rating matrix — the caller (typically
    :class:`repro_torch.core.facade.CFEngine`) passes ``ratings``/``means``
    into every call; proxies and centroids live on the ratings' device.
    """

    # lock-free by design, with the reason (the reference's race harness
    # reads this): the serving batcher touches the user index only here
    _reprolint_race_ok = {
        "query_mode_override": "one str reference, written by the serving "
                               "batcher's health transition and read once "
                               "at the start of a query, which then runs "
                               "the pipeline it resolved whole",
        "centroids": "replaced by one reference swap in refold/fit; the "
                     "batcher reads it only through fitted (a None "
                     "check)",
    }

    def __init__(self, cfg: IndexConfig = IndexConfig(), mesh=None,
                 mesh_axis: str = "data"):
        super().__init__(cfg, mesh=mesh, mesh_axis=mesh_axis)
        self.last_query: Optional[QueryStats] = None
        # per-index runtime override of the frozen cfg.query_mode: the
        # serving degradation ladder steps fused → staged under pressure
        # (and back) without rebuilding the index; None defers to cfg
        self.query_mode_override: Optional[str] = None

    @property
    def n_users(self) -> int:
        return self.n_rows

    def _featurize(self, ratings, means):
        return _featurize(ratings, means, features=self.cfg.features)

    def _proxy_rows(self, ratings, means):
        z = self._featurize(ratings, means)
        return _project(z, self.basis) if self.basis is not None else z

    def _max_rerank(self, k: int) -> int:
        if not self.cfg.rerank_frac:
            return 0
        return max(k, int(np.ceil(self.cfg.rerank_frac * self.n_users)))

    # -- fit ---------------------------------------------------------------
    def fit(self, ratings: torch.Tensor,
            means: Optional[torch.Tensor] = None) -> "ClusteredIndex":
        """Project, cluster, and spill-assign the users of ``ratings``."""
        ratings = torch.as_tensor(ratings).float()
        self.device = ratings.device
        self._ratings_key = ratings          # (re)anchor the version chain
        self.n_rows, n_items = ratings.shape
        if means is None:
            means = sim.user_stats(ratings)[2]
        self._resolve_sizes()

        with obs.span("index.fit", device_sync=True, n_users=self.n_rows,
                      n_items=n_items, n_clusters=self.n_clusters) as sp:
            z = self._featurize(ratings, means)
            p = min(self.cfg.project_dim, n_items)
            if self.cfg.project_dim and p < n_items:
                with obs.span("fit.svd_basis", dim=p):
                    self.basis = torch.as_tensor(
                        _svd_basis(z.cpu().numpy(), p, self.cfg.seed),
                        device=self.device)
            else:
                self.basis = None
            self.proxies = (_project(z, self.basis)
                            if self.basis is not None else z.contiguous())
            self._fit_clusters()
            sp.track(self.proxies)
        obs.histogram("index.fit.seconds").observe(sp.duration)
        return self

    # -- resolution --------------------------------------------------------
    # auto rerank-mode split point (the reference's): grouped at rerank
    # budgets ≥ 8 % of the pool, the gather walk below
    _GROUPED_FRAC = 0.08

    def _rerank_mode(self, max_rerank: int = 0) -> str:
        """Resolve ``cfg.rerank_mode``: grouped where the kernels run and
        at dense rerank budgets, the bucketed gather walk elsewhere."""
        if self.cfg.rerank_mode != "auto":
            return self.cfg.rerank_mode
        if self._use_kernel():
            return "grouped"
        return ("grouped" if max_rerank >= self._GROUPED_FRAC * self.n_rows
                else "gather")

    def _query_mode(self) -> str:
        """Resolve the orchestration: ``query_mode_override`` (set by the
        serving degradation ladder) wins; then ``cfg.query_mode``;
        ``"auto"`` is the fused chain where the kernels run and the staged
        pipeline elsewhere."""
        override = self.query_mode_override
        if override is not None:
            if override not in ("fused", "staged"):
                raise ValueError(
                    f"query_mode_override must be 'fused' or 'staged', "
                    f"got {override!r}")
            return override
        if self.cfg.query_mode != "auto":
            return self.cfg.query_mode
        return "fused" if self._use_kernel() else "staged"

    def _scan_mode(self, n_probe: int) -> str:
        """Resolve ``cfg.shortlist_scan_mode``: the scan kernel where the
        kernels run, else by probe fraction — the pool scan when probing
        saturates it (``2·n_probe·spill > C``), the cluster-restricted
        scan below."""
        mode = self.cfg.shortlist_scan_mode
        if mode != "auto":
            return mode
        if self._use_kernel():
            return "kernel"
        if 2 * n_probe * self.spill_ids.shape[1] <= self.n_clusters:
            return "cluster"
        return "pool"

    def _sym_level(self, max_rerank: int) -> float:
        """Largest ``_SYM_LEVELS`` threshold oversample whose projected
        survivor mass fits ``_SYM_MAX_BYTES`` (the ladder floor always
        runs: the survivor compaction bounds peak memory)."""
        for os_ in _SYM_LEVELS:
            if os_ * max_rerank * self.n_users * 12 <= _SYM_MAX_BYTES:
                return os_
        return _SYM_LEVELS[-1]

    def _sym_eligibility(self, max_rerank: int, scan: str, pool_all: bool,
                         full_pop: bool, qmode: str) -> Tuple[bool, str]:
        """Resolve the symmetric-pair scan gate to ``(use, reason)``; the
        reason lands in ``QueryStats.scan_gate``.  A forced
        ``scan_symmetric=True`` raises on the hard gates (the fused mode,
        a non-pool or unsaturated scan, a subset query set) and runs at
        any budget; auto prefers the plain scan at fat budgets."""
        forced = self.cfg.scan_symmetric is True
        if self.cfg.scan_symmetric is False:
            return False, "sym:off:config"

        def gate(reason: str, detail: str) -> Tuple[bool, str]:
            if forced:
                raise ValueError(
                    f"scan_symmetric=True cannot run: {detail}")
            return False, reason

        if qmode == "fused":
            return gate(
                "sym:off:fused",
                "query_mode='fused' keeps the scan on device; the "
                "symmetric-pair scan is the host pool path (set "
                "query_mode='staged' to use it)")
        if scan != "pool" or not pool_all:
            return gate(
                "sym:off:scan-mode",
                f"the resolved scan mode ({scan!r}, "
                f"pool_all={pool_all}) is not the saturated host pool "
                "scan the symmetric pair schedule halves")
        if not full_pop:
            return gate(
                "sym:off:subset-queries",
                "the pair buffer covers unordered pairs of the full "
                "population only; this query set is a subset")
        if not forced and max_rerank > _SYM_FRAC_MAX * self.n_users:
            return False, "sym:off:fat-budget"
        return True, f"sym:on:level={self._sym_level(max_rerank):.2f}"

    # -- shortlist scans ---------------------------------------------------
    def _member_table(self) -> np.ndarray:
        """Padded per-cluster member-id table, (C, Lmax) int32 with
        ``n_rows`` padding (rebuilt lazily after any reassignment)."""
        if self._member_table_cache is None:
            lmax = max(int(self.member_counts().max()), 1)
            tbl = np.full((self.n_clusters, lmax), self.n_rows, np.int32)
            for c, mem in enumerate(self._members):
                tbl[c, :len(mem)] = mem
            self._member_table_cache = tbl
        return self._member_table_cache

    def _cluster_candidates(self, clusters: np.ndarray) -> np.ndarray:
        """Dup-free member union of the probed ``clusters`` through the
        padded member table: a member is contributed by the *first probed*
        cluster of its spill list, so the result equals the probed
        clusters' member union exactly, in cluster-major order."""
        n = self.n_users
        tbl = self._member_table()[clusters]              # (ncl, Lmax)
        flat = tbl.reshape(-1)
        sp_l = self.spill_ids[np.minimum(flat, n - 1)]    # (F, spill)
        probed = np.zeros(self.n_clusters, bool)
        probed[clusters] = True
        first = sp_l[np.arange(len(flat)), probed[sp_l].argmax(axis=1)]
        own = np.repeat(clusters.astype(np.int32), tbl.shape[1])
        return flat[(flat < n) & (first == own)]

    def _proxy_gemm(self, q_c: np.ndarray, b_c: np.ndarray,
                    reuse_buf: bool = False):
        """Host proxy-score GEMM ``q_c @ b_cᵀ`` on the CPU's ``torch.mm``
        (multithreaded, f32); returns a numpy view of the output."""
        nv = len(q_c)
        if reuse_buf:
            if self._short_buf is None or \
                    self._short_buf.shape[1] != len(b_c) or \
                    self._short_buf.shape[0] < nv:
                self._short_buf = torch.empty(nv, len(b_c),
                                              dtype=torch.float32)
            out = self._short_buf[:nv]
        else:
            out = torch.empty(nv, len(b_c), dtype=torch.float32)
        torch.mm(torch.from_numpy(np.ascontiguousarray(q_c)),
                 torch.from_numpy(b_c).T, out=out)
        return out.numpy()          # shared-memory view

    def _scan_dense_block(self, p_np: np.ndarray, ids: np.ndarray,
                          cand: Optional[np.ndarray],
                          max_rerank: int) -> np.ndarray:
        """Host proxy scan of one query block: one GEMM against the full
        pool (``cand is None``) or a gathered candidate union, then the
        canonical top-M (:func:`_topm_rows`).  Returns the (nv, M)
        shortlist with ``n_users`` on every ``-inf`` slot."""
        nv = len(ids)
        pool_all = cand is None
        q_c = np.ascontiguousarray(p_np[ids])
        b_c = p_np if pool_all else np.ascontiguousarray(p_np[cand])
        sp = self._proxy_gemm(q_c, b_c, reuse_buf=True)
        if pool_all:                # self-pair knockout
            sp[np.arange(nv), ids] = -np.inf
        else:
            at = np.searchsorted(cand, ids)
            hit = np.nonzero((at < len(cand))
                             & (cand[np.minimum(at, len(cand) - 1)]
                                == ids))[0]
            sp[hit, at[hit]] = -np.inf
        selv, sel = _topm_rows(sp, max_rerank)
        picked = sel if pool_all else cand[sel]
        return np.where(selv == -np.inf, self.n_users,
                        picked).astype(np.int32)

    def _scan_cluster_block(self, p_np: np.ndarray, ids: np.ndarray,
                            clusters: np.ndarray, max_rerank: int
                            ) -> Tuple[np.ndarray, int]:
        """Cluster-restricted host scan of one query block: only the
        probed clusters' member proxies are scored (through the padded
        member table), so the candidate set equals the block's probed
        union.  Returns the (nv, M) shortlist and the scanned-slot
        count."""
        n = self.n_users
        cand = self._cluster_candidates(clusters)         # dup-free union
        sp = self._proxy_gemm(np.ascontiguousarray(p_np[ids]),
                              np.ascontiguousarray(p_np[cand]))
        inv = np.full(n, -1, np.int64)                    # self knockout
        inv[cand] = np.arange(len(cand))
        at = inv[ids]
        hit = np.nonzero(at >= 0)[0]
        sp[hit, at[hit]] = -np.inf
        selv, sel = _topm_rows(sp, min(max_rerank, len(cand)),
                               col_ids=cand)
        short = np.where(selv == -np.inf, n, cand[sel]).astype(np.int32)
        if short.shape[1] < max_rerank:
            short = np.pad(short,
                           ((0, 0), (0, max_rerank - short.shape[1])),
                           constant_values=n)
        return short, len(cand)

    def _scan_kernel_block(self, ids_pad: np.ndarray, nv: int,
                           max_rerank: int) -> np.ndarray:
        """Device shortlist scan of one query block: the same scan the
        fused chain runs (:func:`_fused_scan_pool` — the CUDA scan/select
        kernel on the card), with the (nv, M) shortlist brought to the
        host and ``n_users`` on every ``-inf`` slot, so staged and fused
        shortlists are identical by construction."""
        m = min(max_rerank, self.n_users)
        v, i = _fused_scan_pool(
            self.proxies, torch.as_tensor(ids_pad, device=self.device),
            m=m, use_kernel=self._use_kernel())
        v = v[:nv].cpu().numpy()
        short = np.where(np.isneginf(v), self.n_users,
                         i[:nv].cpu().numpy()).astype(np.int32)
        if short.shape[1] < max_rerank:
            short = np.pad(short,
                           ((0, 0), (0, max_rerank - short.shape[1])),
                           constant_values=self.n_users)
        return short

    def _scan_symmetric(self, p_np: np.ndarray, max_rerank: int,
                        bq: int,
                        oversample: float = _SYM_OVERSAMPLE) -> np.ndarray:
        """Symmetric-pair full-population proxy scan with threshold
        selection (the reference's algorithm): each unordered query-block
        pair's GEMM runs once and feeds both sides.

        1. Thresholds — a diagonal block is a uniform sample of the
           population: a row's ``tau`` is its block-local rank-``ks``
           score, ``ks`` oversampled so ~``oversample·M`` entries of the
           full row survive.
        2. Survivors — every pair block gives its entries ``> tau`` to
           both row sides.
        3. Per row block, the survivors are grouped by row in ascending
           candidate-id order and the canonical top-M runs over them.

        A row with ≥ M survivors has its M-th best strictly above
        ``tau``, so its survivors' top-M *is* the full row's; rows with
        fewer are rescanned through :meth:`_scan_dense_block`.  When a
        row block's pending entries pass ``_SYM_COMPACT_FACTOR`` times
        the expected mass they are folded to the per-row top-M (exact:
        a dropped entry is after ≥ M kept ones), and the ``seen`` tally
        keeps the certificate honest.  Returns the (U, M) shortlists.
        """
        n = self.n_users
        m = max_rerank
        bq = min(bq, n)
        nblk = -(-n // bq)
        pt = torch.from_numpy(p_np)
        scr_t = torch.empty(bq, bq)
        taus = np.empty(n, np.float32)
        tri: List[list] = [[] for _ in range(nblk)]   # (rows, cols, vals)
        nvs = [min((b + 1) * bq, n) - b * bq for b in range(nblk)]
        seen = np.zeros(n, np.int64)     # observed survivors per row
        pend = np.zeros(nblk, np.int64)  # pending (uncompacted) entries
        cap = max(int(_SYM_COMPACT_FACTOR * oversample * m),
                  _SYM_COMPACT_MIN)

        def mm_block(i0, i1, j0, j1):
            view = scr_t[:i1 - i0, :j1 - j0]
            torch.mm(pt[i0:i1], pt[j0:j1].t(), out=view)
            return view.numpy()

        def assemble(dst):
            """``dst``'s survivors → per-row canonical top-M (values,
            candidate ids), ``-inf`` / ``n`` where a row has fewer."""
            rows = np.concatenate([t[0] for t in tri[dst]])
            cols = np.concatenate([t[1] for t in tri[dst]])
            vals = np.concatenate([t[2] for t in tri[dst]])
            indptr, grp_i, grp_v = _sym_group(rows, cols, vals,
                                              nvs[dst], n)
            padv, padi = _sym_pad(indptr, grp_i, grp_v, nvs[dst], n)
            selv, sel = _topm_rows(padv, min(m, padv.shape[1]))
            return selv, np.take_along_axis(padi, sel, axis=1)

        def compact(dst):
            """Fold ``dst``'s pending triplets to the per-row top-M."""
            selv, picked = assemble(dst)
            rr, cc = np.nonzero(~np.isneginf(selv))
            tri[dst] = [(rr.astype(np.int32), picked[rr, cc],
                         selv[rr, cc].astype(np.float32))]
            pend[dst] = len(rr)

        def collect(dst, s, mask, col0, transpose):
            """Append ``mask`` survivors of block ``s`` to row side
            ``dst`` (``transpose``: the pair block's second side)."""
            flat = np.flatnonzero(mask)
            if not len(flat):
                return
            vals = s.reshape(-1)[flat]
            r, c = np.divmod(flat, s.shape[1])
            if transpose:
                r, c = c, r
            tri[dst].append((r.astype(np.int32),
                             (col0 + c).astype(np.int32), vals))
            d0 = dst * bq
            seen[d0:d0 + nvs[dst]] += np.bincount(r, minlength=nvs[dst])
            pend[dst] += len(flat)
            if pend[dst] > cap * nvs[dst]:
                compact(dst)

        # phase 1 — diagonal blocks: thresholds + own survivors
        ks = max(1, int(oversample * m * bq / n))
        for bi in range(nblk):
            i0, i1 = bi * bq, min((bi + 1) * bq, n)
            s = mm_block(i0, i1, i0, i1)
            ar = np.arange(i1 - i0)
            s[ar, ar] = -np.inf                      # self knockout
            kk = min(ks, s.shape[1] - 1)
            if kk < 1:
                # a width-1 trailing block has no sample: +inf leaves no
                # survivor and sends its rows to the exact rescan
                taus[i0:i1] = np.inf
                continue
            # reprolint: disable=canonical-selection -- threshold sampling only: the kk-th VALUE feeds the survivor cut, ids are never consumed, so tie order cannot leak
            v = torch.topk(scr_t[:i1 - i0, :i1 - i0], kk, dim=1,
                           sorted=True)[0]
            taus[i0:i1] = v[:, -1].numpy()
            collect(bi, s, s > taus[i0:i1, None], i0, False)

        # phase 2 — off-diagonal pairs, both sides from one GEMM
        for bi in range(nblk):
            i0, i1 = bi * bq, min((bi + 1) * bq, n)
            for bj in range(bi + 1, nblk):
                j0, j1 = bj * bq, min((bj + 1) * bq, n)
                s = mm_block(i0, i1, j0, j1)
                collect(bi, s, s > taus[i0:i1, None], j0, False)
                collect(bj, s, s > taus[j0:j1][None, :], i0, True)

        # phase 3 — per-row-block assembly + canonical top-M; the
        # certificate reads the observed tally
        shorts = np.full((n, m), n, np.int32)
        fallback: list = []
        for bi in range(nblk):
            i0, i1 = bi * bq, min((bi + 1) * bq, n)
            fb = np.nonzero(seen[i0:i1] < m)[0]
            fallback.extend((i0 + fb).tolist())
            if not tri[bi]:
                continue
            selv, picked = assemble(bi)
            shorts[i0:i1, :picked.shape[1]] = np.where(
                np.isneginf(selv), n, picked)
        if fallback:
            fb_ids = np.asarray(fallback, np.int32)
            shorts[fb_ids] = self._scan_dense_block(p_np, fb_ids, None, m)
        return shorts

    # -- query -------------------------------------------------------------
    def query(self, ratings: torch.Tensor, means: torch.Tensor,
              user_ids=None, *, k: int, measure: str = "pcc",
              n_probe: Optional[int] = None,
              beta: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k true-similarity neighbors through the two-stage pipeline:
        ``(scores, neighbor_ids)`` of shape ``(len(user_ids), k)`` on the
        ratings' device; sets ``self.last_query``.  With ``n_probe ==
        n_clusters`` and ``rerank_frac == 0`` the result is bit-identical
        to the exact engines.  The rerank stage is measured and the
        shortlist stage absorbs the rest of the wall clock, so
        ``seconds_shortlist + seconds_rerank == seconds_total`` exactly."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        beta = sim.resolve_beta(beta)
        uids = (np.arange(self.n_users, dtype=np.int32) if user_ids is None
                else np.atleast_1d(np.asarray(user_ids, np.int32)))
        n_probe = min(n_probe or self.n_probe, self.n_clusters)
        max_rerank = self._max_rerank(k)
        bq = min(self.cfg.query_block, _bucket(len(uids)))
        out_s = np.empty((len(uids), k), np.float32)
        out_i = np.empty((len(uids), k), np.int32)
        qspan = obs.span("index.query", n_queries=len(uids), k=k,
                         measure=measure)
        qspan.__enter__()
        try:
            scan = self._scan_mode(n_probe) if max_rerank else "pool"
            qmode = self._query_mode() if max_rerank else "staged"
            # pool shortcut: candidates = the whole population, no
            # per-block probing — for the device scan always, on the host
            # when probing saturates the pool (n_probe·spill ≥ C)
            pool_all = (bool(max_rerank) and max_rerank < self.n_users
                        and (scan == "kernel"
                             or (qmode == "fused" and scan == "pool")
                             or (scan == "pool"
                                 and n_probe * self.spill_ids.shape[1]
                                 >= self.n_clusters)))
            full_pop = np.array_equal(uids, np.arange(self.n_users))
            sym_use, scan_gate = ((False, "") if not max_rerank else
                                  self._sym_eligibility(max_rerank, scan,
                                                        pool_all, full_pop,
                                                        qmode))
            # the host proxy table exists only where a host scan runs
            p_np = (self._proxies_np()
                    if max_rerank and scan != "kernel" and qmode != "fused"
                    else None)
            if pool_all:
                # no per-block probe work: score in tall blocks
                bq = min(2048, _bucket(len(uids)))
            mode = ("fused" if qmode == "fused" and max_rerank
                    else self._rerank_mode(max_rerank))
            qspan.set_attr("scan_mode", scan if max_rerank else "")
            qspan.set_attr("query_mode", qmode)
            qspan.set_attr("scan_gate", scan_gate)
            qspan.set_attr("rerank_mode", mode)
            if qmode == "fused" and max_rerank:
                n_probed, n_reranked, t_rerank = self._query_fused(
                    ratings, uids, out_s, out_i, k=k, measure=measure,
                    beta=beta, n_probe=n_probe, max_rerank=max_rerank,
                    pool_all=pool_all, bq=bq)
            else:
                n_probed, n_reranked, t_rerank = self._query_staged(
                    ratings, uids, out_s, out_i, k=k, measure=measure,
                    beta=beta, n_probe=n_probe, max_rerank=max_rerank,
                    scan=scan, pool_all=pool_all, bq=bq, p_np=p_np,
                    sym_use=sym_use, mode=mode)
            qspan.set_attr("n_probed", n_probed)
            qspan.set_attr("n_reranked", n_reranked)
        finally:
            qspan.__exit__(None, None, None)

        t_short = max(qspan.duration - t_rerank, 0.0)
        self.last_query = QueryStats(n_queries=len(uids),
                                     n_users=self.n_users,
                                     n_probed=n_probed,
                                     n_reranked=n_reranked,
                                     seconds_shortlist=t_short,
                                     seconds_rerank=t_rerank,
                                     seconds_total=t_short + t_rerank,
                                     rerank_mode=mode,
                                     scan_mode=scan if max_rerank else "",
                                     query_mode=qmode,
                                     scan_gate=scan_gate)
        reg = obs.registry()
        reg.counter("index.query.count").inc()
        reg.counter("index.query.queries").inc(len(uids))
        reg.counter("index.query.probed_rows").inc(n_probed)
        reg.counter("index.query.reranked_rows").inc(n_reranked)
        reg.histogram("index.query.seconds").observe(t_short + t_rerank)
        reg.histogram("index.query.shortlist_seconds").observe(t_short)
        reg.histogram("index.query.rerank_seconds").observe(t_rerank)
        dev = ratings.device
        return (torch.as_tensor(out_s, device=dev),
                torch.as_tensor(out_i, device=dev))

    def _probe(self, ids_t, nv: int, n_probe: int, block: int) -> np.ndarray:
        """Nearest ``n_probe`` clusters of a query block's real rows (the
        ``query.probe`` span), on the host."""
        with obs.span("query.probe", block=block, n_probe=n_probe):
            return _probe_clusters(
                self.proxies, self.centroids, ids_t.long(),
                n_probe=n_probe,
                use_kernel=self._use_kernel()).cpu().numpy()[:nv]

    def _unfiltered_block(self, ratings, ids, ids_t, probe, cand, bq, lo,
                          out_s, out_i, *, k, measure, beta):
        """A block whose candidate union fits the rerank budget (and every
        block of the degenerate ``rerank_frac = 0`` mode): exact per-query
        probe semantics — a candidate counts iff one of its spill clusters
        was probed by that query — through the shared-matmul exact path.
        ``cand``: the ascending union.  Returns ``(n_pairs, seconds)``."""
        n = self.n_users
        nv = len(ids)
        dev = ratings.device
        big_l = _bucket(len(cand))
        cand_pad = np.full((big_l,), n, np.int32)
        cand_pad[:len(cand)] = cand
        allowed = np.zeros((bq, big_l), bool)
        probed_tbl = np.zeros((nv, self.n_clusters), bool)
        probed_tbl[np.arange(nv)[:, None], probe] = True
        sp_c = self.spill_ids[cand]                      # (Lc, spill)
        allowed[:nv, :len(cand)] = probed_tbl[:, sp_c].any(-1)
        n_pairs = int((allowed[:nv]
                       & (cand_pad[None, :] != ids[:, None])).sum())
        # candidate generation above is shortlist-stage work; the exact
        # scoring below is rerank work (the stage timers partition the
        # wall total)
        with obs.span("query.rerank", kind="shared", block=lo // bq,
                      rows=n_pairs) as rsp:
            s, i = _rerank_shared(
                ratings, ids_t.long(),
                torch.as_tensor(cand_pad, device=dev).long(),
                torch.as_tensor(allowed, device=dev), k=k,
                measure=measure, beta=beta)
            out_s[lo:lo + nv] = s.cpu().numpy()[:nv]
            out_i[lo:lo + nv] = i.cpu().numpy()[:nv]
        return n_pairs, rsp.duration

    def _query_staged(self, ratings, uids, out_s, out_i, *, k, measure,
                      beta, n_probe, max_rerank, scan, pool_all, bq,
                      p_np, sym_use, mode):
        """The two-pass host-orchestrated pipeline: pass 1 builds every
        block's shortlist (the symmetric scan, the device or host pool
        scan, the cluster-restricted scan, the block-union scan, or the
        unfiltered exact path for blocks whose union fits the budget),
        pass 2 reranks the shortlists exactly (grouped or gather).
        Returns ``(n_probed, n_reranked, seconds_rerank)``."""
        n = self.n_users
        dev = ratings.device
        n_probed = 0
        n_reranked = 0
        t_rerank = 0.0
        mc = self.member_counts() if scan == "cluster" else None
        spill = self.spill_ids.shape[1]
        pend_pos: list = []        # output row ranges awaiting pass 2
        pend_short: list = []      # their (nv, max_rerank) shortlists

        # pass 1 — shortlist scan
        if sym_use:
            with obs.span("query.scan", scan="symmetric",
                          oversample=self._sym_level(max_rerank)):
                shorts_all = self._scan_symmetric(
                    p_np, max_rerank, bq,
                    oversample=self._sym_level(max_rerank))
            n_probed += len(uids) * n
            n_reranked += int((shorts_all < n).sum())
            pend_pos.append(np.arange(len(uids)))
            pend_short.append(shorts_all)
        else:
            for lo in range(0, len(uids), bq):
                ids = uids[lo:lo + bq]
                nv = len(ids)
                ids_pad = np.full((bq,), n, np.int32)
                ids_pad[:nv] = ids
                if pool_all:
                    with obs.span("query.scan", scan=scan, block=lo // bq,
                                  candidates=n):
                        short_np = (
                            self._scan_kernel_block(ids_pad, nv, max_rerank)
                            if scan == "kernel" else
                            self._scan_dense_block(p_np, ids, None,
                                                   max_rerank))
                    n_probed += nv * n
                    n_reranked += int((short_np < n).sum())
                    pend_pos.append(np.arange(lo, lo + nv))
                    pend_short.append(short_np)
                    continue
                ids_t = torch.as_tensor(ids_pad, device=dev)
                probe = self._probe(ids_t, nv, n_probe, lo // bq)
                clusters = np.unique(probe)
                if max_rerank and scan == "cluster" and \
                        int(mc[clusters].sum()) > max_rerank * spill:
                    # cluster-restricted scan (the slot count provably
                    # exceeds the budget even after spill dedup)
                    with obs.span("query.scan", scan="cluster",
                                  block=lo // bq) as scsp:
                        short_np, n_slots = self._scan_cluster_block(
                            p_np, ids, clusters, max_rerank)
                        scsp.set_attr("candidates", n_slots)
                    n_probed += nv * n_slots
                    n_reranked += int((short_np < n).sum())
                    pend_pos.append(np.arange(lo, lo + nv))
                    pend_short.append(short_np)
                    continue
                with obs.span("query.union", block=lo // bq):
                    cand = np.unique(np.concatenate(
                        [self._members[c] for c in clusters]))
                if max_rerank and max_rerank < len(cand):
                    # dense fallback: block-union gather scan
                    with obs.span("query.scan", scan="dense",
                                  block=lo // bq, candidates=len(cand)):
                        short_np = self._scan_dense_block(p_np, ids, cand,
                                                          max_rerank)
                    n_probed += nv * len(cand)
                    n_reranked += int((short_np < n).sum())
                    pend_pos.append(np.arange(lo, lo + nv))
                    pend_short.append(short_np)
                    continue
                n_pairs, secs = self._unfiltered_block(
                    ratings, ids, ids_t, probe, cand, bq, lo, out_s, out_i,
                    k=k, measure=measure, beta=beta)
                n_probed += n_pairs
                n_reranked += n_pairs
                t_rerank += secs

        # pass 2 — exact rerank of the shortlists
        if pend_pos:
            with obs.span("query.rerank", kind=mode) as rsp:
                pos = np.concatenate(pend_pos)
                # ascending shortlists give the gather a monotone row walk
                # and make stable score sorts canonical (lower id wins)
                shorts = np.sort(np.concatenate(pend_short, axis=0), axis=1)
                rsp.set_attr("queries", len(pos))
                q_all = uids[pos]
                norms, counts = _user_norms_counts(ratings)
                if mode == "grouped":
                    self._rerank_grouped(ratings, norms, counts, q_all,
                                         shorts, pos, out_s, out_i, k=k,
                                         measure=measure, beta=beta)
                else:
                    self._rerank_gather(ratings, norms, counts, q_all,
                                        shorts, pos, out_s, out_i, k=k,
                                        measure=measure, beta=beta,
                                        max_rerank=max_rerank)
            t_rerank += rsp.duration
        return n_probed, n_reranked, t_rerank

    def _query_fused(self, ratings, uids, out_s, out_i, *, k, measure,
                     beta, n_probe, max_rerank, pool_all, bq):
        """Per query block: proxy scan → canonical top-M shortlist →
        candidate-union gather → exact co-rated Gram rerank, through
        device memory (the cluster branch's probe ids and member-table
        unions — pre-score data — are the only host round trips).  Blocks
        whose candidate union fits the budget take the shared-matmul
        exact path.  Returns ``(n_probed, n_reranked, seconds_rerank)``."""
        n = self.n_users
        dev = ratings.device
        use_kernel = self._use_kernel()
        m = min(max_rerank, n)
        r_gather, max_value = self._gather_cache.get(ratings)
        norms, counts = _user_norms_counts(ratings)
        n_probed = 0
        n_reranked = 0
        t_rerank = 0.0

        for lo in range(0, len(uids), bq):
            ids = uids[lo:lo + bq]
            nv = len(ids)
            ids_pad = np.full((bq,), n, np.int32)
            ids_pad[:nv] = ids
            ids_t = torch.as_tensor(ids_pad, device=dev)
            if pool_all:
                with obs.span("query.scan", scan="pool", fused=True,
                              block=lo // bq, candidates=n):
                    _, shorts = _fused_scan_pool(self.proxies, ids_t, m=m,
                                                 use_kernel=use_kernel)
                n_probed += nv * n
            else:
                probe = self._probe(ids_t, nv, n_probe, lo // bq)
                # ascending candidate ids make the restricted select's
                # block-local tie-break the canonical global-id order
                cand = np.sort(self._cluster_candidates(np.unique(probe)))
                if max_rerank >= len(cand):
                    n_pairs, secs = self._unfiltered_block(
                        ratings, ids, ids_t, probe, cand, bq, lo, out_s,
                        out_i, k=k, measure=measure, beta=beta)
                    n_probed += n_pairs
                    n_reranked += n_pairs
                    t_rerank += secs
                    continue
                cand_pad = np.full((_bucket(len(cand)),), n, np.int32)
                cand_pad[:len(cand)] = cand
                with obs.span("query.scan", scan="restricted", fused=True,
                              block=lo // bq, candidates=len(cand)):
                    _, shorts = _fused_scan_restricted(
                        self.proxies, torch.as_tensor(cand_pad, device=dev),
                        ids_t, m=m, use_kernel=use_kernel)
                n_probed += nv * len(cand)
            # the count sync also fences the scan, so its cost lands in
            # the shortlist stage (rerank timing starts after)
            n_reranked += int((shorts[:nv] < n).sum())
            with obs.span("query.rerank", kind="fused",
                          block=lo // bq) as rsp:
                s, i = _fused_rerank_block(
                    r_gather, norms, counts, ids_t[:nv], shorts[:nv], k=k,
                    measure=measure, beta=beta, use_kernel=use_kernel,
                    max_value=max_value)
                out_s[lo:lo + nv] = s.cpu().numpy()
                out_i[lo:lo + nv] = i.cpu().numpy()
            t_rerank += rsp.duration
        return n_probed, n_reranked, t_rerank

    def _rerank_gather(self, ratings, norms, counts, q_all, shorts, pos,
                       out_s, out_i, *, k, measure, beta, max_rerank):
        """The CSR-batched gather walk.

        Queries are ordered by rated-item support (their CSR row length)
        and batched into support buckets, so each call gathers one tight
        ``(b, M, nnz)`` block; item lists slice straight out of the cached
        CSR.  Queries rating more than ``_REHOME_NNZ`` items take the
        support split instead (:meth:`_rerank_pairs`): each of their
        pairs walks the *thinner* side's rated items.  Scores are the same
        either way (bit for bit on integer ratings).
        """
        dev = ratings.device
        # a repair of a few rows must not walk the whole matrix: below this
        # pending-query count (with no CSR cached for these ratings) the
        # item lists come from just the pending rows, and the support
        # split stays off (its tables are a full-matrix artifact)
        cached = self._csr_cache is not None and \
            self._csr_cache[0] is ratings
        if cached or len(q_all) > 256:
            indptr, indices, data = self._ratings_csr(ratings)
            nnz_user = (indptr[1:] - indptr[:-1]).astype(np.int64)
            nnz = nnz_user[q_all]
            row_key = q_all
            heavy = np.nonzero(nnz > _REHOME_NNZ)[0]
        else:
            q_rows = ratings[torch.as_tensor(q_all, device=dev).long()
                             ].cpu().numpy()
            rr, cc = np.nonzero(q_rows)
            nnz = np.bincount(rr, minlength=len(q_all)).astype(np.int64)
            indptr = np.zeros(len(q_all) + 1, np.int64)
            np.cumsum(nnz, out=indptr[1:])
            indices = cc.astype(np.int32)
            data = q_rows[rr, cc].astype(np.float32)
            row_key = np.arange(len(q_all))
            heavy = np.empty(0, np.int64)
        r_gather = self._gather_source(ratings)
        n_items = ratings.shape[1]
        bmax = max(_RERANK_BMAX, self.cfg.query_block)

        if len(heavy):
            self._rerank_pairs(ratings, norms, counts, q_all, shorts, pos,
                               out_s, out_i, heavy, nnz_user, k=k,
                               measure=measure, beta=beta)
            light = np.nonzero(nnz <= _REHOME_NNZ)[0]
            order = light[np.argsort(nnz[light], kind="stable")]
        else:
            order = np.argsort(nnz, kind="stable")

        def prep(lo2):
            """Host-side block prep: padded item/value/shortlist arrays."""
            tail = order[lo2:lo2 + bmax]
            nnz_b = self._rerank_bucket(max(int(nnz[tail].max()), 1),
                                        n_items)
            b = int(max(8, 1 << int(np.log2(
                max(_RERANK_BUDGET // (max_rerank * nnz_b * 4), 8)))))
            b = min(b, bmax, _bucket(len(order)))
            sel = order[lo2:lo2 + b]
            nnz_b = self._rerank_bucket(max(int(nnz[sel].max()), 1),
                                        n_items)
            items = np.zeros((b, nnz_b), np.int32)
            vals = np.zeros((b, nnz_b), np.float32)
            starts = indptr[row_key[sel]]
            lens = nnz[sel]
            total = int(lens.sum())
            if total:
                dst_row = np.repeat(np.arange(len(sel)), lens)
                dst_col = np.arange(total) - np.repeat(
                    np.cumsum(lens) - lens, lens)
                src = np.arange(total) + np.repeat(
                    starts - (np.cumsum(lens) - lens), lens)
                items[dst_row, dst_col] = indices[src]
                vals[dst_row, dst_col] = data[src]
            qi_pad = np.full((b,), self.n_users, np.int32)
            qi_pad[:len(sel)] = q_all[sel]
            sh_pad = np.full((b, max_rerank), self.n_users, np.int32)
            sh_pad[:len(sel)] = shorts[sel]
            return lo2 + b, sel, items, vals, qi_pad, sh_pad

        lo2 = 0
        pending = None          # (sel, in-flight result)
        while lo2 < len(order) or pending is not None:
            nxt = None
            if lo2 < len(order):
                lo2, sel, items, vals, qi_pad, sh_pad = prep(lo2)
                s, i = _rerank_sparse(
                    r_gather, norms, counts,
                    torch.as_tensor(qi_pad, device=dev),
                    torch.as_tensor(items, device=dev),
                    torch.as_tensor(vals, device=dev),
                    torch.as_tensor(sh_pad, device=dev), k=k,
                    measure=measure, beta=beta)
                nxt = (sel, s, i)
            if pending is not None:
                sel_p, s_p, i_p = pending
                out_s[pos[sel_p]] = s_p.cpu().numpy()[:len(sel_p)]
                out_i[pos[sel_p]] = i_p.cpu().numpy()[:len(sel_p)]
            pending = nxt

    def _rerank_pairs(self, ratings, norms, counts, q_all, shorts, pos,
                      out_s, out_i, heavy, nnz_user, *, k, measure, beta):
        """Pair-major min-side scoring for wide-support queries: their
        (query, candidate) pairs are flattened, each walks its thinner
        side (pairs grouped by that side's support bucket), mutual pairs
        are scored once, and the canonical top-k is selected on the
        host."""
        dev = ratings.device
        bucket_of, local_of, tables = self._item_tables(ratings)
        r_gather = self._gather_source(ratings)
        nh, m = len(heavy), shorts.shape[1]
        sh_h = shorts[heavy]
        q_h = q_all[heavy]
        valid = (sh_h < self.n_users).ravel()
        rows_rep = np.repeat(np.arange(nh, dtype=np.int64), m)[valid]
        slot = np.tile(np.arange(m, dtype=np.int64), nh)[valid]
        pq = np.repeat(q_h.astype(np.int64), m)[valid]
        pc = sh_h.ravel().astype(np.int64)[valid]
        keep = pq != pc                       # self pairs stay NEG_INF
        rows_rep, slot, pq, pc = (rows_rep[keep], slot[keep], pq[keep],
                                  pc[keep])
        # similarity is symmetric: mutual pairs are scored once and
        # scattered to both slots
        pkey = np.minimum(pq, pc) * np.int64(self.n_users) \
            + np.maximum(pq, pc)
        ukey, inv = np.unique(pkey, return_inverse=True)
        first = np.full(len(ukey), -1, np.int64)
        first[inv[::-1]] = np.arange(len(pkey))[::-1]  # first occurrence
        pq_u, pc_u = pq[first], pc[first]
        walk_c = nnz_user[pc_u] < nnz_user[pq_u]   # ties walk the query side
        w_ids = np.where(walk_c, pc_u, pq_u).astype(np.int32)
        v_ids = np.where(walk_c, pq_u, pc_u).astype(np.int32)
        pair_scores = np.empty(len(ukey), np.float32)

        scores_h = np.full((nh, m), np.float32(nb.NEG_INF), np.float32)
        w_bkt = bucket_of[w_ids]
        order_p = np.lexsort((w_ids, w_bkt))  # bucket-major, row-coherent
        bounds = np.searchsorted(w_bkt[order_p],
                                 np.unique(w_bkt).astype(np.int64))
        bounds = np.append(bounds, len(order_p))
        for gi in range(len(bounds) - 1):
            for lo in range(bounds[gi], bounds[gi + 1], _PAIR_BLOCK):
                sel = order_p[lo:min(lo + _PAIR_BLOCK, bounds[gi + 1])]
                pb = _bucket(len(sel), _PAIR_BLOCK)
                wl = np.zeros((pb,), np.int32)
                wi = np.zeros((pb,), np.int32)
                vi = np.zeros((pb,), np.int32)
                wl[:len(sel)] = local_of[w_ids[sel]]
                wi[:len(sel)] = w_ids[sel]
                vi[:len(sel)] = v_ids[sel]
                it, vl = tables[int(w_bkt[sel[0]])]
                s = _pair_scores_sparse(
                    r_gather, norms, counts, it, vl,
                    torch.as_tensor(wl, device=dev).long(),
                    torch.as_tensor(wi, device=dev).long(),
                    torch.as_tensor(vi, device=dev), measure=measure,
                    beta=beta)
                pair_scores[sel] = s.cpu().numpy()[:len(sel)]
        scores_h[rows_rep, slot] = pair_scores[inv]
        top_s, top_i = self._select_sorted(scores_h, sh_h, k)
        out_s[pos[heavy]] = top_s
        out_i[pos[heavy]] = top_i

    def _select_sorted(self, sc: np.ndarray, sh: np.ndarray, k: int):
        """Canonical top-``k`` of (g, M) host scores over ascending
        shortlists ``sh``: a stable sort on descending score over
        ascending-id columns is the ``(-score, id)`` order.  Pads to ``k``
        with (NEG_INF, -1); NEG_INF slots surface as id -1."""
        neg = np.float32(nb.NEG_INF)
        # reprolint: disable=canonical-selection -- stable argsort over ascending-id shortlist columns IS the canonical (-score, id) order
        o = np.argsort(-sc, axis=1, kind="stable")[:, :k]
        top_s = np.take_along_axis(sc, o, axis=1)
        top_i = np.take_along_axis(sh, o, axis=1).astype(np.int32)
        if top_s.shape[1] < k:
            padw = k - top_s.shape[1]
            top_s = np.pad(top_s, ((0, 0), (0, padw)), constant_values=neg)
            top_i = np.pad(top_i, ((0, 0), (0, padw)),
                           constant_values=self.n_users)
        return top_s, np.where(top_s <= neg, -1, top_i)

    def _rerank_grouped(self, ratings, norms, counts, q_all, shorts, pos,
                        out_s, out_i, *, k, measure, beta):
        """The grouped union-Gram rerank.

        Queries are grouped by taste cluster and each group's candidate
        union is scored once: on the card by the CUDA rerank kernel
        (:func:`fused_rerank_scores`) over int8 query and union rows (the
        gather source), the group and the union padded to buckets with
        ``q[0]`` / ``cu[0]``; elsewhere by its plain version over the f32
        rows.  Each query's shortlist maps to union columns (an appended
        NEG_INF column absorbs padding ids), self pairs are knocked out,
        and the canonical top-k is a stable descending sort over the
        ascending shortlist.  Identical to the gather walk on integer
        ratings.
        """
        dev = ratings.device
        use_kernel = self._use_kernel()
        groups = np.argsort(self.assign[q_all], kind="stable")
        r_gather, max_value = self._gather_cache.get(ratings)
        neg = np.float32(nb.NEG_INF)
        for glo in range(0, len(groups), self.cfg.rerank_batch):
            gs = groups[glo:glo + self.cfg.rerank_batch]
            q = q_all[gs]
            sh = shorts[gs]                                   # (g, M)
            cu = np.unique(sh)
            cu = cu[cu < self.n_users]
            if not len(cu):
                out_s[pos[gs]] = neg
                out_i[pos[gs]] = -1
                continue
            if use_kernel:
                # buckets bound the distinct launch shapes; padded union
                # rows duplicate cu[0] (no shortlist maps to them)
                gb = min(self.cfg.rerank_batch, _bucket(len(groups)))
                q_t = torch.as_tensor(
                    np.pad(q, (0, gb - len(q)), constant_values=q[0]),
                    device=dev).long()
                cu_t = torch.as_tensor(
                    np.pad(cu, (0, _bucket(len(cu)) - len(cu)),
                           constant_values=cu[0]), device=dev).long()
                s = fused_rerank_scores(
                    r_gather[q_t].contiguous(), r_gather[cu_t].contiguous(),
                    norms[cu_t].contiguous(), counts[cu_t].contiguous(),
                    measure=measure, beta=beta, max_value=max_value)
            else:
                q_t = torch.as_tensor(q, device=dev).long()
                cu_t = torch.as_tensor(cu, device=dev).long()
                s = rerank_scores_plain(ratings[q_t], ratings[cu_t],
                                        norms[cu_t], counts[cu_t],
                                        measure=measure, beta=beta)
            s = s.cpu().numpy()[:len(gs), :len(cu)]
            s_ext = np.concatenate(
                [s, np.full((len(gs), 1), neg, np.float32)], axis=1)
            colmap = np.full(self.n_users + 1, len(cu), np.int32)
            colmap[cu] = np.arange(len(cu))
            sc = np.take_along_axis(s_ext, colmap[sh], axis=1)  # (g, M)
            sc[sh == q[:, None]] = neg
            top_s, top_i = self._select_sorted(sc, sh, k)
            out_s[pos[gs]] = top_s
            out_i[pos[gs]] = top_i

    # -- incremental maintenance ------------------------------------------
    def refold(self, ratings: torch.Tensor, means: torch.Tensor,
               touched: np.ndarray, *,
               version: Optional[int] = None) -> RefoldStats:
        """Fold a rating delta into the index: ``touched`` are the sorted
        unique user ids whose rows changed, ``ratings``/``means`` the
        post-update tensors.  Assignment repair is exact; crossing
        ``cfg.refit_reassign_frac`` triggers a cold refit.  ``version`` is
        the caller's ratings version (the gather cache is patched along
        an unbroken version chain)."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        touched = np.atleast_1d(np.asarray(touched, np.int32))
        if touched.size == 0:
            self.last_refold = RefoldStats(0, 0, 0, 0, self.n_users)
            return self.last_refold
        with obs.span("index.refold", n_touched=int(touched.size)) as sp:
            patched = self._patch_row_caches(ratings, np.unique(touched),
                                             version, means=means)
            t_dev = torch.as_tensor(touched, device=ratings.device).long()
            p_new = self._proxy_rows(ratings[t_dev], means[t_dev])
            changed, full_rows, reassigned = self._refold_rows(touched,
                                                               p_new)
            stats = RefoldStats(
                n_touched=int(touched.size),
                n_changed_clusters=len(changed),
                n_reassigned=reassigned, n_full_rows=len(full_rows),
                n_certified=self.n_users - len(full_rows),
                caches_patched=patched)
            self._maybe_refit(ratings, means, stats)
        self.last_refold = stats
        reg = obs.registry()
        reg.counter("index.refold.count").inc()
        reg.histogram("index.refold.seconds").observe(sp.duration)
        reg.gauge("index.refold.reassign_frac").set(stats.reassigned_frac)
        reg.gauge("index.refold.caches_patched").set(stats.caches_patched)
        if stats.refit:
            reg.counter("index.refit.count").inc()
        if version is not None:
            reg.gauge("index.ratings_version").set(version)
        return stats

    # -- diagnostics -------------------------------------------------------
    def check_consistent(self, ratings: torch.Tensor,
                         means: torch.Tensor) -> bool:
        """Assert spill lists/distances and proxies equal a cold
        reassignment against the current centroids and basis, and the mass
        ledger equals a cold fold by primary cluster; raises on
        mismatch."""
        errs = self._check_spill_state(self._proxy_rows(ratings, means))
        if errs:
            raise RuntimeError(
                "index diverged from a cold reassignment: "
                f"{', '.join(errs)}")
        return True
