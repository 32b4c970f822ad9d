"""Clustered candidate-generation index: sublinear two-stage neighbor
search (port of ``repro.index.clustered``, fused query mode).

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
4. **Shortlist** — the best ``rerank_frac · U`` candidates by proxy score:
   the full pool through the CUDA scan/select kernel, or the probed
   clusters' members through the CUDA select kernel.
5. **Rerank** — the shortlist's union is scored with the *true* measure
   by the CUDA co-rated Gram rerank kernel, so returned neighbors carry
   exact similarity scores.

Per query block the stages chain through device memory (the reference's
``query_mode="fused"``); ``"auto"`` resolves to it on every device.  The
reference's staged mode, its host scans (pool, cluster, symmetric) and
gather / grouped reranks are not ported and raise ``NotImplementedError``
(ROADMAP Queue 1 item 7).  With ``n_probe == n_clusters`` and
``rerank_frac == 0`` every probed member is reranked through the exact
engines' ``pairwise_similarity`` and canonical sort: the result is
bit-identical to their top-k.

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
(``check_consistent`` asserts it, bit for bit).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

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

_STAGED = ("query_mode='staged' (the host-orchestrated pipeline with its "
           "pool / cluster / symmetric host scans and gather / grouped "
           "reranks) is not ported yet: see ROADMAP Queue 1 item 7")


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
    ``interpret``, ``rerank_mode``, ``rerank_batch`` and
    ``scan_symmetric`` belong to the reference's staged mode and its
    Pallas interpret mode; they are validated and have no effect on the
    fused chain (``scan_symmetric=True`` raises, as in the reference).
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
    rerank_mode: str = "auto"
    rerank_batch: int = 256
    # "kernel" / "pool": the full-pool scan (the CUDA scan/select kernel);
    # "cluster": the probed clusters' members through the CUDA select
    # kernel; "auto": kernel where the kernels run, else pool when
    # n_probe·spill saturates the clusters, cluster below
    shortlist_scan_mode: str = "auto"
    scan_symmetric: Optional[bool] = None
    query_mode: str = "auto"              # "auto" → "fused"
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
    rerank_mode: str = ""            # "fused"
    scan_mode: str = ""              # resolved shortlist scan mode
    query_mode: str = ""             # "fused"
    scan_gate: str = ""              # "sym:off:<reason>"

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


def _user_norms_counts(ratings):
    """Per-user full-row L2 norms (correctly rounded root) and rated-item
    counts (one cheap pass)."""
    return (sim._sqrt((ratings * ratings).sum(-1)),
            (ratings > 0).sum(-1).float())


def _abs_bound(src):
    """Largest |value| of an int8 rerank gather source (one device sync),
    the bound the rerank kernel's int8 route checks its exact domain
    against; None for an f32 source."""
    if src.dtype != torch.int8:
        return None
    return max(abs(int(v)) for v in torch.stack(torch.aminmax(src)).tolist())


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

    def __init__(self, cfg, mesh=None):
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
        if mesh is not None:
            raise NotImplementedError(
                "the sharded index fit (mesh=) is not ported yet: see "
                "ROADMAP Queue 1 item 9")
        self.cfg = cfg
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
        self._gather_cache: Optional[tuple] = None
        # ratings version chain: the gather cache is keyed by tensor
        # identity; ``refold`` advances the chain and patches a cache
        # keyed to the previous tensor instead of dropping it
        self._ratings_key = None
        self._ratings_version = 0
        self._member_table_cache = None

    def _gather_source(self, ratings):
        """Rerank gather operand (``predict.make_gather_source``: int8
        when exact), cached per ratings tensor."""
        cache = self._gather_cache
        if cache is not None and cache[0] is ratings:
            return cache[1]
        src = pred_mod.make_gather_source(ratings)
        self._gather_cache = (ratings, src)
        return src

    def _patch_row_caches(self, ratings, touched: np.ndarray,
                          version: Optional[int], means=None) -> int:
        """Advance the ratings version chain and delta-patch the gather
        cache and the subclass's caches for a user-row delta (``touched``:
        sorted unique changed user rows; ``means``: the post-delta user
        means, for caches derived from them); a broken chain drops them
        all.  Returns the number of caches patched."""
        old = self._ratings_key
        chain_ok = (old is not None and ratings is not old
                    and (version is None
                         or version == self._ratings_version + 1))
        self._ratings_key = ratings
        self._ratings_version = (version if version is not None
                                 else self._ratings_version + 1)
        if not chain_ok:
            self._gather_cache = None
            self._drop_extra_row_caches()
            return 0
        patched = 0
        cache = self._gather_cache
        if cache is not None and cache[0] is old:
            rows = torch.as_tensor(touched, device=ratings.device)
            self._gather_cache = (ratings, pred_mod.patch_gather_source(
                cache[1], ratings, rows))
            patched += 1
        else:
            self._gather_cache = None
        return patched + self._patch_extra_row_caches(ratings, means,
                                                      touched, old)

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
            use_kernel=self._use_kernel())
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
        proxies = self.proxies.clone()             # copy-on-write
        proxies[t_dev] = p_new
        self.proxies = proxies
        a_old = self.assign[touched].copy()
        np.add.at(self._sums, a_old, -p_old)
        np.add.at(self._counts, a_old, -1)
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

    def __init__(self, cfg: IndexConfig = IndexConfig(), mesh=None):
        super().__init__(cfg, mesh=mesh)
        if cfg.query_mode == "staged":
            raise NotImplementedError(_STAGED)
        self.last_query: Optional[QueryStats] = None

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

    def _query_mode(self) -> str:
        """``"auto"`` and ``"fused"`` both resolve to the fused chain (the
        staged mode raised at construction)."""
        return "fused"

    def _scan_mode(self, n_probe: int) -> str:
        """Resolve ``cfg.shortlist_scan_mode``: the scan kernel where the
        kernels run, else by probe fraction — the full pool when probing
        saturates it (``2·n_probe·spill > C``), the cluster-restricted
        scan below (the reference's rule)."""
        mode = self.cfg.shortlist_scan_mode
        if mode != "auto":
            return mode
        if self._use_kernel():
            return "kernel"
        if 2 * n_probe * self.spill_ids.shape[1] <= self.n_clusters:
            return "cluster"
        return "pool"

    def _scan_gate(self) -> str:
        """The reference's symmetric-scan gate under the fused mode: the
        symmetric scan is a host pool path, so it is always off here, and
        a forced ``scan_symmetric=True`` raises."""
        if self.cfg.scan_symmetric is False:
            return "sym:off:config"
        if self.cfg.scan_symmetric is True:
            raise ValueError(
                "scan_symmetric=True cannot run: query_mode='fused' keeps "
                "the scan on device; the symmetric-pair scan is the host "
                "pool path of the staged mode, which is not ported")
        return "sym:off:fused"

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

    # -- query -------------------------------------------------------------
    def query(self, ratings: torch.Tensor, means: torch.Tensor,
              user_ids=None, *, k: int, measure: str = "pcc",
              n_probe: Optional[int] = None,
              beta: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k true-similarity neighbors through the fused two-stage
        chain: ``(scores, neighbor_ids)`` of shape ``(len(user_ids), k)``
        on the ratings' device; sets ``self.last_query``.  With
        ``n_probe == n_clusters`` and ``rerank_frac == 0`` the result is
        bit-identical to the exact engines.  The rerank stage is measured
        and the shortlist stage absorbs the rest of the wall clock, so
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
            qmode = self._query_mode()
            # pool shortcut: candidates = the whole population, no probe
            pool_all = (bool(max_rerank) and max_rerank < self.n_users
                        and scan in ("kernel", "pool"))
            scan_gate = self._scan_gate() if max_rerank else ""
            if pool_all:
                # no per-block probe work: score in tall blocks
                bq = min(2048, _bucket(len(uids)))
            qspan.set_attr("scan_mode", scan if max_rerank else "")
            qspan.set_attr("query_mode", qmode)
            qspan.set_attr("scan_gate", scan_gate)
            qspan.set_attr("rerank_mode", "fused")
            n_probed, n_reranked, t_rerank = self._query_fused(
                ratings, uids, out_s, out_i, k=k, measure=measure,
                beta=beta, n_probe=n_probe, max_rerank=max_rerank,
                pool_all=pool_all, bq=bq)
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
                                     rerank_mode="fused",
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

    def _query_fused(self, ratings, uids, out_s, out_i, *, k, measure,
                     beta, n_probe, max_rerank, pool_all, bq):
        """Per query block: proxy scan → canonical top-M shortlist →
        candidate-union gather → exact co-rated Gram rerank, through
        device memory (the cluster branch's probe ids and member-table
        unions — pre-score data — are the only host round trips).  Blocks
        whose candidate union fits the budget (and every block of the
        degenerate ``rerank_frac = 0`` mode) take the shared-matmul exact
        path.  Returns ``(n_probed, n_reranked, seconds_rerank)``."""
        n = self.n_users
        dev = ratings.device
        use_kernel = self._use_kernel()
        m = min(max_rerank, n)
        r_gather = self._gather_source(ratings)
        max_value = _abs_bound(r_gather) if use_kernel else None
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
                with obs.span("query.probe", block=lo // bq,
                              n_probe=n_probe):
                    probe = _probe_clusters(
                        self.proxies, self.centroids, ids_t.long(),
                        n_probe=n_probe,
                        use_kernel=use_kernel).cpu().numpy()
                clusters = np.unique(probe[:nv])
                # ascending candidate ids make the restricted select's
                # block-local tie-break the canonical global-id order
                cand = np.sort(self._cluster_candidates(clusters))
                big_l = _bucket(len(cand))
                cand_pad = np.full((big_l,), n, np.int32)
                cand_pad[:len(cand)] = cand
                if not max_rerank or max_rerank >= len(cand):
                    # unfiltered block: exact per-query probe semantics
                    allowed = np.zeros((bq, big_l), bool)
                    probed_tbl = np.zeros((nv, self.n_clusters), bool)
                    probed_tbl[np.arange(nv)[:, None], probe[:nv]] = True
                    sp_c = self.spill_ids[cand]
                    allowed[:nv, :len(cand)] = probed_tbl[:, sp_c].any(-1)
                    n_pairs = int((allowed[:nv] & (cand_pad[None, :]
                                                   != ids[:, None])).sum())
                    n_probed += n_pairs
                    n_reranked += n_pairs
                    with obs.span("query.rerank", kind="shared",
                                  block=lo // bq, rows=n_pairs) as rsp:
                        s, i = _rerank_shared(
                            ratings, ids_t.long(),
                            torch.as_tensor(cand_pad, device=dev).long(),
                            torch.as_tensor(allowed, device=dev), k=k,
                            measure=measure, beta=beta)
                        out_s[lo:lo + bq] = s.cpu().numpy()[:nv]
                        out_i[lo:lo + bq] = i.cpu().numpy()[:nv]
                    t_rerank += rsp.duration
                    continue
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
                                             version)
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
