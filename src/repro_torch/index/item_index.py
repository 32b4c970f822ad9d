"""Item-side clustered index: the two-stage *recommend* path (port of
``repro.index.item_index``).

The exact recommend path scores every item for every query user.
:class:`ItemClusteredIndex` applies the user index's two-stage idea on the
item axis:

1. **Project** — item *columns* of the rating matrix (optionally centered
   by user means) become unit proxy vectors through the same seeded
   randomized-SVD basis and fixed-order projection as the user index.
2. **Cluster** — the shared blocked spill k-means partitions the items;
   each item spill-assigns to its nearest clusters (all bookkeeping in
   ``_SpillClusterCore``).
3. **Shortlist** — a full-width scorer ranks the unseen items per query
   user and the canonical top ``shortlist`` go forward.  Three scorers
   (``shortlist_mode``):

   * ``"support"`` — the reference's item-major host pass: the predictor
     ``r̄_u + Σ w·dev / Σ w·mask`` for every item as one scipy sparse
     product ``W @ [DEV | MASK]`` between the k-sparse neighbor-weight
     matrix and the stacked deviation / rated-mask CSR table (cached per
     ratings tensor, its rows spliced on a delta), in f32 with the clip
     epilogue, then a row-wise argpartition with the canonical tie
     repair at the cut (:meth:`ItemClusteredIndex._select_shortlist`).
     The reference's numpy and scipy calls on the same arrays, so the
     shortlists equal the reference's bit for bit.  Chunks of
     ``score_block`` users are scored on two host threads while the
     device reranks the chunk before (the reference's pipeline; results
     are consumed in order).
   * ``"kernel"`` (what ``"auto"`` resolves to on every device; the
     reference's ``"auto"`` picks ``"support"`` on a CPU host) — the
     exact predictor num/den form for every item, as one segmented SpMM
     between the k-sparse neighbor weights and the deviation / rated-mask
     tables: the CUDA support kernel on the card
     (``repro_torch.kernels.support``), its plain version on the CPU or
     with ``use_kernel=False``.  When the ratings round-trip through int8
     the scorer takes its int8 route — the int8 gather source and the
     user means in place of the tables, which are then never built —
     else the dense f32 tables.  Selection is the CUDA select kernel
     (``kernels/select.py::select_topm``), so the (b, I) scores never
     leave the device.
   * ``"proxy"`` — each user's *taste profile* in item-proxy space
     (``Σ max(r−r̄,0)·proxy_i`` over their rated items, neighbors'
     profiles combined with the prediction weights) probes its
     ``n_probe`` nearest item clusters (the CUDA centroid-distance
     kernel) and the probed members are ranked by proxy score.

4. **Rerank** — only the shortlist is scored with the true prediction
   (``repro_torch.core.predict.predict_items``, the exact path's ordered
   arithmetic), masked to unseen items, and sorted canonically by
   ``(−score, id)``.

The support score equals the exact prediction bit for bit (the same
ordered k-loop on the same rounded ``r − r̄`` values), and shortlist
selection is canonical with seen items at ``−inf``, so the canonical
top-``shortlist`` set always holds the canonical top-n: with the kernel
scorer and ``shortlist ≥ n`` the result equals the exact recommend path
bit for bit, ids and scores.  With ``n_probe == n_clusters`` and
``shortlist = 0`` (uncapped) every item is reranked — the degenerate mode,
exact by construction.

Maintenance mirrors the user index: ``refold`` refreshes the touched item
columns' proxies, repairs spill assignments exactly through the shared
certificate, and maintains the user profiles by a rank-deficient
correction (untouched users take ``Σ w_col · Δproxy`` over the touched
columns; touched users are recomputed in full), with a periodic cold
re-fold; the dense scorer tables (f32 route) and the support CSR are
patched copy-on-write along the ratings version chain, so a serving
snapshot's tables stay valid.
``check_consistent`` asserts all of it against a cold rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import predict as pred_mod
from repro_torch.core import similarity as sim
from repro_torch.index.clustered import (RefoldStats, _argpartition_rows,
                                         _bucket, _patch_csr, _project,
                                         _SpillClusterCore, _svd_basis)
from repro_torch.index.kmeans import center_rows, normalize_rows
from repro_torch.kernels import select as sel_mod
from repro_torch.kernels.ref import proxy_scores_ref
from repro_torch.kernels.support import (fused_support_scores,
                                         support_scores_int8_plain,
                                         support_scores_plain,
                                         support_tables, support_width)

SHORTLIST_MODES = ("support", "kernel", "proxy", "auto")

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class ItemIndexConfig:
    """Tuning knobs for :class:`ItemClusteredIndex` (the reference's fields
    and defaults).

    Auto values: ``n_clusters = 0`` → ``⌈√I⌉``; ``n_probe = 0`` → half the
    clusters.  ``shortlist`` caps the exactly-reranked candidate items per
    user (``0`` reranks every probed item — the exact degenerate mode when
    ``n_probe = n_clusters``).  ``project_dim`` is clamped to the user
    count; ``0`` disables the projection.  ``features="centered"``
    clusters columns of the user-mean deviation matrix, ``"raw"`` raw
    rating columns (a rating write then touches only its own column).
    ``shortlist_mode="auto"`` resolves to ``"kernel"``; ``"support"`` is
    the host scipy pass.  ``use_kernel=None`` runs the CUDA
    kernels on CUDA tensors, ``False`` their plain versions on any device;
    ``interpret`` (the reference's Pallas interpret mode) is kept for
    config parity and has no effect.
    """
    n_clusters: int = 0
    n_probe: int = 0
    seed: int = 0
    iters: int = 8
    features: str = "raw"                 # "raw" | "centered"
    project_dim: int = 128
    spill: int = 2
    shortlist: int = 512
    shortlist_mode: str = "auto"          # "support" | "kernel" | "proxy" |
                                          # "auto" (→ "kernel")
    item_block: int = 512                 # rerank/predict tile width
    kmeans_block: int = 2048
    query_block: int = 256                # proxy-path users per block
    score_block: int = 8192               # support-scorer users per chunk
    rerank_block: int = 1024              # support-path rerank batch
    use_kernel: Optional[bool] = None
    interpret: bool = False
    refit_reassign_frac: float = 0.5      # shared auto-refit drift guard
    # periodic profile re-fold: once the cumulative touched-column fraction
    # since the last fold crosses this, profiles are re-folded cold, zeroing
    # the Σ w·Δproxy correction's float drift (0 disables)
    profile_refold_frac: float = 0.25


@dataclasses.dataclass
class RecommendStats:
    """Work accounting for one ``recommend`` call."""
    n_queries: int
    n_items: int           # candidate population the fractions refer to
    n_probed: int          # probed-member items summed over queries
    n_reranked: int        # items exactly predicted (true rerank)

    def _frac(self, total: int) -> float:
        return total / max(self.n_queries * max(self.n_items, 1), 1)

    @property
    def probed_fraction(self) -> float:
        return self._frac(self.n_probed)

    @property
    def rerank_fraction(self) -> float:
        return self._frac(self.n_reranked)


def _item_feats(cols: torch.Tensor, means: torch.Tensor, *,
                features: str) -> torch.Tensor:
    """(U, T) column slice of the rating matrix → (T, U) unit feature rows
    (fixed-order norms, so a column's features do not depend on the
    columns beside it).  ``centered`` subtracts each rating user's mean on
    rated cells (a zero stays "no information")."""
    z = center_rows(cols, means) if features == "centered" else cols
    return normalize_rows(z.T).contiguous()


def _affinity_weights(ratings: torch.Tensor, means: torch.Tensor):
    """Per-user item-affinity weights for the taste profile: positive
    above-mean deviation, falling back to the plain rated mask for users
    with no above-mean rating (so every rated user has a live profile)."""
    mask = ratings > 0
    zero = torch.zeros((), dtype=torch.float32, device=ratings.device)
    pos = torch.where(mask, (ratings - means[:, None]).clamp_min(0.0), zero)
    has_pos = (pos > 0).any(dim=1)
    return torch.where(has_pos[:, None], pos, mask.float()), has_pos


def _fold_profiles(w: torch.Tensor, proxies: torch.Tensor) -> torch.Tensor:
    """(U, I) affinity weights × (I, p) item proxies → (U, p) profiles."""
    return w @ proxies


def _query_profiles(profiles, nb_scores, nb_idx, q_ids):
    """Unit recommendation profile per query row: the cached neighbors'
    profiles combined with the prediction weights; a user with no
    positive-score neighbor falls back to their own profile."""
    n_users = profiles.shape[0]
    w = torch.where((nb_scores > 0.0) & (nb_idx >= 0), nb_scores,
                    torch.zeros_like(nb_scores))
    nbp = profiles[nb_idx.long().clamp(0, n_users - 1)]        # (b, k, p)
    agg = (w[..., None] * nbp).sum(dim=1)
    own = profiles[q_ids.long().clamp(0, n_users - 1)]
    has_nb = (w > 0).any(dim=1, keepdim=True)
    return normalize_rows(torch.where(has_nb, agg, own))


def _shortlist_scores(prof, proxies, cand_ids, seen_rows):
    """Proxy affinity of each query profile against the shared candidate
    item set (fixed-order dot products); seen items → −inf."""
    cand = cand_ids.long()
    sp = proxy_scores_ref(prof, proxies[cand])                 # (b, L)
    return sp.masked_fill(seen_rows[:, cand], _NEG_INF)


def _shortlist_scores_all(prof, proxies, seen_rows):
    """Full-pool variant (column j is item j): no candidate gather."""
    return proxy_scores_ref(prof, proxies).masked_fill(seen_rows, _NEG_INF)


def _support_rows(rows: np.ndarray, row_means: np.ndarray) -> np.ndarray:
    """(b, I) rating rows → (b, 2I) stacked [deviation | rated-mask] (the
    rows the support CSR's splice writes)."""
    mask = rows > 0
    dev = np.where(mask, rows - row_means[:, None], 0.0).astype(np.float32)
    return np.concatenate([dev, mask.astype(np.float32)], axis=1)


def _support_csr(rnp: np.ndarray, means_np: np.ndarray):
    """Sparse (U, 2I) stacked [deviation | rated-mask] in scipy CSR.  Both
    channels share the rating matrix's sparsity pattern, so the structure
    comes from one ``np.nonzero`` scan."""
    from scipy import sparse
    n_users, n_items = rnp.shape
    rows, cols = np.nonzero(rnp)
    counts = np.bincount(rows, minlength=n_users)
    indptr = np.zeros(n_users + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    dev_vals = (rnp[rows, cols] - means_np[rows]).astype(np.float32)
    dev = sparse.csr_matrix((dev_vals, cols.astype(np.int32), indptr),
                            shape=(n_users, n_items))
    mask = sparse.csr_matrix(
        (np.ones(len(cols), np.float32), cols.astype(np.int32), indptr),
        shape=(n_users, n_items))
    return sparse.hstack([dev, mask], format="csr")


def _rerank_items(ratings, gather_src, nb_scores, nb_idx, means, q_means,
                  q_ids, cand_items, *, n, item_block):
    """Exact top-n over per-query candidate item lists.

    Predictions come from the exact path's ordered arithmetic
    (``predict_items``); selection is the canonical ``(−score, item id)``
    order, so the full-candidate case equals the exact recommend bit for
    bit.  Seen and padding slots get −inf and surface as item id −1."""
    n_users, n_items = ratings.shape
    pred = pred_mod.predict_items(ratings, nb_scores, nb_idx, cand_items,
                                  means=means, query_means=q_means,
                                  item_block=item_block,
                                  gather_src=gather_src)
    safe_items = cand_items.long().clamp(0, n_items - 1)
    rows = ratings[q_ids.long().clamp(0, n_users - 1)]
    seen = torch.gather(rows, 1, safe_items) > 0
    invalid = (cand_items < 0) | (cand_items >= n_items) | seen
    s = pred.masked_fill(invalid, _NEG_INF)
    ids = cand_items.to(torch.int32)
    if s.shape[1] < n:
        pad = n - s.shape[1]
        s = torch.cat([s, s.new_full((s.shape[0], pad), _NEG_INF)], 1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), n_items)], 1)
    top_s, top_i = sel_mod.topk_canonical(s, ids, n)
    return top_s, torch.where(top_s == _NEG_INF, torch.full_like(top_i, -1),
                              top_i)


class ItemClusteredIndex(_SpillClusterCore):
    """Item-clustering index powering the two-stage recommend path (see
    module docstring).  Never owns the rating matrix or the neighbor
    cache — the caller (``CFEngine``) passes both into every call.

    Single writer, lock-free readers (audited by the runtime race harness,
    ``repro.analysis.races``): ``refold`` / ``fit`` run on the engine's
    update thread while the serving batcher calls ``recommend``.  Every
    published tensor and cache tuple is replaced by one reference swap,
    never written in place, and a reader's snapshot ratings decide the
    returned scores — the index state only shapes the candidate set.
    """

    _reprolint_race_ok = {
        "_support_dense_cache": "immutable (ratings, tables) tuple swapped "
                                "atomically, read once, validated by "
                                "ratings identity; patched copy-on-write",
        "_support_cache": "same contract as _support_dense_cache: the "
                          "support CSR is spliced into a new matrix and "
                          "published as one tuple",
        "centroids": "replaced by one reference swap in refold/fit; the "
                     "kernel-scorer path reads it only through fitted "
                     "(a None check)",
        "n_rows": "rebound only by a refit on the update thread, to the "
                  "same item count",
        "n_users": "rebound only by a refit, to the same user count",
        "n_clusters": "rebound only by a refit, from the same config and "
                      "item count",
        "n_probe": "rebound only by a refit, from the same config and "
                   "item count",
    }

    def __init__(self, cfg: ItemIndexConfig = ItemIndexConfig(), mesh=None,
                 mesh_axis: str = "data"):
        if cfg.shortlist_mode not in SHORTLIST_MODES:
            raise ValueError(f"unknown shortlist_mode {cfg.shortlist_mode!r}"
                             f"; want one of {SHORTLIST_MODES}")
        super().__init__(cfg, mesh=mesh, mesh_axis=mesh_axis)
        self.n_users = 0
        self.profiles: Optional[torch.Tensor] = None   # (U, p) taste mass
        self._has_pos: Optional[torch.Tensor] = None   # (U,) bool
        self._support_cache: Optional[tuple] = None    # host [dev|mask] CSR
        self._support_dense_cache: Optional[tuple] = None  # scorer tables
        self._touched_since_profile = 0                # profile-refold drift
        self.last_recommend: Optional[RecommendStats] = None

    @property
    def n_items(self) -> int:
        return self.n_rows

    def _shortlist_mode(self) -> str:
        """``"auto"`` resolves to the kernel scorer on every device (the
        CUDA kernel on the card, its plain version on the CPU; the
        reference's resolves to the host pass on a CPU host)."""
        mode = self.cfg.shortlist_mode
        return "kernel" if mode == "auto" else mode

    def _support_dense(self, ratings, means):
        """The support scorer's dense (U, I') deviation / mask tables,
        padded once to a multiple of ``BT`` columns (the reference's
        operand layout), cached per ratings tensor.  The cache reference
        is read once: a serving batch may call this while ``refold`` swaps
        it on the writer thread, and a stale entry only costs a rebuild."""
        cache = self._support_dense_cache
        if cache is not None and cache[0] is ratings:
            return cache[1]
        pair = support_tables(ratings, means, support_width(ratings.shape[1]))
        self._support_dense_cache = (ratings, pair)
        return pair

    def _support_table(self, ratings, means):
        """The host support scorer's stacked [deviation | mask] CSR,
        cached per ratings tensor (an update replaces the tensor, which
        invalidates by identity; ``refold`` splices it instead).  The
        cache reference is read once, as ``_support_dense`` reads its."""
        cache = self._support_cache
        if cache is not None and cache[0] is ratings:
            return cache[1]
        tbl = _support_csr(ratings.cpu().numpy(), means.cpu().numpy())
        self._support_cache = (ratings, tbl)
        return tbl

    def _proxy_rows(self, cols, means):
        """(U, T) column slice → (T, p) unit proxies."""
        z = _item_feats(cols, means, features=self.cfg.features)
        return _project(z, self.basis) if self.basis is not None else z

    # -- fit ---------------------------------------------------------------
    def fit(self, ratings: torch.Tensor,
            means: Optional[torch.Tensor] = None) -> "ItemClusteredIndex":
        """Project, cluster, and spill-assign the item columns, then fold
        every user's taste profile into item-proxy space."""
        ratings = torch.as_tensor(ratings).float()
        self.device = ratings.device
        self._ratings_key = ratings          # (re)anchor the version chain
        self.n_users, self.n_rows = ratings.shape
        if means is None:
            means = sim.user_stats(ratings)[2]
        self._resolve_sizes()

        with obs.span("item_index.fit", device_sync=True,
                      n_users=self.n_users, n_items=self.n_rows,
                      n_clusters=self.n_clusters) as sp:
            z = _item_feats(ratings, means, features=self.cfg.features)
            p = min(self.cfg.project_dim, self.n_users)
            if self.cfg.project_dim and p < self.n_users:
                with obs.span("fit.svd_basis", dim=p):
                    self.basis = torch.as_tensor(
                        _svd_basis(z.cpu().numpy(), p, self.cfg.seed),
                        device=self.device)
            else:
                self.basis = None
            self.proxies = (_project(z, self.basis)
                            if self.basis is not None else z)
            self._fit_clusters()
            w, has_pos = _affinity_weights(ratings, means)
            self.profiles = _fold_profiles(w, self.proxies)
            self._has_pos = has_pos
            self._support_cache = None
            self._support_dense_cache = None
            self._touched_since_profile = 0
            if self._shortlist_mode() == "support":
                self._support_table(ratings, means)     # pre-warm
            sp.track(self.profiles)
        obs.histogram("item_index.fit.seconds").observe(sp.duration)
        return self

    # -- recommend ---------------------------------------------------------
    def recommend(self, ratings: torch.Tensor, means: torch.Tensor,
                  nb_scores: torch.Tensor, nb_idx: torch.Tensor,
                  user_ids=None, *, n: int = 10,
                  n_probe: Optional[int] = None,
                  shortlist: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-n unseen items through the two-stage pipeline.

        ``nb_scores``/``nb_idx``: the engine's full (U, k) neighbor cache
        (the prediction weights).  Returns ``(scores, item_ids)`` of shape
        ``(len(user_ids), n)`` on the ratings' device, exact predicted
        ratings as scores and −1 for slots a user cannot fill; sets
        ``self.last_recommend``.  ``n_probe``/``shortlist`` override the
        config budgets for this call only (the serving ladder's knobs).
        """
        if not self.fitted:
            raise RuntimeError("call fit() first")
        uids = (np.arange(self.n_users, dtype=np.int64) if user_ids is None
                else np.atleast_1d(np.asarray(user_ids, np.int64)))
        if uids.size == 0:
            self.last_recommend = RecommendStats(0, self.n_items, 0, 0)
            return (torch.zeros((0, n), dtype=torch.float32,
                                device=ratings.device),
                    torch.full((0, n), -1, dtype=torch.int32,
                               device=ratings.device))
        n_probe = min(n_probe or self.n_probe, self.n_clusters)
        shortlist = self.cfg.shortlist if shortlist is None \
            else max(int(shortlist), n)
        scorer = self._shortlist_mode()
        if shortlist and scorer in ("support", "kernel") \
                and max(n, shortlist) < self.n_items:
            run = (self._recommend_support if scorer == "support"
                   else self._recommend_kernel)
            with obs.span("item_index.recommend", n_queries=len(uids), n=n,
                          scorer=scorer) as sp:
                out = run(ratings, means, nb_scores, nb_idx, uids, n=n,
                          shortlist=shortlist)
        else:
            with obs.span("item_index.recommend", n_queries=len(uids), n=n,
                          scorer="proxy") as sp:
                out = self._recommend_proxy(ratings, means, nb_scores,
                                            nb_idx, uids, n=n,
                                            n_probe=n_probe,
                                            shortlist=shortlist)
        st = self.last_recommend
        reg = obs.registry()
        reg.counter("item_index.recommend.count").inc()
        reg.counter("item_index.recommend.queries").inc(st.n_queries)
        reg.counter("item_index.recommend.reranked_rows").inc(st.n_reranked)
        reg.histogram("item_index.recommend.seconds").observe(sp.duration)
        return out

    def _select(self, scores: torch.Tensor, m: int):
        """Canonical top-``m`` of (b, L) scores (knockouts already −inf):
        the CUDA select kernel, or its plain version."""
        none = torch.full((scores.shape[0],), -1, dtype=torch.int32,
                          device=scores.device)
        if self._use_kernel():
            return sel_mod.select_topm(scores, none, m=m)
        return sel_mod.select_topm_twin(scores, none, m=m)

    def _support_operands(self, ratings, means):
        """The support scorer's (dev, msk) operand pair: the int8 gather
        source and the (U,) means when the ratings round-trip through int8
        (the scorer's int8 route: no tables built), else the dense f32
        tables."""
        src = self._gather_source(ratings)
        if src.dtype == torch.int8:
            return src, means.contiguous()
        return self._support_dense(ratings, means)

    def _score_select(self, ratings, means, nb_scores, nb_idx, ids,
                      operands, m_short: int) -> torch.Tensor:
        """Support-score one chunk of query rows (every item, exact num/den
        form, seen items → −inf) and select its canonical top-``m_short``
        items on the device: (b, m_short) ascending ids, sentinel
        ``n_items`` on every −inf slot.  ``operands``: the scorer's
        (dev, msk) pair (:meth:`_support_operands`)."""
        n_items = self.n_items
        sc, ix = nb_scores[ids], nb_idx[ids]
        w = torch.where((sc > 0.0) & (ix >= 0), sc,
                        torch.zeros_like(sc)).contiguous()
        safe = torch.where(ix >= 0, ix, torch.zeros_like(ix)).to(
            torch.int32).contiguous()
        qm = means[ids].contiguous()
        if self._use_kernel():
            scorer = fused_support_scores
        elif operands[0].dtype == torch.int8:
            scorer = support_scores_int8_plain
        else:
            scorer = support_scores_plain
        num = scorer(*operands, safe, w, qm)[:, :n_items]
        num = num.masked_fill(ratings[ids] > 0, _NEG_INF).contiguous()
        # −inf slots already carry the sentinel id n_items (= num's width)
        return torch.sort(self._select(num, m_short)[1], dim=1).values

    def _recommend_kernel(self, ratings, means, nb_scores, nb_idx,
                          uids: np.ndarray, *, n: int, shortlist: int):
        """Kernel-scorer path: every item scored with the exact num/den
        predictor form in chunks of ``score_block`` users, the canonical
        top ``shortlist`` unseen items per user selected on the device,
        then the exact rerank in batches of ``rerank_block``."""
        n_items = self.n_items
        m_short = min(max(n, shortlist), n_items)
        dev = ratings.device
        gather_src = self._gather_source(ratings)
        operands = self._support_operands(ratings, means)
        out_s, out_i = [], []
        n_reranked = 0
        sb, bq = self.cfg.score_block, self.cfg.rerank_block
        for ci, lo in enumerate(range(0, len(uids), sb)):
            ids = torch.as_tensor(uids[lo:lo + sb], device=dev)
            with obs.span("recommend.score", chunk=ci, rows=len(ids)):
                shorts = self._score_select(ratings, means, nb_scores,
                                            nb_idx, ids, operands, m_short)
            n_reranked += int((shorts < n_items).sum())
            for b0 in range(0, len(ids), bq):
                sub = ids[b0:b0 + bq]
                with obs.span("recommend.rerank", chunk=ci, rows=len(sub)):
                    s, i = _rerank_items(
                        ratings, gather_src, nb_scores[sub], nb_idx[sub],
                        means, means[sub], sub, shorts[b0:b0 + bq], n=n,
                        item_block=self.cfg.item_block)
                out_s.append(s)
                out_i.append(i)
        self.last_recommend = RecommendStats(
            n_queries=len(uids), n_items=n_items,
            n_probed=len(uids) * n_items, n_reranked=n_reranked)
        return torch.cat(out_s), torch.cat(out_i)

    def _score_select_rows(self, stacked, w, safe_idx, q_means, seen_rows,
                           m_short: int) -> np.ndarray:
        """Score one row chunk on the host (exact f32 num/den, clip
        epilogue, seen → −inf) and select its canonical top-``m_short``
        items: (b, m_short) ascending ids, ``n_items`` on empty slots.
        Runs on one thread; :meth:`_recommend_support` fans chunks over
        two (scipy's product and numpy's selection release the GIL)."""
        with obs.span("recommend.score", rows=int(w.shape[0])):
            return self._score_select_rows_body(stacked, w, safe_idx,
                                                q_means, seen_rows, m_short)

    def _score_select_rows_body(self, stacked, w, safe_idx, q_means,
                                seen_rows, m_short: int) -> np.ndarray:
        from scipy import sparse
        n_items = self.n_items
        rows = np.repeat(np.arange(w.shape[0]), w.shape[1])
        W = sparse.csr_matrix((w.reshape(-1), (rows, safe_idx.reshape(-1))),
                              shape=(w.shape[0], self.n_users))
        nd = (W @ stacked).toarray()                  # (b, 2I)
        num, den = nd[:, :n_items], nd[:, n_items:]
        qm = q_means[:, None]
        fallback = den <= 1e-8
        np.maximum(den, 1e-8, out=den)
        np.divide(num, den, out=num)
        num += qm
        np.clip(num, 1.0, 5.0, out=num)
        np.copyto(num, np.broadcast_to(qm, num.shape), where=fallback)
        num[seen_rows] = -np.inf
        return self._select_shortlist(num, m_short)

    def _select_shortlist(self, num: np.ndarray, m_short: int) -> np.ndarray:
        """Canonical top-``m_short`` selection over scored rows (seen items
        already −inf).  A plain argpartition is canonical except where the
        cut value is tied beyond the cap — the 5.0 clip group, or the
        query-mean fallback group — and those rows are repaired one by
        one: every item strictly above the cut stays and the tie group
        gives its lowest item ids, the exact path's tie order."""
        with obs.span("recommend.select", rows=int(num.shape[0])):
            return self._select_shortlist_body(num, m_short)

    def _select_shortlist_body(self, num: np.ndarray,
                               m_short: int) -> np.ndarray:
        n_items = self.n_items
        sel = _argpartition_rows(num, m_short)
        selv = np.take_along_axis(num, sel, 1)
        shorts = np.where(selv == -np.inf, n_items, sel).astype(np.int32)
        vb = np.min(np.where(selv == -np.inf, np.inf, selv), axis=1)
        vb = np.where(np.isfinite(vb), vb, np.inf)
        row_cnt = np.count_nonzero(num == vb[:, None], axis=1)
        sel_cnt = np.count_nonzero(selv == vb[:, None], axis=1)
        for row in np.nonzero(row_cnt > sel_cnt)[0]:
            v = vb[row]
            above = np.nonzero(num[row] > v)[0]
            tied = np.nonzero(num[row] == v)[0][:m_short - len(above)]
            merged = np.concatenate([above, tied]).astype(np.int32)
            shorts[row, :len(merged)] = merged
            shorts[row, len(merged):] = n_items
        return np.sort(shorts, axis=1)

    def _recommend_support(self, ratings, means, nb_scores, nb_idx,
                           uids: np.ndarray, *, n: int, shortlist: int):
        """Host support-scorer path: every item scored with the exact
        num/den form by the ``W @ [DEV|MASK]`` sparse product, the
        canonical top ``shortlist`` unseen items per user, then the exact
        rerank on the ratings' device.  Two host threads score chunk i+1
        (each chunk halved over them) while the device reranks chunk i;
        chunks are consumed in order."""
        from concurrent.futures import ThreadPoolExecutor
        stacked = self._support_table(ratings, means)
        n_items = self.n_items
        m_short = min(max(n, shortlist), n_items)
        dev = ratings.device
        gather_src = self._gather_source(ratings)
        rnp = ratings.cpu().numpy()
        means_np = means.cpu().numpy()
        sc_np = nb_scores.cpu().numpy()
        idx_np = nb_idx.cpu().numpy()
        out_s, out_i = [], []
        n_reranked = 0
        sb, bq = self.cfg.score_block, self.cfg.rerank_block

        def score_chunk(pool, ids):
            """Futures of one chunk's shortlists, halved over the pool."""
            w = np.where((sc_np[ids] > 0) & (idx_np[ids] >= 0),
                         sc_np[ids], 0.0).astype(np.float32)
            safe = np.where(idx_np[ids] >= 0, idx_np[ids], 0)
            seen = rnp[ids] > 0
            half = (len(ids) + 1) // 2 if len(ids) >= 64 else len(ids)
            return [pool.submit(self._score_select_rows, stacked,
                                w[h0:h0 + half], safe[h0:h0 + half],
                                means_np[ids[h0:h0 + half]],
                                seen[h0:h0 + half], m_short)
                    for h0 in range(0, len(ids), half)]

        starts = list(range(0, len(uids), sb))
        with ThreadPoolExecutor(max_workers=2) as pool:
            pending = score_chunk(pool, uids[:sb])
            for ci, lo in enumerate(starts):
                ids = uids[lo:lo + sb]
                shorts = np.concatenate([f.result() for f in pending])
                if ci + 1 < len(starts):
                    nxt = starts[ci + 1]
                    pending = score_chunk(pool, uids[nxt:nxt + sb])
                n_reranked += int((shorts < n_items).sum())
                shorts_t = torch.as_tensor(shorts, device=dev)
                ids_t = torch.as_tensor(ids, device=dev)
                for b0 in range(0, len(ids), bq):
                    sub = ids_t[b0:b0 + bq]
                    with obs.span("recommend.rerank", chunk=ci,
                                  rows=len(sub)):
                        s, i = _rerank_items(
                            ratings, gather_src, nb_scores[sub],
                            nb_idx[sub], means, means[sub], sub,
                            shorts_t[b0:b0 + bq], n=n,
                            item_block=self.cfg.item_block)
                    out_s.append(s)
                    out_i.append(i)
        self.last_recommend = RecommendStats(
            n_queries=len(uids), n_items=n_items,
            n_probed=len(uids) * n_items, n_reranked=n_reranked)
        return torch.cat(out_s), torch.cat(out_i)

    def _recommend_proxy(self, ratings, means, nb_scores, nb_idx,
                         uids: np.ndarray, *, n: int, n_probe: int,
                         shortlist: int):
        """The proxy-scorer path: per query block, probe item clusters near
        the block's taste profiles, proxy-shortlist the probed members,
        exact rerank.  Full probing with ``shortlist = 0`` reranks every
        item (the degenerate mode)."""
        n_items = self.n_items
        dev = ratings.device
        gather_src = self._gather_source(ratings)
        bq = min(self.cfg.query_block, _bucket(len(uids)))
        out_s, out_i = [], []
        n_probed = 0
        n_reranked = 0
        # full probing covers every item (each item's primary cluster is
        # always among its spill clusters), so skip the per-block union
        pool_all = n_probe >= self.n_clusters
        m_short = max(n, shortlist) if shortlist else 0
        for blk, lo in enumerate(range(0, len(uids), bq)):
            ids = torch.as_tensor(uids[lo:lo + bq], device=dev)
            nv = len(ids)
            nbs, nbi = nb_scores[ids], nb_idx[ids]
            prof = _query_profiles(self.profiles, nbs, nbi, ids)
            seen_rows = ratings[ids] > 0                      # (nv, I)
            if pool_all:
                cand = np.arange(n_items, dtype=np.int32)
            else:
                d = self._distances(prof, self.centroids)
                probe = sel_mod.smallest_k(d, n_probe)[1].cpu().numpy()
                # ascending ids: the select's column tie-break is then the
                # canonical item-id order
                cand = np.unique(np.concatenate(
                    [self._members[c] for c in np.unique(probe)]))
            n_cand = len(cand)
            n_probed += nv * n_cand
            cand_t = torch.as_tensor(cand, device=dev)
            if m_short and m_short < n_cand:
                with obs.span("recommend.shortlist", block=blk,
                              candidates=n_cand):
                    sp = (_shortlist_scores_all(prof, self.proxies,
                                                seen_rows) if pool_all
                          else _shortlist_scores(prof, self.proxies, cand_t,
                                                 seen_rows))
                    v, sel = self._select(sp.contiguous(), m_short)
                    # the sentinel (n_cand) of −inf slots is clamped before
                    # the gather, then masked
                    picked = cand_t[sel.long().clamp_max(n_cand - 1)]
                    short = torch.where(torch.isneginf(v),
                                        torch.full_like(picked, n_items),
                                        picked)
                    short = torch.sort(short, dim=1).values
            else:
                short = cand_t[None, :].expand(nv, -1)
            n_reranked += int((short < n_items).sum())
            with obs.span("recommend.rerank", block=blk, rows=nv):
                s, i = _rerank_items(ratings, gather_src, nbs, nbi, means,
                                     means[ids], ids, short, n=n,
                                     item_block=self.cfg.item_block)
            out_s.append(s)
            out_i.append(i)
        self.last_recommend = RecommendStats(
            n_queries=len(uids), n_items=n_items,
            n_probed=n_probed, n_reranked=n_reranked)
        return torch.cat(out_s), torch.cat(out_i)

    # -- delta-aware cache maintenance -------------------------------------
    def _patch_extra_row_caches(self, ratings, means, touched, old) -> int:
        """Patch the scorer operands for a user-row delta, copy-on-write
        (a reader holding the old ones keeps them valid): the support CSR
        gets a row splice (the touched users' rows re-derive from their
        moved means, every other row's span is bulk-copied), the dense
        tables a row scatter into fresh copies."""
        patched = 0
        rows = torch.as_tensor(touched, device=ratings.device).long()
        cache = self._support_cache
        if cache is not None and cache[0] is old and means is not None:
            from scipy import sparse
            tbl = cache[1]
            stacked_rows = _support_rows(ratings[rows].cpu().numpy(),
                                         means[rows].cpu().numpy())
            indptr, idx, data = _patch_csr(
                (tbl.indptr.astype(np.int64), tbl.indices, tbl.data),
                touched, stacked_rows)
            self._support_cache = (ratings, sparse.csr_matrix(
                (data, idx, indptr), shape=(self.n_users, 2 * self.n_items)))
            patched += 1
        else:
            self._support_cache = None
        cache = self._support_dense_cache
        if cache is not None and cache[0] is old and means is not None:
            dev_t, msk_t = cache[1]
            d_rows, m_rows = support_tables(ratings[rows], means[rows],
                                            dev_t.shape[1])
            dev_t, msk_t = dev_t.clone(), msk_t.clone()
            dev_t[rows] = d_rows
            msk_t[rows] = m_rows
            self._support_dense_cache = (ratings, (dev_t, msk_t))
            patched += 1
        else:
            self._support_dense_cache = None
        return patched

    def _drop_extra_row_caches(self) -> None:
        self._support_cache = None
        self._support_dense_cache = None

    # -- incremental maintenance ------------------------------------------
    def refold(self, ratings: torch.Tensor, means: torch.Tensor,
               touched_users, touched_items, *,
               version: Optional[int] = None) -> RefoldStats:
        """Fold a rating delta into the item index.

        ``touched_users``/``touched_items``: the delta's distinct user and
        item ids; ``ratings``/``means`` the post-update tensors.  In
        ``centered`` mode the touched-column set expands to every item the
        touched users rate (their mean moved).  Assignment repair is exact
        (shared certificate); untouched users' profiles take the
        ``Σ w·Δproxy`` correction over the touched columns, touched users
        are re-folded in full.  ``version``: the caller's ratings version —
        the gather source and the scorer tables are patched along an
        unbroken chain instead of rebuilt.
        """
        if not self.fitted:
            raise RuntimeError("call fit() first")
        t_users = np.unique(np.atleast_1d(
            np.asarray(touched_users, np.int32)))
        t_items = np.unique(np.atleast_1d(
            np.asarray(touched_items, np.int32)))
        n_patched = self._patch_row_caches(ratings, t_users, version,
                                           means=means)
        dev = ratings.device
        tu = torch.as_tensor(t_users, device=dev).long()
        if self.cfg.features == "centered" and t_users.size:
            rated = (ratings[tu] > 0).any(dim=0).cpu().numpy()
            t_items = np.unique(np.concatenate(
                [t_items, np.nonzero(rated)[0]])).astype(np.int32)
        if t_items.size == 0:
            self.last_refold = RefoldStats(0, 0, 0, 0, self.n_items)
            return self.last_refold

        with obs.span("item_index.refold",
                      n_touched=int(t_items.size)) as sp:
            ti = torch.as_tensor(t_items, device=dev).long()
            p_old = self.proxies[ti]
            p_new = self._proxy_rows(ratings[:, ti], means)
            changed, full_rows, reassigned = self._refold_rows(t_items,
                                                               p_new)

            # profile maintenance against the moved proxies
            # (the fallback flags are per user over all items: the stored
            # ones, not the column slice's)
            cols = ratings[:, ti]                              # (U, T)
            mask = cols > 0
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            pos = torch.where(mask, (cols - means[:, None]).clamp_min(0.0),
                              zero)
            w_cols = torch.where(self._has_pos[:, None], pos, mask.float())
            if t_users.size:
                w_cols[tu] = 0.0
            profiles = self.profiles + w_cols @ (p_new - p_old)
            if t_users.size:
                w_t, hp_t = _affinity_weights(ratings[tu], means[tu])
                profiles[tu] = _fold_profiles(w_t, self.proxies)
                has_pos = self._has_pos.clone()
                has_pos[tu] = hp_t
                self._has_pos = has_pos
            self.profiles = profiles

            stats = RefoldStats(
                n_touched=int(t_items.size),
                n_changed_clusters=len(changed),
                n_reassigned=reassigned, n_full_rows=len(full_rows),
                n_certified=self.n_items - len(full_rows),
                caches_patched=n_patched)

            # periodic profile re-fold: zero the accumulated Σ w·Δproxy
            # float error with one cold fold
            self._touched_since_profile += int(t_items.size)
            thr = self.cfg.profile_refold_frac
            if thr and self._touched_since_profile >= thr * self.n_items:
                w_all, hp_all = _affinity_weights(ratings, means)
                self.profiles = _fold_profiles(w_all, self.proxies)
                self._has_pos = hp_all
                self._touched_since_profile = 0
                stats.profile_refold = True

            self._maybe_refit(ratings, means, stats)
            if stats.refit:
                self._touched_since_profile = 0   # fit re-folded profiles
        self.last_refold = stats
        reg = obs.registry()
        reg.counter("item_index.refold.count").inc()
        reg.histogram("item_index.refold.seconds").observe(sp.duration)
        reg.gauge("item_index.refold.reassign_frac").set(
            stats.reassigned_frac)
        reg.gauge("item_index.refold.caches_patched").set(
            stats.caches_patched)
        if stats.refit:
            reg.counter("item_index.refit.count").inc()
        if version is not None:
            reg.gauge("item_index.ratings_version").set(version)
        return stats

    # -- diagnostics -------------------------------------------------------
    def check_consistent(self, ratings: torch.Tensor,
                         means: torch.Tensor) -> bool:
        """Assert proxies / spill / mass equal a cold rebuild (bit for
        bit, the shared refold invariants) and the user profiles a cold
        fold of the current affinity weights (rtol 1e-4, atol 1e-3: the
        Δproxy corrections accumulate float error); raises on mismatch."""
        errs = self._check_spill_state(self._proxy_rows(ratings, means))
        w, has_pos = _affinity_weights(ratings, means)
        if not torch.equal(has_pos, self._has_pos):
            errs.append("affinity flags")
        cold = _fold_profiles(w, self.proxies)
        if not torch.allclose(cold, self.profiles, rtol=1e-4, atol=1e-3):
            errs.append("profiles")
        if errs:
            raise RuntimeError("item index diverged from a cold rebuild: "
                               f"{', '.join(errs)}")
        return True

    # -- persistence -------------------------------------------------------
    _STATE_KEYS = _SpillClusterCore._STATE_KEYS + ("has_pos", "item_meta",
                                                   "profiles")

    def _extra_state(self) -> dict:
        return {
            "has_pos": self._has_pos.cpu().numpy(),
            "item_meta": np.asarray([self.n_users,
                                     self._touched_since_profile], np.int64),
            "profiles": self.profiles.cpu().numpy(),
        }

    def _load_extra_state(self, tree: dict) -> None:
        meta = np.asarray(tree["item_meta"]).reshape(-1)
        self.n_users = int(meta[0])
        # older reference checkpoints carry only n_users: counter at 0
        self._touched_since_profile = int(meta[1]) if meta.size > 1 else 0
        self.profiles = torch.as_tensor(
            np.array(tree["profiles"], np.float32), device=self.device)
        self._has_pos = torch.as_tensor(
            np.asarray(tree["has_pos"]).astype(bool), device=self.device)
        # the scorer tables are derived data, rebuilt lazily per ratings
        self._support_cache = None
        self._support_dense_cache = None
