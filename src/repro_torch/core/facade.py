"""CF engine facade (port of ``repro.core.facade``): exact and
approximate-neighbor modes.

``CFEngine`` owns the rating matrix and the fitted neighbor state — cached
``(U, k)`` scores/ids, per-user rating statistics, and means — and fits
with one of four backends:

* ``sequential`` — ``topk_neighbors`` over ``torch.matmul`` Gram terms
  (the paper's baseline);
* ``kernel``     — the streaming top-k of the reference's ``pallas``
  backend, each candidate block scored by the hand-written CUDA
  similarity kernel — on its int8 tensor-core route when the matrix
  round-trips through int8 inside the route's exact domain
  (:func:`repro_torch.core.engine.kernel_topk`, which ``sharded_topk``
  and ``UserCF`` call too), on its f32 route otherwise;
  ``recommend`` and the serving batch predictor predict each user block
  through the CUDA tile-predict kernel, one launch over every item;
* ``sharded``    — query users sharded over a mesh axis
  (:func:`repro_torch.core.engine.sharded_topk` on ``torch.distributed``);
* ``ring``       — candidate shards rotating around the axis
  (:func:`repro_torch.core.engine.ring_sharded_topk`).

The two mesh backends take ``mesh`` (a ``DeviceMesh``) and ``axis``; with
no mesh they use :func:`repro_torch.core.engine.default_mesh`, a one-axis
mesh over the default process group (a one-rank NCCL group on the card,
gloo on the CPU, when none is initialised).  On the card their rank
blocks go through the CUDA similarity kernel and they predict through the
tile-predict kernel, as the ``kernel`` backend does.  The mesh and axis
also reach both indexes, whose k-means fits then shard over it.

All are exact on integer ratings: the Gram sums are exact integers, the
kernels keep the plain version's operation order and the top-k merge is
canonical, so every backend gives identical neighbor ids and scores.

Incremental maintenance (``update_ratings``) follows the reference step
for step: refold the touched rows' statistics, one (U, |S|) Gram pass
against the touched set S, repair rows whose cached top-k provably
survives (the ``_repair_rows`` certificate), and recompute the rest with
``block_topk`` over explicit query ids.  The result is bit-identical to a
cold ``fit`` (``oracle_check=True`` asserts it).  Like the reference's
``pallas`` backend, the ``kernel`` backend refits in full on update.

``neighbor_mode="approx"`` swaps the all-pairs fit for the clustered
candidate-generation index (:mod:`repro_torch.index`): probe the nearest
user clusters, shortlist by projected proxy scores, exactly rerank the
shortlist — with true similarity scores in the cache and the CUDA
centroid-distance, scan/select and rerank kernels on the path (their
plain versions with ``IndexConfig(use_kernel=False)``).  An update refolds
the index first, then repairs the cache with the same certificate and
re-queries the index for touched and uncertified rows; ``oracle_check``
asserts the index invariant and exact means.  ``recall_vs_exact`` holds
the cache against the exact engine.

``recommend_mode="approx"`` fits the item index
(:class:`repro_torch.index.ItemClusteredIndex`) beside the neighbor cache
and recommends in two stages: the CUDA support kernel scores every item
with the exact predictor's num/den form, the CUDA select kernel keeps the
canonical top ``shortlist`` unseen items, and those are reranked with the
exact prediction — so with the kernel scorer the result equals the exact
recommend bit for bit.  An update refolds the item index too, and
``oracle_check`` asserts its invariant; ``recommend_recall_vs_exact``
holds approx against exact recommendations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import engine as dist_engine
from repro_torch.core import neighbors as nb
from repro_torch.core import predict as pred_mod
from repro_torch.core import similarity as sim
from repro_torch.device import resolve_device
from repro_torch.kernels import similarity as ksim  # noqa: F401
from repro_torch.state import from_reference_state

BACKENDS = ("sequential", "sharded", "ring", "kernel")
NEIGHBOR_MODES = ("exact", "approx")
RECOMMEND_MODES = ("exact", "approx")

# the reference's Pallas backend is the port's CUDA kernel backend
_NOT_PORTED = {
    "pallas": "the 'kernel' backend (the CUDA port of the Pallas kernel)",
}

# exact-recommend streaming: users per block and items per predict tile.
# The tile bounds the plain route (the CPU, or the sequential backend),
# which gathers an (m, k, item_block) intermediate, never O(m·k·I); the
# kernel route on the card launches once a user block over every item,
# since the kernel gathers inside itself and materialises no tile
USER_BLOCK = 1024
ITEM_BLOCK = 512


def _bucket(n: int, cap: int) -> int:
    """Next power of two ≥ n (≥ 8), capped — bounds distinct shapes."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class UpdateStats:
    """What one ``update_ratings`` call did."""
    n_deltas: int           # rating cells written
    n_touched: int          # distinct users whose rows changed
    n_affected: int         # rows fully recomputed (touched ∪ stale top-k)
    n_merged: int           # rows fixed by the cheap cached-merge path
    seconds: float
    oracle_ok: Optional[bool] = None    # set when oracle_check=True


def _cross_scores(ratings, cand_ids, *, measure, beta=None):
    """Similarity of every user against the (padded) touched set.

    ``cand_ids``: (S,) global ids padded with ids ≥ U.  Self-pairs and
    padding columns score NEG_INF; the padding id is *high* so it also
    loses every NEG_INF tie against the cache's -1 padding under
    merge_topk's lower-id-wins rule.
    """
    n_users = ratings.shape[0]
    cand = ratings[cand_ids.clamp(0, n_users - 1)]
    s = sim.pairwise_similarity(ratings, cand, measure=measure, beta=beta)
    rows = torch.arange(n_users, device=ratings.device)
    invalid = (cand_ids[None, :] < 0) | (cand_ids[None, :] >= n_users) | \
              (cand_ids[None, :] == rows[:, None])
    s = s.masked_fill(invalid, nb.NEG_INF)
    return s, cand_ids.to(torch.int32)[None, :].expand(n_users, -1)


def _repair_rows(scores, idx, cross_s, cross_i, touch_ids, *, k):
    """Drop stale entries, merge fresh (row, S) scores, and certify rows.

    A repaired row is *certified exact* when every merged entry scores
    strictly above the row's old k-th score, or ties it with a neighbor id
    ≤ the old k-th entry's id: the cache was the exact canonical top-k, so
    no unseen candidate can displace it.  Uncertified rows are recomputed.
    """
    stale = (idx[..., None] == touch_ids.to(idx.dtype)[None, None, :]).any(-1)
    cut = scores[:, k - 1]
    last_id = idx[:, k - 1]
    s_m = scores.masked_fill(stale, nb.NEG_INF)
    i_m = idx.masked_fill(stale, -1)
    ms, mi = nb.merge_topk(s_m, i_m, cross_s, cross_i, k)
    ok = (ms > cut[:, None]) | \
         ((ms == cut[:, None]) & (mi <= last_id[:, None]))
    return ms, mi, ok.all(dim=1)


def _rows_topk(ratings, q_ids, *, k, measure, block_size, beta=None):
    """Full recompute for a gathered (padded) set of query rows."""
    n_users = ratings.shape[0]
    q = ratings[q_ids.clamp(0, n_users - 1)]
    return nb.block_topk(q, ratings, k, measure=measure, q_ids=q_ids,
                         block_size=min(block_size, n_users), beta=beta)


def _refold_stats(ratings, cnt, tot, ids):
    """Recompute count/total for the touched rows only (ids padded with
    U, which are dropped); returns fresh tensors (copy-on-write)."""
    ids = ids[ids < ratings.shape[0]]
    rows = ratings[ids]
    cnt = cnt.clone()
    tot = tot.clone()
    cnt[ids] = (rows > 0).sum(-1, dtype=torch.int32)
    tot[ids] = rows.sum(-1)
    return cnt, tot, sim.means_from_stats(cnt, tot)


def _scatter_rows(scores, idx, rows, new_s, new_i):
    """Write recomputed rows (padding rows ≥ U are dropped)."""
    keep = rows < scores.shape[0]
    scores = scores.clone()
    idx = idx.clone()
    scores[rows[keep]] = new_s[keep]
    idx[rows[keep]] = new_i[keep]
    return scores, idx


class CFEngine:
    """Facade over the exact CF engines with incremental rating updates.

    Parameters
    ----------
    ratings : (U, I) dense rating matrix (numpy or tensor), 0 = unrated.
    backend : ``"sequential"``, ``"sharded"``, ``"ring"`` or ``"kernel"``
        (see the module docstring).
    mesh : the ``DeviceMesh`` the mesh backends and the indexes' k-means
        fits shard over (default: :func:`repro_torch.core.engine.
        default_mesh` for ``sharded`` / ``ring``, none otherwise).
    axis : the mesh axis they shard over.
    neighbor_mode : ``"exact"`` (default) or ``"approx"`` — fit a
        :class:`repro_torch.index.ClusteredIndex` and fill the neighbor
        cache through its two-stage query.  With ``index_cfg`` at
        ``n_probe = n_clusters`` and ``rerank_frac = 0`` the approx cache
        is bit-identical to the exact one.
    index_cfg : optional :class:`repro_torch.index.IndexConfig`; default
        auto (mean-centered features for pcc / pcc_sig, raw rows for
        cosine / jaccard).
    recommend_mode : ``"exact"`` (default) or ``"approx"`` — fit a
        :class:`repro_torch.index.ItemClusteredIndex` and recommend through
        its two-stage path by default (``recommend(mode=...)`` overrides
        per call).
    item_index_cfg : optional :class:`repro_torch.index.ItemIndexConfig`
        (default: the reference's defaults).
    device : ``"cuda"`` (default) or ``"cpu"``; a missing card raises.
    pcc_sig_beta : the ``pcc_sig`` shrink horizon (None → 50).
    """

    # Deliberately lock-free single-writer design, audited by the runtime
    # race harness (repro.analysis.races): one writer thread mutates the
    # model, concurrent readers (the serving batcher) take the whole model
    # through snapshot() — a single reference read of an immutable tuple
    # published atomically under the GIL.  Every published tensor is
    # replaced, never written in place (copy-on-write), so a reader's
    # tuple stays valid.
    _reprolint_race_ok = {
        "_snapshot": "atomic reference publish of an immutable tuple; "
                     "readers dereference once and never see a mix",
        "ratings": "written by the single update thread; readers use the "
                   "snapshot tuple, never this attribute mid-update",
        "scores": "same single-writer/snapshot contract as ratings",
        "idx": "same single-writer/snapshot contract as ratings",
        "means": "same single-writer/snapshot contract as ratings",
        "_cnt": "internal sufficient statistic, only the update thread "
                "reads or writes it",
        "_tot": "internal sufficient statistic, only the update thread "
                "reads or writes it",
        "ratings_version": "monotone int bumped by the single writer; "
                           "readers only compare for staleness",
        "last_update": "diagnostic record, atomically rebound",
        "fit_seconds": "diagnostic scalar, atomically rebound",
    }

    def __init__(self, ratings, *, measure: str = "pcc", k: int = 40,
                 backend: str = "kernel", mesh=None, axis: str = "data",
                 block_size: int = 1024, neighbor_mode: str = "exact",
                 index_cfg=None,
                 recommend_mode: str = "exact", item_index_cfg=None,
                 pcc_sig_beta: Optional[float] = None, device="cuda"):
        if measure not in sim.SIMILARITY_MEASURES:
            raise ValueError(f"unknown measure {measure!r}; want one of "
                             f"{sim.SIMILARITY_MEASURES}")
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {backend!r} has no port of its own: use "
                f"{_NOT_PORTED[backend]}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; want one of "
                             f"{BACKENDS}")
        for opt, val in (("neighbor_mode", neighbor_mode),
                         ("recommend_mode", recommend_mode)):
            if val not in NEIGHBOR_MODES:
                raise ValueError(f"unknown {opt} {val!r}; want one of "
                                 f"{NEIGHBOR_MODES}")
        self.device = resolve_device(device)
        self.ratings = torch.as_tensor(
            ratings if isinstance(ratings, torch.Tensor)
            else np.asarray(ratings, np.float32)
        ).to(device=self.device, dtype=torch.float32)
        self.measure = measure
        self.k = int(k)
        self.backend = backend
        self.axis = axis
        if backend in ("sharded", "ring") and mesh is None:
            mesh = dist_engine.default_mesh(self.device, axis)
        self.mesh = mesh
        self.block_size = int(block_size)
        self.neighbor_mode = neighbor_mode
        self.recommend_mode = recommend_mode
        self.pcc_sig_beta = sim.resolve_beta(pcc_sig_beta)
        self.index = None
        if neighbor_mode == "approx":
            from repro_torch.index import ClusteredIndex, IndexConfig
            if index_cfg is None:
                index_cfg = IndexConfig(
                    features="centered" if measure in ("pcc", "pcc_sig")
                    else "raw")
            self.index = ClusteredIndex(index_cfg, mesh=self.mesh,
                                        mesh_axis=self.axis)
        self.item_index = None
        if recommend_mode == "approx":
            from repro_torch.index import ItemClusteredIndex, ItemIndexConfig
            self.item_index = ItemClusteredIndex(
                item_index_cfg if item_index_cfg is not None
                else ItemIndexConfig(), mesh=self.mesh, mesh_axis=self.axis)

        self.scores: Optional[torch.Tensor] = None   # (U, k) f32
        self.idx: Optional[torch.Tensor] = None      # (U, k) int32
        self.means: Optional[torch.Tensor] = None    # (U,) f32
        self._cnt = None                             # (U,) int32 counts
        self._tot = None                             # (U,) f32 rating sums
        self._snapshot: Optional[tuple] = None       # atomically published
        self._gather_cache = pred_mod.GatherCache()  # the gather operand
        self.ratings_version = 0
        self.fit_seconds = 0.0
        self.last_update: Optional[UpdateStats] = None
        # chaos hook: a FaultInjector armed here fires inside
        # update_ratings after the ratings swap but before any derived
        # state is repaired — the torn-engine drill; None in production
        self.fault_injector = None
        self._update_seq = 0

    # -- properties --------------------------------------------------------
    @property
    def n_users(self) -> int:
        return self.ratings.shape[0]

    @property
    def n_items(self) -> int:
        return self.ratings.shape[1]

    @property
    def fitted(self) -> bool:
        return self.scores is not None

    @property
    def use_kernel(self) -> bool:
        """Whether prediction tiles go through the CUDA tile kernel: every
        backend but the plain ``sequential`` one."""
        return self.backend != "sequential"

    def _publish(self) -> None:
        """Fence the device work, then publish the model in one reference
        swap: a concurrent reader sees the whole old model or the whole
        new one, never a mix."""
        with obs.span("fit.publish"):
            if self.scores.is_cuda:
                torch.cuda.synchronize(self.scores.device)
            self._snapshot = (self.ratings, self.scores, self.idx,
                              self.means)

    # -- fit ---------------------------------------------------------------
    def fit(self) -> "CFEngine":
        """Compute and cache the exact top-k neighbors."""
        with obs.span("engine.fit", backend=self.backend,
                      neighbor_mode=self.neighbor_mode,
                      n_users=self.n_users, n_items=self.n_items) as sp:
            with obs.span("fit.user_stats"):
                self._cnt, self._tot, self.means = sim.user_stats(
                    self.ratings)
            if self.neighbor_mode == "approx":
                self.index.fit(self.ratings, self.means)
                self.scores, self.idx = self.index.query(
                    self.ratings, self.means, k=self.k,
                    measure=self.measure, beta=self.pcc_sig_beta)
            else:
                with obs.span("fit.topk", backend=self.backend):
                    self.scores, self.idx = self._topk(self.ratings)
            if self.item_index is not None:
                self.item_index.fit(self.ratings, self.means)
            self._publish()
        self.fit_seconds = sp.duration
        reg = obs.registry()
        reg.histogram("engine.fit.seconds").observe(self.fit_seconds)
        reg.gauge("engine.ratings_version").set(self.ratings_version)
        return self

    def _topk(self, ratings) -> Tuple[torch.Tensor, torch.Tensor]:
        bs = min(self.block_size, ratings.shape[0])
        if self.backend == "sequential":
            return nb.topk_neighbors(ratings, self.k, measure=self.measure,
                                     block_size=bs, beta=self.pcc_sig_beta)
        if self.backend == "sharded":
            return dist_engine.sharded_topk(
                ratings, self.k, self.mesh, measure=self.measure,
                axis=self.axis, block_size=bs, beta=self.pcc_sig_beta)
        if self.backend == "ring":
            return dist_engine.ring_sharded_topk(
                ratings, self.k, self.mesh, measure=self.measure,
                axis=self.axis, block_size=bs, beta=self.pcc_sig_beta)
        # the reference's _pallas_topk, on the engine's cached operand
        return dist_engine.kernel_topk(
            ratings, self.k, measure=self.measure, block_size=bs,
            beta=self.pcc_sig_beta, operand=self._gather_cache.get(ratings))

    def _obs_update(self, stats: UpdateStats) -> UpdateStats:
        """Publish one ``update_ratings`` outcome to the registry."""
        sp = obs.current_span()
        if sp is not None:
            sp.set_attr("n_deltas", stats.n_deltas)
            sp.set_attr("n_affected", stats.n_affected)
        reg = obs.registry()
        reg.counter("engine.update.count").inc()
        reg.counter("engine.update.deltas").inc(stats.n_deltas)
        reg.histogram("engine.update.seconds").observe(stats.seconds)
        reg.gauge("engine.ratings_version").set(self.ratings_version)
        self.last_update = stats
        return stats

    # -- incremental update ------------------------------------------------
    @obs.traced("engine.update")
    def update_ratings(self, user_ids, item_ids, values, *,
                       oracle_check: bool = False) -> UpdateStats:
        """Absorb a rating delta; the cached neighbors stay exact.

        ``values`` of 0 delete ratings; duplicate (user, item) cells in one
        batch resolve last-wins.  With ``oracle_check`` the refreshed cache
        is verified bit for bit against a cold recompute (``RuntimeError``
        on any mismatch).  In approx mode the index is refolded first and
        touched / uncertified rows re-query it; ``oracle_check`` then
        asserts the index invariant and exact means instead.
        """
        if not self.fitted:
            raise RuntimeError("call fit() before update_ratings()")
        t0 = time.perf_counter()
        user_ids = np.atleast_1d(np.asarray(user_ids, np.int32))
        item_ids = np.atleast_1d(np.asarray(item_ids, np.int32))
        values = np.atleast_1d(np.asarray(values, np.float32))
        if not (user_ids.shape == item_ids.shape == values.shape):
            raise ValueError("user_ids, item_ids, values must align")
        if user_ids.size == 0:
            return UpdateStats(0, 0, 0, 0, 0.0)
        if (user_ids < 0).any() or (user_ids >= self.n_users).any():
            raise ValueError("user id out of range")
        if (item_ids < 0).any() or (item_ids >= self.n_items).any():
            raise ValueError("item id out of range")

        # stream semantics: the last write to a (user, item) cell wins —
        # dedupe on the host so the scatter writes each cell once
        cell = user_ids.astype(np.int64) * self.n_items + item_ids
        _, last_rev = np.unique(cell[::-1], return_index=True)
        keep = np.sort(cell.size - 1 - last_rev)
        user_ids, item_ids, values = (user_ids[keep], item_ids[keep],
                                      values[keep])

        dev = self.device
        touched = np.unique(user_ids)
        prev_ratings = self.ratings
        ratings = prev_ratings.clone()           # copy-on-write
        ratings[torch.as_tensor(user_ids, device=dev).long(),
                torch.as_tensor(item_ids, device=dev).long()] = \
            torch.as_tensor(values, device=dev)
        self.ratings = ratings
        self.ratings_version += 1
        self._update_seq += 1
        if self.fault_injector is not None:
            # chaos hook: the ratings are swapped and the version bumped,
            # but stats, caches and the snapshot are stale — the torn
            # state a restore must repair.  The failure is counted before
            # the raise; readers keep the previous snapshot, which is
            # republished only at the end of a successful update
            try:
                self.fault_injector.check(self._update_seq)
            except Exception:
                obs.registry().counter("engine.update.failures").inc()
                raise

        # 1. refold the touched rows' sufficient statistics
        s_pad = _bucket(len(touched), self.n_users)
        pad_touch = np.full((s_pad,), self.n_users, np.int64)  # dropped
        pad_touch[:len(touched)] = touched
        pad_touch_t = torch.as_tensor(pad_touch, device=dev)
        self._cnt, self._tot, self.means = _refold_stats(
            self.ratings, self._cnt, self._tot, pad_touch_t)
        # delta-patch the gather operand (copy-on-write)
        self._gather_cache.advance(prev_ratings, self.ratings, pad_touch_t)
        if self.neighbor_mode == "approx":
            self.index.refold(self.ratings, self.means, touched,
                              version=self.ratings_version)
        if self.item_index is not None:
            self.item_index.refold(self.ratings, self.means, touched,
                                   np.unique(item_ids),
                                   version=self.ratings_version)

        if self.backend == "kernel" and self.neighbor_mode == "exact":
            # as the reference's pallas backend: exactness means a full
            # refit, the operation the kernel exists to make cheap
            self.scores, self.idx = self._topk(self.ratings)
            self._publish()
            stats = UpdateStats(
                n_deltas=int(user_ids.size), n_touched=int(len(touched)),
                n_affected=self.n_users, n_merged=0,
                seconds=time.perf_counter() - t0)
            if oracle_check:
                stats.oracle_ok = self._check_oracle()
            return self._obs_update(stats)

        # 2. one (U, |S|) Gram pass for the changed pairwise terms
        cross_s, cross_i = _cross_scores(self.ratings, pad_touch_t,
                                         measure=self.measure,
                                         beta=self.pcc_sig_beta)
        # 3. cheap path: drop stale entries, merge, certify
        merged_s, merged_i, safe = _repair_rows(
            self.scores, self.idx, cross_s, cross_i, pad_touch_t, k=self.k)
        # 4. recompute touched and uncertified rows: exact top-k in exact
        #    mode, a fresh index query (fit's candidate policy) in approx
        need = ~safe.cpu().numpy()
        need[touched] = True
        affected = np.nonzero(need)[0]
        n_merged = self.n_users - len(affected)
        if len(affected):
            a_pad = _bucket(len(affected), self.n_users)
            rows = np.full((a_pad,), self.n_users, np.int64)
            rows[:len(affected)] = affected
            rows_t = torch.as_tensor(rows, device=dev)
            if self.neighbor_mode == "approx":
                q_s, q_i = self.index.query(self.ratings, self.means,
                                            affected, k=self.k,
                                            measure=self.measure,
                                            beta=self.pcc_sig_beta)
                new_s = torch.full((a_pad, self.k), nb.NEG_INF,
                                   dtype=torch.float32, device=dev)
                new_i = torch.full((a_pad, self.k), -1, dtype=torch.int32,
                                   device=dev)
                new_s[:len(affected)] = q_s
                new_i[:len(affected)] = q_i
            else:
                new_s, new_i = _rows_topk(self.ratings, rows_t, k=self.k,
                                          measure=self.measure,
                                          block_size=self.block_size,
                                          beta=self.pcc_sig_beta)
            merged_s, merged_i = _scatter_rows(merged_s, merged_i, rows_t,
                                               new_s, new_i)
        self.scores = merged_s
        self.idx = merged_i
        self._publish()
        stats = UpdateStats(
            n_deltas=int(user_ids.size), n_touched=int(len(touched)),
            n_affected=int(len(affected)), n_merged=int(n_merged),
            seconds=time.perf_counter() - t0)
        if oracle_check:
            stats.oracle_ok = self._check_oracle()
        return self._obs_update(stats)

    def _check_oracle(self) -> bool:
        """Exact mode: assert cache == cold full recompute, bit for bit.
        Approx mode: the cache is defined by the index's candidate policy,
        so assert the index invariant (assignments and proxies equal a
        cold reassignment) plus exact means.  A fitted item index is
        consistency-checked in either mode."""
        if self.item_index is not None:
            self.item_index.check_consistent(self.ratings, self.means)
        if self.neighbor_mode == "approx":
            ok = self.index.check_consistent(self.ratings, self.means)
            _, _, ref_m = sim.user_stats(self.ratings)
            if not torch.equal(ref_m, self.means):
                raise RuntimeError("incremental means diverged from a "
                                   "full recompute")
            return ok
        ref_s, ref_i = self._topk(self.ratings)
        _, _, ref_m = sim.user_stats(self.ratings)
        errs = [name for name, a, b in (("scores", ref_s, self.scores),
                                        ("neighbor ids", ref_i, self.idx),
                                        ("means", ref_m, self.means))
                if not torch.equal(a, b)]
        if errs:
            raise RuntimeError(f"incremental update diverged from full "
                               f"recompute: {', '.join(errs)}")
        return True

    # -- diagnostics -------------------------------------------------------
    def recall_vs_exact(self, sample: int = 1024, seed: int = 0) -> float:
        """Mean recall@k of the cached neighbors against the exact engine:
        ``sample`` users (seeded, without replacement), their exact top-k
        rows recomputed, the mean fraction of exact neighbor ids present in
        the cache.  1.0 in exact mode by construction."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        rng = np.random.default_rng(seed)
        n = min(sample, self.n_users)
        users = np.sort(rng.choice(self.n_users, n, replace=False))
        u_pad = _bucket(len(users), self.n_users)
        rows = np.full((u_pad,), -1, np.int64)
        rows[:len(users)] = users
        _, ref_i = _rows_topk(self.ratings,
                              torch.as_tensor(rows, device=self.device),
                              k=self.k, measure=self.measure,
                              block_size=self.block_size,
                              beta=self.pcc_sig_beta)
        ref_i = ref_i.cpu().numpy()[:len(users)]
        got_i = self.idx.cpu().numpy()[users]
        hits = 0
        total = 0
        for row in range(len(users)):
            exact = set(int(j) for j in ref_i[row] if j >= 0)
            if not exact:
                continue
            hits += len(exact & set(int(j) for j in got_i[row]))
            total += len(exact)
        return hits / max(total, 1)

    # -- inference ---------------------------------------------------------
    def snapshot(self) -> tuple:
        """Consistent (ratings, scores, idx, means) view for readers."""
        if self._snapshot is None:
            raise RuntimeError("call fit() first")
        return self._snapshot

    def neighbors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.fitted:
            raise RuntimeError("call fit() first")
        return self.scores, self.idx

    # -- persistence -------------------------------------------------------
    def state(self) -> dict:
        """Engine state as host (numpy) arrays, in the reference's tree
        layout (``index`` / ``item_index`` hold the clustered indexes'
        states when they are fitted, else they are empty)."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        return {
            "ratings": self.ratings.cpu().numpy().copy(),
            "scores": self.scores.cpu().numpy().copy(),
            "idx": self.idx.cpu().numpy().copy(),
            "means": self.means.cpu().numpy().copy(),
            "cnt": self._cnt.cpu().numpy().copy(),
            "tot": self._tot.cpu().numpy().copy(),
            "meta": np.asarray([self.ratings_version], np.int64),
            "index": ({key: np.array(val) for key, val in
                       self.index.state().items()}
                      if self.index is not None else {}),
            "item_index": ({key: np.array(val) for key, val in
                            self.item_index.state().items()}
                           if self.item_index is not None else {}),
        }

    def state_template(self) -> dict:
        """Structure-only tree mirroring :meth:`state`."""
        out = {k: 0 for k in ("ratings", "scores", "idx", "means",
                              "cnt", "tot", "meta")}
        out["index"] = (type(self.index).state_template()
                        if self.index is not None else {})
        out["item_index"] = (type(self.item_index).state_template()
                             if self.item_index is not None else {})
        return out

    def load_state(self, tree: dict) -> "CFEngine":
        """Restore a :meth:`state` tree — the port's own, the reference
        ``CFEngine.state()`` numpy tree, or its
        :func:`repro_torch.state.from_reference_state` conversion.  The
        derived gather cache drops and the snapshot is republished in one
        reference swap."""
        if "version" not in tree:
            tree = from_reference_state(tree, self.device)
        self.ratings = tree["ratings"].to(self.device)
        self.idx = tree["idx"].to(self.device)
        self.means = tree["means"].to(self.device)
        self._cnt = tree["cnt"].to(self.device)
        self._tot = tree["tot"].to(self.device)
        self.ratings_version = int(tree["version"])
        self._gather_cache.clear()
        if self.index is not None and tree.get("index"):
            self.index.load_state(tree["index"], device=self.device)
        if self.item_index is not None and tree.get("item_index"):
            self.item_index.load_state(tree["item_index"],
                                       device=self.device)
        self.scores = tree["scores"].to(self.device)
        self._publish()
        obs.registry().gauge("engine.ratings_version").set(
            self.ratings_version)
        return self

    def _gather_source(self, ratings):
        """The gather operand's tensor, cached per ratings tensor."""
        return self._gather_cache.get(ratings).src

    def _user_ids(self, user_ids) -> np.ndarray:
        """Caller's user ids as int64, checked on the host: an
        out-of-range index on a CUDA tensor is a device-side assert that
        poisons the context, so it must never reach the device."""
        uids = np.atleast_1d(np.asarray(user_ids, np.int64))
        if uids.size and (uids.min() < 0 or uids.max() >= self.n_users):
            raise ValueError(f"user id out of range [0, {self.n_users})")
        return uids

    def predict(self, user_ids=None) -> torch.Tensor:
        """Predicted full item rows for ``user_ids`` (default: all users),
        streamed over item tiles from the published snapshot."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        ratings, scores, idx, means = self.snapshot()
        if user_ids is not None:
            u = torch.as_tensor(self._user_ids(user_ids), device=self.device)
            scores, idx, q_means = scores[u], idx[u], means[u]
        else:
            q_means = means
        return pred_mod.predict_from_neighbors_blocked(
            ratings, scores, idx, means=means, query_means=q_means,
            item_block=ITEM_BLOCK, gather_src=self._gather_source(ratings),
            use_kernel=self.use_kernel)

    def recommend(self, user_ids=None, n: int = 10, *,
                  mode: Optional[str] = None,
                  n_probe: Optional[int] = None,
                  shortlist: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-n unseen items ``(scores, item ids)`` for ``user_ids``
        (default: all users), on the engine's device.

        ``mode`` overrides the engine's ``recommend_mode`` per call
        (``"approx"`` needs a fitted item index); ``n_probe`` and
        ``shortlist`` are the approx path's per-call candidate budgets (the
        serving ladder's knobs) and raise on the exact path.  The exact
        path streams user blocks × item tiles (peak memory O(UB·k·IB)); the
        approx path runs the item index's two-stage pipeline and returns
        exact predicted ratings.  Slots a user cannot fill come back as
        item -1 with score -inf; rated items are never returned.  Both
        read the published snapshot (the item index's cluster state only
        shapes the candidate set, never the returned scores).
        """
        with obs.span("engine.recommend", n=n) as sp:
            if not self.fitted:
                raise RuntimeError("call fit() first")
            mode = mode or self.recommend_mode
            if mode not in RECOMMEND_MODES:
                raise ValueError(f"unknown recommend mode {mode!r}")
            sp.set_attr("mode", mode)
            ratings, scores, idx, means = self.snapshot()
            uids = (np.arange(self.n_users, dtype=np.int64)
                    if user_ids is None else self._user_ids(user_ids))
            if mode == "approx":
                return self._recommend_approx(ratings, scores, idx, means,
                                              uids, n=n, n_probe=n_probe,
                                              shortlist=shortlist)
            if n_probe is not None or shortlist is not None:
                raise ValueError(
                    "n_probe/shortlist are approx-mode candidate budgets; "
                    "the exact path scores every item and cannot honor "
                    "them")
            return self._recommend_exact(ratings, scores, idx, means, uids,
                                         n=n)

    def _recommend_exact(self, ratings, scores, idx, means, uids, *, n):
        """The exact path for ``uids``: one ``recommend_block`` a user
        block of at most ``USER_BLOCK``, each block's ids padded to the
        block size so every block has one shape.  Every block's padded
        ids go to the device in one copy before the loop (``obs`` counter
        ``recommend.ids.staged``), so no block copies from the host or
        reads a device value, and the host issues block b+1 while the
        device still runs block b."""
        src = self._gather_source(ratings)
        ub = min(USER_BLOCK, _bucket(len(uids), self.n_users))
        ids_pad = np.full((-(-len(uids) // ub) * ub,), self.n_users, np.int64)
        ids_pad[:len(uids)] = uids
        ids_all = torch.as_tensor(ids_pad, device=self.device)
        obs.counter("recommend.ids.staged").inc()
        out_s, out_i = [], []
        for lo in range(0, len(uids), ub):
            with obs.span("recommend.block", lo=lo):
                with obs.span("recommend.ids"):
                    ids_t = ids_all[lo:lo + ub]
                    safe = ids_t.clamp(0, self.n_users - 1)
                    q_scores, q_idx, q_means = (scores[safe], idx[safe],
                                                means[safe])
                s, i = pred_mod.recommend_block(
                    ratings, src, q_scores, q_idx, means, q_means, ids_t,
                    n=n, item_block=ITEM_BLOCK, use_kernel=self.use_kernel)
                real = min(ub, len(uids) - lo)
                out_s.append(s[:real])
                out_i.append(i[:real])
        if not out_s:
            return (torch.zeros((0, n), dtype=torch.float32,
                                device=self.device),
                    torch.full((0, n), -1, dtype=torch.int32,
                               device=self.device))
        return torch.cat(out_s), torch.cat(out_i)

    def _recommend_approx(self, ratings, scores, idx, means, uids, *, n,
                          n_probe, shortlist):
        """The item index's two-stage recommend for ``uids``.  Past 4096
        users with a fitted user index the queries run in taste-cluster
        order (users of one cluster share neighbors, so the support
        scorer re-reads the same table rows while they are cache-resident)
        and are scattered back to the caller's order."""
        if self.item_index is None or not self.item_index.fitted:
            raise RuntimeError(
                "recommend(mode='approx') needs a fitted item index — "
                "construct with recommend_mode='approx' and fit()")
        kw = dict(n=n, n_probe=n_probe, shortlist=shortlist)
        if self.index is not None and self.index.fitted and len(uids) > 4096:
            perm = np.argsort(self.index.assign[uids], kind="stable")
            s, i = self.item_index.recommend(ratings, means, scores, idx,
                                             uids[perm], **kw)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            inv_t = torch.as_tensor(inv, device=s.device)
            return s[inv_t], i[inv_t]
        return self.item_index.recommend(ratings, means, scores, idx, uids,
                                         **kw)

    def recommend_recall_vs_exact(self, sample: int = 256, n: int = 10,
                                  seed: int = 0) -> float:
        """Mean recall@n of approx recommendations against the exact
        blocked path on a seeded user sample (the recommend analogue of
        ``recall_vs_exact``).  1.0 whenever the shortlist holds the exact
        top-n — always with the kernel scorer and ``shortlist ≥ n``."""
        if not self.fitted:
            raise RuntimeError("call fit() first")
        rng = np.random.default_rng(seed)
        n_s = min(sample, self.n_users)
        users = np.sort(rng.choice(self.n_users, n_s, replace=False))
        ref_i = self.recommend(users, n, mode="exact")[1].cpu().numpy()
        got_i = self.recommend(users, n, mode="approx")[1].cpu().numpy()
        hits = 0
        total = 0
        for row in range(n_s):
            ref = set(int(j) for j in ref_i[row] if j >= 0)
            if not ref:
                continue
            hits += len(ref & set(int(j) for j in got_i[row]))
            total += len(ref)
        return hits / max(total, 1)
