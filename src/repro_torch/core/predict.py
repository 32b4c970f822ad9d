"""Rating prediction from selected neighbors (port of
``repro.core.predict``).

The mean-centred weighted-deviation predictor of the paper:

    p(u, i) = r̄_u + Σ_{v ∈ N(u), v rated i} s_uv · (r_vi − r̄_v)
              ───────────────────────────────────────────────────
                        Σ_{v ∈ N(u), v rated i} s_uv

falling back to r̄_u when no selected neighbor rated item i, clipped to
[1, 5].  Forms: one-shot (``predict_from_neighbors``), item-tiled
(``predict_from_neighbors_blocked``, optionally through the hand-written
tile kernel), an explicit candidate list (``predict_items``), and the
dense oracle (``predict_dense``).

The k-reduction of :func:`_tile_predict` is an explicit loop k = 0..k−1
that accumulates ``w[:, j] · dev_j`` — the order the CUDA tile kernel
uses, so the plain and kernel paths agree bit for bit, and any tiling of
the item axis reproduces the one-shot result bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.similarity import user_means

_DEN_EPS = 1e-8


# cells of one row block of the int8 exactness check: about 1 GiB of f32,
# so the check's temporaries never approach the matrix's own size
CHECK_BLOCK_CELLS = 1 << 28


def _int8_exact(ratings: torch.Tensor) -> bool:
    """True iff every rating is an integer in [0, 127], i.e. an int8 copy
    round-trips exactly (MovieLens-style 0..5 matrices qualify).  A meta
    matrix (a dry run's: no data) counts as such, the ratings the CF
    cells stand for.

    The check runs over row blocks of at most ``CHECK_BLOCK_CELLS`` cells
    (one row at the least), their verdicts and-ed into one device flag that
    is read once: no temporary of the matrix's size, one host wait.  Each
    block counts on ``obs`` counter ``gather_source.check.blocks``."""
    if ratings.device.type == "meta":
        return True
    rows = max(1, CHECK_BLOCK_CELLS // max(1, ratings.shape[-1]))
    ok, blocks = None, 0
    for lo in range(0, ratings.shape[0], rows):
        r = ratings[lo:lo + rows]
        block_ok = ((r >= 0) & (r <= 127) & (r == torch.round(r))).all()
        ok = block_ok if ok is None else ok & block_ok
        blocks += 1
    obs.counter("gather_source.check.blocks").inc(blocks)
    return ok is None or bool(ok)


def make_gather_source(ratings: torch.Tensor) -> torch.Tensor:
    """Rating matrix as a gather operand: an int8 copy when that
    round-trips exactly (the cast back to f32 is exact, so results are
    unchanged bit for bit at 4× less gather traffic), the matrix itself
    otherwise (half stars, say).  ``obs`` counters ``gather_source.int8``
    and ``gather_source.f32`` count the builds of each."""
    with obs.span("gather_source.build"):
        with obs.span("gather_source.check"):
            exact = _int8_exact(ratings)
        obs.counter("gather_source.int8" if exact
                    else "gather_source.f32").inc()
        return ratings.to(torch.int8) if exact else ratings


def patch_gather_source(src: torch.Tensor, ratings: torch.Tensor,
                        touched: torch.Tensor) -> torch.Tensor:
    """Refresh a cached :func:`make_gather_source` result for a row delta.

    ``src`` is the operand of the *pre-delta* matrix, ``ratings`` the
    post-delta matrix whose only changed rows are ``touched`` (padding ids
    ≥ U are dropped).  Copy-on-write: the touched rows are scattered into a
    fresh copy, so a concurrent reader holding the old operand stays valid.
    A delta that breaks int8 exactness falls back to a full rebuild.
    """
    if src.dtype != torch.int8:
        return ratings
    touched = touched.to(ratings.device).long()
    rows = touched[touched < ratings.shape[0]]
    vals = ratings[rows]
    if not _int8_exact(vals):
        return make_gather_source(ratings)
    out = src.clone()
    out[rows] = vals.to(torch.int8)
    return out


def _tile_predict(w, nbr, nb_means, query_means):
    """Per-tile predictor: (m, k) weights and neighbor means, (m, k, T)
    gathered neighbor ratings (f32), (m,) query means → (m, T).

    The k-reduction runs in order j = 0..k−1 with a separate multiply and
    add per step — the order of the CUDA tile kernel."""
    m, k, t = nbr.shape
    num = torch.zeros((m, t), dtype=torch.float32, device=nbr.device)
    den = torch.zeros((m, t), dtype=torch.float32, device=nbr.device)
    for j in range(k):
        r = nbr[:, j, :]
        mask = (r > 0).float()
        dev = (r - nb_means[:, j, None]) * mask
        wj = w[:, j, None]
        num = num + wj * dev
        den = den + wj * mask
    qm = query_means[:, None]
    pred = qm + num / den.clamp_min(_DEN_EPS)
    pred = torch.where(den > _DEN_EPS, pred, qm)
    return pred.clamp(1.0, 5.0)


def _neighbor_inputs(ratings, scores, idx, means, query_means):
    """Common setup: safe gather ids, masked weights, neighbor means."""
    if means is None:
        means = user_means(ratings)
    if query_means is None:
        if scores.shape[0] != ratings.shape[0]:
            raise ValueError("query_means is required when predicting for a "
                             "subset of users")
        query_means = means
    safe_idx = torch.where(idx >= 0, idx, torch.zeros_like(idx))
    w = torch.where((scores > 0.0) & (idx >= 0), scores,
                    torch.zeros_like(scores))
    return safe_idx, w, means[safe_idx.long()], query_means


def predict_from_neighbors(ratings: torch.Tensor, scores: torch.Tensor,
                           idx: torch.Tensor, *,
                           means: torch.Tensor | None = None,
                           query_means: torch.Tensor | None = None,
                           ) -> torch.Tensor:
    """One-shot gather form: (m, I) predictions for the m query users
    (materialises the (m, k, I) neighbor-rating intermediate)."""
    safe_idx, w, nb_means, query_means = _neighbor_inputs(
        ratings, scores, idx, means, query_means)
    return _tile_predict(w, ratings[safe_idx.long()], nb_means, query_means)


def predict_from_neighbors_blocked(ratings: torch.Tensor,
                                   scores: torch.Tensor, idx: torch.Tensor,
                                   *, means: torch.Tensor | None = None,
                                   query_means: torch.Tensor | None = None,
                                   item_block: int = 512,
                                   gather_src: torch.Tensor | None = None,
                                   use_kernel: bool = False) -> torch.Tensor:
    """Item-tiled form of :func:`predict_from_neighbors`: peak memory
    O(m·k·item_block), bit-identical to the one-shot form.

    With ``use_kernel`` the prediction goes through
    :func:`repro_torch.kernels.predict.fused_tile_predict`.  On CUDA
    tensors that is one launch over every item, written straight into the
    (m, I) output: the kernel gathers the neighbor rows itself and never
    materialises an (m, k, T) tile, so ``item_block`` bounds nothing there
    and is not read.  On CPU tensors ``use_kernel`` changes nothing: the
    items go ``item_block`` at a time through the gathered (m, k, T) tile,
    which is also the kernel's plain version.
    """
    safe_idx, w, nb_means, query_means = _neighbor_inputs(
        ratings, scores, idx, means, query_means)
    src = ratings if gather_src is None else gather_src
    n_items = ratings.shape[1]
    if use_kernel and src.device.type == "cuda":
        from repro_torch.kernels.predict import fused_tile_predict
        return fused_tile_predict(
            src, safe_idx.to(torch.int32).contiguous(), w.contiguous(),
            nb_means.contiguous(), query_means.contiguous(), 0, n_items)
    tiles = []
    for lo in range(0, n_items, item_block):
        nbr = src[:, lo:lo + item_block][safe_idx.long()].float()  # (m, k, T)
        tiles.append(_tile_predict(w, nbr, nb_means, query_means))
    return torch.cat(tiles, dim=1)


def predict_items(ratings: torch.Tensor, scores: torch.Tensor,
                  idx: torch.Tensor, item_ids: torch.Tensor, *,
                  means: torch.Tensor | None = None,
                  query_means: torch.Tensor | None = None,
                  item_block: int = 512,
                  gather_src: torch.Tensor | None = None) -> torch.Tensor:
    """Predict only the (m, M) candidate items ``item_ids`` per user.
    Out-of-range ids are gathered at a clipped position (the caller masks
    those slots); a full ascending candidate list is bit-identical to the
    blocked form."""
    safe_idx, w, nb_means, query_means = _neighbor_inputs(
        ratings, scores, idx, means, query_means)
    src = ratings if gather_src is None else gather_src
    n_items = ratings.shape[1]
    rows = safe_idx.long()[:, :, None]
    chunks = []
    for lo in range(0, item_ids.shape[1], item_block):
        ids = item_ids[:, lo:lo + item_block]
        safe_items = ids.long().clamp(0, n_items - 1)[:, None, :]
        nbr = src[rows, safe_items].float()                  # (m, k, T)
        chunks.append(_tile_predict(w, nbr, nb_means, query_means))
    return torch.cat(chunks, dim=1)


def predict_dense(ratings: torch.Tensor, weight_matrix: torch.Tensor, *,
                  means: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: the same predictor via a dense (U, U) weight-matrix matmul."""
    if means is None:
        means = user_means(ratings)
    mask = (ratings > 0).float()
    dev = (ratings - means[:, None]) * mask
    num = weight_matrix @ dev
    den = weight_matrix @ mask
    pred = means[:, None] + num / den.clamp_min(_DEN_EPS)
    pred = torch.where(den > _DEN_EPS, pred, means[:, None])
    return pred.clamp(1.0, 5.0)


def recommend_topn(pred: torch.Tensor, seen_mask: torch.Tensor, n: int):
    """Top-n unseen items per user: seen items score −inf; ties go to the
    lower item id (a stable descending sort keeps index order within a
    tie set)."""
    masked = pred.masked_fill(seen_mask, float("-inf"))
    vals, items = torch.sort(masked, dim=1, descending=True, stable=True)
    return vals[:, :n], items[:, :n].to(torch.int32)


def topn_unseen(pred: torch.Tensor, seen_mask: torch.Tensor, n: int, *,
                use_kernel: bool = True):
    """``recommend_topn`` with sanitised ids: slots a user cannot fill
    (fewer unseen items than ``n``) come back as item −1 with score −inf,
    so an already-rated item is never returned.

    With ``use_kernel`` the top n of the masked predictions come from
    kernel 5's canonical select
    (:func:`repro_torch.kernels.select.select_topm`: one launch on a CUDA
    tensor, which takes f32; its plain twin, a stable sort, on a CPU
    tensor) and count on ``obs`` counter ``recommend.topn.select``; a
    call whose rows are past the kernel's staging limit
    (``ROW_STAGE_MAX`` scores) counts on ``recommend.topn.unstaged``
    too.  Its
    order is the stable descending sort's: ties to the lower item id.  The
    kernel folds −0.0 into +0.0 and never ranks NaN, where the sort ranks
    NaN first; predictions are clamped to [1, 5], so neither arises from
    the predictors here.  Without ``use_kernel`` (the plain path on any
    device), or where ``min(n, items)`` lies outside the select's domain
    (below 1, or past ``SELECT_M_MAX``), the full stable sort of
    :func:`recommend_topn` stays, counted on ``recommend.topn.sort``."""
    from repro_torch.kernels.select import (ROW_STAGE_MAX, SELECT_M_MAX,
                                            select_topm)
    if use_kernel and 1 <= min(n, pred.shape[1]) <= SELECT_M_MAX:
        obs.counter("recommend.topn.select").inc()
        if pred.shape[1] > ROW_STAGE_MAX:
            obs.counter("recommend.topn.unstaged").inc()
        masked = pred.masked_fill(seen_mask, float("-inf"))
        no_knockout = torch.full((pred.shape[0],), -1, dtype=torch.int32,
                                 device=pred.device)
        scores, items = select_topm(masked, no_knockout, m=n)
    else:
        obs.counter("recommend.topn.sort").inc()
        scores, items = recommend_topn(pred, seen_mask, n)
    return scores, torch.where(scores == float("-inf"),
                               torch.full_like(items, -1), items)
