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
dense oracle (``predict_dense``); ``recommend_block``, the exact recommend
of a user block.  The gather operand is decided here alone (``GatherOperand``).

The k-reduction of :func:`_tile_predict` is an explicit loop k = 0..k−1
that accumulates ``w[:, j] · dev_j`` — the order the CUDA tile kernel
uses, so the plain and kernel paths agree bit for bit, and any tiling of
the item axis reproduces the one-shot result bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.similarity import user_means

_DEN_EPS = 1e-8


# cells of one row block of the int8 exactness check: about 1 GiB of f32,
# so the check's temporaries never approach the matrix's own size
CHECK_BLOCK_CELLS = 1 << 28


class GatherOperand(NamedTuple):
    """The rating matrix as a gather operand: ``src`` is an int8 copy when
    every rating is an integer in [0, 127] (exact, at 4× less gather
    traffic), else the f32 matrix itself (half stars, say).  ``max_value``
    is the copy's largest value, the bound of the int8 similarity and
    rerank routes' exact domain; None for the f32 matrix and a meta copy
    (a dry run's: no data to bound)."""
    src: torch.Tensor
    max_value: Optional[int]


def _fold_check(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device scalars ``(whole, top)``: whether every value of ``x`` is a
    non-negative integer, and the largest value (0 with no cells), folded
    over row blocks of at most ``CHECK_BLOCK_CELLS`` cells (one row at the
    least) so no temporary nears ``x``'s size; each block counts on
    ``obs`` counter ``gather_source.check.blocks``."""
    if not x.numel():
        return (torch.ones((), dtype=torch.bool, device=x.device),
                torch.zeros((), dtype=x.dtype, device=x.device))
    step = max(1, CHECK_BLOCK_CELLS // x.shape[-1])
    whole = top = None
    for lo in range(0, x.shape[0], step):
        r = x[lo:lo + step]
        low, high = torch.aminmax(r)
        ok = (low >= 0) & (r == torch.round(r)).all()
        whole = ok if whole is None else whole & ok
        top = high if top is None else torch.maximum(top, high)
    obs.counter("gather_source.check.blocks").inc(-(-x.shape[0] // step))
    return whole, top


def _read_bound(whole: torch.Tensor, top: torch.Tensor) -> Optional[int]:
    """``top`` as an int where ``whole`` holds and ``top`` ≤ 127, so that an
    int8 copy round-trips exactly, else None: one host read."""
    value = torch.where(whole, top, -1).item()
    return int(value) if 0 <= value <= 127 else None


def make_gather_operand(ratings: torch.Tensor) -> GatherOperand:
    """``ratings``' :class:`GatherOperand`: one row-blocked pass and one
    host read, then the int8 copy where exact.  A meta matrix counts as
    exact with no bound, the ratings the CF cells stand for.  ``obs`` span
    ``gather_source.check`` inside ``gather_source.build``; counters
    ``gather_source.int8`` / ``.f32`` count the builds of each."""
    with obs.span("gather_source.build"):
        with obs.span("gather_source.check"):
            meta = ratings.device.type == "meta"
            bound = None if meta else _read_bound(*_fold_check(ratings))
        exact = meta or bound is not None
        obs.counter("gather_source.int8" if exact
                    else "gather_source.f32").inc()
        if not exact:
            return GatherOperand(ratings, None)
        return GatherOperand(ratings.to(torch.int8), bound)


def patch_gather_operand(op: GatherOperand, ratings: torch.Tensor,
                         touched: torch.Tensor) -> GatherOperand:
    """Refresh ``op``, the *pre-delta* matrix's operand, for ``ratings``,
    whose only changed rows are ``touched`` (ids ≥ U pad, dropped).
    Copy-on-write: the touched rows go into a fresh copy, so a reader
    holding the old operand stays valid; its ``max_value`` is the copy's
    exact largest value, read with the rows' verdict in one host read.  A
    delta that breaks int8 exactness rebuilds; an f32 operand stays the
    matrix."""
    if op.src.dtype != torch.int8:
        return GatherOperand(ratings, None)
    touched = touched.to(ratings.device).long()
    rows = touched[touched < ratings.shape[0]]
    vals = ratings[rows]
    whole, top = _fold_check(vals)
    out = op.src.clone()
    out[rows] = vals.to(torch.int8)
    bound = _read_bound(whole, torch.maximum(top, out.amax()))
    if bound is None:
        return make_gather_operand(ratings)
    return GatherOperand(out, bound)


def make_gather_source(ratings: torch.Tensor) -> torch.Tensor:
    """:func:`make_gather_operand`'s tensor."""
    return make_gather_operand(ratings).src


def patch_gather_source(src: torch.Tensor, ratings: torch.Tensor,
                        touched: torch.Tensor) -> torch.Tensor:
    """:func:`patch_gather_operand` on a :func:`make_gather_source`."""
    return patch_gather_operand(GatherOperand(src, None), ratings,
                                touched).src


class GatherCache:
    """One ratings tensor's :class:`GatherOperand`, keyed by identity:
    ``entry``, an immutable ``(ratings, operand)`` tuple swapped in one
    write and read once, so readers stay valid while the writer advances
    it.  One per engine or index: a matrix written in place keeps its
    identity, so no cache may outlive the owner that sees it change."""

    def __init__(self):
        self.entry: Optional[Tuple[torch.Tensor, GatherOperand]] = None

    def get(self, ratings: torch.Tensor) -> GatherOperand:
        entry = self.entry
        if entry is not None and entry[0] is ratings:
            return entry[1]
        op = make_gather_operand(ratings)
        self.entry = (ratings, op)
        return op

    def advance(self, prev: torch.Tensor, ratings: torch.Tensor,
                touched: torch.Tensor) -> bool:
        """Patch ``prev``'s operand along a row delta to ``ratings``, or
        drop an operand of any other tensor; whether it patched."""
        entry = self.entry
        if entry is None or entry[0] is not prev:
            self.entry = None
            return False
        self.entry = (ratings, patch_gather_operand(entry[1], ratings,
                                                    touched))
        return True

    def clear(self) -> None:
        self.entry = None


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


def recommend_block(ratings, gather_src, scores, idx, means, q_means, q_ids,
                    *, n: int, item_block: int, use_kernel: bool):
    """The exact recommend of one (padded) user block: the (m, k) neighbor
    ``scores`` / ``idx`` and ``q_means`` of the users ``q_ids`` (ids ≥ U
    pad), item-tiled prediction over ``gather_src``, the seen mask, and
    :func:`topn_unseen`'s canonical top ``n`` with −1 for unfillable
    slots.  ``obs`` spans ``recommend.predict`` and ``recommend.topn``."""
    with obs.span("recommend.predict"):
        pred = predict_from_neighbors_blocked(
            ratings, scores, idx, means=means, query_means=q_means,
            item_block=item_block, gather_src=gather_src,
            use_kernel=use_kernel)
    with obs.span("recommend.topn"):
        safe = q_ids.clamp(0, ratings.shape[0] - 1)
        return topn_unseen(pred, ratings[safe] > 0, n,
                           use_kernel=use_kernel)
