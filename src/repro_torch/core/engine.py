"""The paper's multi-threaded engine on ``torch.distributed`` (port of
``repro.core.engine``).

The paper partitions query users across OS threads; here the partition is
across the ranks of one mesh axis, in SPMD form.  Every rank calls the
function with the full (U, I) ratings — the reference's global array —
and computes the rows ``[i·U/P, (i+1)·U/P)`` of its axis index ``i``;
the result blocks are ``all_gather``ed over the axis, so every rank
returns the global result, as the reference's ``shard_map`` does.  ``U``
must divide over the axis (``ValueError`` otherwise).

* ``sharded_topk``      — query users shard over the axis, every rank
                          reads the full candidate matrix (the paper's
                          shared-memory threads).
* ``ring_sharded_topk`` — candidates shard too: each rank starts with its
                          own shard, and for P steps scores its query
                          block against the shard it holds while that
                          shard moves on to the next rank
                          (``dist.batch_isend_irecv``, issued before the
                          tile's work so the two overlap).  At P = 1 there
                          is nobody to send to, so nothing rotates.
* ``sharded_predict`` / ``ring_sharded_predict`` — the mean-centred
                          predictor for the rank's query block; the ring
                          form recasts it as two dense (m, shard) weight
                          products per arriving shard, the global mean's
                          terms ``all_reduce``d (counts in int64, the
                          rating total in f32 — exact for integer ratings
                          whose total stays below 2^24).

The running top-k merge is ``merge_topk``'s canonical order (descending
score, lower id on ties), so the order in which candidate blocks arrive
cannot change a result: both top-k engines equal the sequential engine
bit for bit.  On CUDA tensors each rank's query block × candidate block
goes through the fused similarity kernel: ``sharded_topk`` calls
:func:`kernel_topk`, the one kernel fit that the facade's ``kernel``
backend and ``UserCF``'s ``sequential`` engine call too (the int8
operand with its ``max_value`` bound, the self pair knocked out by global
ids, the rows-past-bound count read once), and
``sharded_predict`` through the tile-predict kernel; CPU ranks run the
plain ``block_topk`` and the plain item tiles.

Collectives take tensors on the mesh's device type (NCCL: CUDA, gloo:
CPU); ratings on another device type are an error.  With no mesh,
:func:`default_mesh` gives a one-axis mesh over the default group,
creating a one-rank group when none exists.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import neighbors as nb
from repro_torch.core import predict as pred_mod
from repro_torch.core.similarity import user_means
from repro_torch.kernels import similarity as ksim

_DEN_EPS = 1e-8


def _on_kernels(x: torch.Tensor) -> bool:
    """Whether ``x``'s engine work goes through the kernel wrappers: on
    CUDA tensors, and on a dry run's meta tensors (whose wrappers count
    the kernels' work)."""
    return x.device.type in ("cuda", "meta")


def default_mesh(device="cuda", axis: str = "data"):
    """One-axis mesh over every rank of the default process group (a
    one-rank NCCL group on the card, gloo on the CPU, when none is
    initialised) — the counterpart of the reference's ``cpu_mesh``."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(axes=(axis,), device=device)


def _similarity_operand(ratings, op):
    """The similarity kernel's operand and ``max_value`` for a fit from the
    gather operand ``op``, with no device read: the int8 copy and its bound
    inside the exact domain ``max_value² · D ≤ 2^24`` (a meta copy, whose
    work needs no bound, with None), else the f32 matrix and None."""
    src, bound = op
    if src.dtype == torch.int8 and (
            bound is None or bound * bound * src.shape[1] <= ksim.EXACT_SUM):
        return src, bound
    return ratings, None


def kernel_block_topk(q_src, cand_src, k: int, *, measure: str,
                      q_offset: int, cand_offset: int, block_size: int,
                      beta, max_value, n_bad
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k of the query rows ``q_src`` (global ids from
    ``q_offset``) over the candidate rows ``cand_src`` (from
    ``cand_offset``), each candidate block of ``block_size`` scored by
    the fused similarity kernel; the self pair scores NEG_INF.  Rows past
    ``max_value`` are counted into ``n_bad``, which the caller reads."""
    dev = q_src.device
    m = q_src.shape[0]
    best_s = torch.full((m, k), nb.NEG_INF, dtype=torch.float32,
                        device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    q_ids = q_offset + torch.arange(m, device=dev)
    for b0 in range(0, cand_src.shape[0], block_size):
        with obs.span("topk.block", b0=b0):
            block = cand_src[b0:b0 + block_size]
            with obs.span("topk.score"):
                s = ksim.fused_similarity(q_src, block, measure=measure,
                                          beta=beta, max_value=max_value,
                                          n_bad=n_bad)
            with obs.span("topk.merge"):
                cand = cand_offset + b0 + torch.arange(block.shape[0],
                                                       device=dev)
                s = s.masked_fill(cand[None, :] == q_ids[:, None],
                                  nb.NEG_INF)
                ids = cand.to(torch.int32)[None, :].expand(m, -1)
                best_s, best_i = nb.merge_topk(best_s, best_i, s, ids, k)
    return best_s, best_i


def check_bad(n_bad, max_value) -> None:
    """Read the rows-past-``max_value`` count of a fit's launches (one
    device sync) and raise if any row was past it.  A meta counter (a dry
    run's) holds no count to read."""
    if n_bad.device.type == "meta":
        return
    with obs.span("topk.check_bad"):
        bad = int(n_bad.item())
    if bad:
        raise ValueError(f"ratings past the fit's max_value {max_value}")


def kernel_topk(ratings: torch.Tensor, k: int, *, measure: str,
                block_size: int, beta=None, operand=None, q0: int = 0,
                n_query: int | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of the query users ``[q0, q0 + n_query)`` (default:
    every user) over all users, every candidate block of ``block_size``
    scored by the fused similarity kernel: on its int8 route when the
    gather ``operand`` (default :func:`make_gather_operand` of ``ratings``)
    is int8 inside the exact domain, else on its f32 route.  Rows past the
    operand's ``max_value`` are counted on the device and read once, after
    the last launch, so no launch waits for the one before."""
    if operand is None:
        operand = pred_mod.make_gather_operand(ratings)
    src, max_value = _similarity_operand(ratings, operand)
    n_query = src.shape[0] - q0 if n_query is None else n_query
    n_bad = torch.zeros((1,), dtype=torch.int32, device=ratings.device)
    best = kernel_block_topk(src[q0:q0 + n_query], src, k, measure=measure,
                             q_offset=q0, cand_offset=0,
                             block_size=block_size, beta=beta,
                             max_value=max_value, n_bad=n_bad)
    check_bad(n_bad, max_value)
    return best


def mesh_axis(mesh, axis: str, x: torch.Tensor):
    """(group, this rank's index on ``axis``, the axis size) — with the
    device check every collective on ``x``'s device relies on."""
    if x.device.type not in (mesh.device_type, "meta"):
        raise ValueError(f"tensors on {x.device.type} but the mesh's "
                         f"collectives take {mesh.device_type} tensors")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(dim)


def _shard(n_users: int, axis: str, n: int) -> int:
    if n_users % n:
        raise ValueError(f"U={n_users} must divide over axis {axis}={n}")
    return n_users // n


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in axis order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def axis_ranks(mesh, axis: str) -> list:
    """Global ranks along ``axis`` through this rank's coordinate."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    coord[dim] = slice(None)
    return mesh.mesh[tuple(coord)].tolist()


def _rotate(x: torch.Tensor, ranks: list, me: int):
    """Send ``x`` to the next rank of the ring and receive the previous
    rank's block; returns ``(requests, received)`` — wait on every
    request before reading ``received``."""
    n = len(ranks)
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + 1) % n]),
           dist.P2POp(dist.irecv, got, ranks[(me - 1) % n])]
    return dist.batch_isend_irecv(ops), got


def _ring_operand(q: torch.Tensor, group):
    """The similarity operand of a ring rank's shard, chosen from global
    facts: int8 only if every shard's gather operand is int8, with the
    largest of their ``max_value``s as the bound (the flags the records
    hold, one ``all_reduce``).  A meta shard (a dry run's) reduces its
    flags unread and takes the int8 route with None."""
    op = pred_mod.make_gather_operand(q)
    flags = torch.tensor([int(op.src.dtype != torch.int8), op.max_value or 0],
                         dtype=torch.int64, device=q.device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
    if q.device.type == "meta":
        return op.src, None
    not_int8, bound = flags.tolist()
    return _similarity_operand(q.contiguous(), pred_mod.GatherOperand(
        q if not_int8 else op.src, bound))


def sharded_topk(ratings: torch.Tensor, k: int, mesh=None, *,
                 measure: str = "pcc", axis: str = "data",
                 block_size: int = 1024, beta: float | None = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper-faithful engine: query users shard over ``axis``, every rank
    reads all candidates.  Returns the global (U, k) scores and neighbor
    ids on every rank, identical to ``topk_neighbors``."""
    mesh = mesh if mesh is not None else default_mesh(ratings.device, axis)
    group, me, n = mesh_axis(mesh, axis, ratings)
    n_users = ratings.shape[0]
    shard = _shard(n_users, axis, n)
    q0 = me * shard
    bs = min(block_size, n_users)
    if _on_kernels(ratings):
        s, i = kernel_topk(ratings, k, measure=measure, block_size=bs,
                           beta=beta, q0=q0, n_query=shard)
    else:
        s, i = nb.block_topk(ratings[q0:q0 + shard], ratings, k,
                             measure=measure, q_offset=q0, block_size=bs,
                             beta=beta)
    return all_gather_rows(s, group, n), all_gather_rows(i, group, n)


def ring_sharded_topk(ratings: torch.Tensor, k: int, mesh=None, *,
                      measure: str = "pcc", axis: str = "data",
                      block_size: int = 1024, beta: float | None = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Systolic engine: candidate shards rotate around the axis, so a rank
    scores against one (U/P, I) shard at a time.  Same result as
    :func:`sharded_topk`."""
    mesh = mesh if mesh is not None else default_mesh(ratings.device, axis)
    group, me, n = mesh_axis(mesh, axis, ratings)
    shard = _shard(ratings.shape[0], axis, n)
    q0 = me * shard
    q = ratings[q0:q0 + shard]
    bs = min(block_size, shard)
    if _on_kernels(ratings):
        q, max_value = _ring_operand(q, group)
        n_bad = torch.zeros((1,), dtype=torch.int32, device=ratings.device)
    ranks = axis_ranks(mesh, axis)
    best_s = torch.full((shard, k), nb.NEG_INF, dtype=torch.float32,
                        device=ratings.device)
    best_i = torch.full((shard, k), -1, dtype=torch.int32,
                        device=ratings.device)
    cand = q
    for step in range(n):
        c0 = ((me - step) % n) * shard      # the held shard's first id
        if step + 1 < n:
            reqs, nxt = _rotate(cand, ranks, me)
        if _on_kernels(ratings):
            s, i = kernel_block_topk(q, cand, k, measure=measure,
                                     q_offset=q0, cand_offset=c0,
                                     block_size=bs, beta=beta,
                                     max_value=max_value, n_bad=n_bad)
        else:
            s, i = nb.block_topk(q, cand, k, measure=measure, q_offset=q0,
                                 cand_offset=c0, block_size=bs, beta=beta)
        best_s, best_i = nb.merge_topk(best_s, best_i, s, i, k)
        if step + 1 < n:
            for req in reqs:
                req.wait()
            cand = nxt
    if _on_kernels(ratings):
        check_bad(n_bad, max_value)
    return (all_gather_rows(best_s, group, n),
            all_gather_rows(best_i, group, n))


def sharded_predict(ratings: torch.Tensor, scores: torch.Tensor,
                    idx: torch.Tensor, mesh=None, *, axis: str = "data"
                    ) -> torch.Tensor:
    """Mean-centred neighbor prediction with query users sharded over
    ``axis``: the rank's (U/P, I) block through the tile predictor (the
    CUDA kernel on the card), gathered to (U, I) on every rank."""
    mesh = mesh if mesh is not None else default_mesh(ratings.device, axis)
    group, me, n = mesh_axis(mesh, axis, ratings)
    shard = _shard(ratings.shape[0], axis, n)
    rows = slice(me * shard, (me + 1) * shard)
    means = user_means(ratings)
    pred = pred_mod.predict_from_neighbors_blocked(
        ratings, scores[rows], idx[rows], means=means,
        query_means=means[rows],
        gather_src=pred_mod.make_gather_source(ratings), use_kernel=True)
    return all_gather_rows(pred, group, n)


def _means_of(block: torch.Tensor, global_mean: torch.Tensor):
    """Per-row means over rated cells; unrated rows take ``global_mean``."""
    cnt = (block > 0).sum(-1, dtype=torch.int32)
    return torch.where(cnt > 0, block.sum(-1) / cnt.clamp_min(1),
                       global_mean)


def ring_sharded_predict(ratings: torch.Tensor, scores: torch.Tensor,
                         idx: torch.Tensor, mesh=None, *,
                         axis: str = "data") -> torch.Tensor:
    """Production-scale prediction: rating shards rotate around the axis.
    Per arriving shard, a dense (m, shard) matrix of the top-k weights
    whose ids fall in the shard times its deviation and rated-mask
    matrices (``torch.matmul``, TF32 off), accumulated over the ring;
    equal to ``predict_from_neighbors`` up to f32 summation order."""
    mesh = mesh if mesh is not None else default_mesh(ratings.device, axis)
    group, me, n = mesh_axis(mesh, axis, ratings)
    n_items = ratings.shape[1]
    shard = _shard(ratings.shape[0], axis, n)
    rows = slice(me * shard, (me + 1) * shard)
    q, w, nb_idx = ratings[rows].contiguous(), scores[rows], idx[rows]
    dev = ratings.device

    # the global mean of the zero-raters' fallback: exact terms reduced
    cnt = (q > 0).sum(dtype=torch.int64).reshape(1)
    tot = q.sum().reshape(1)
    dist.all_reduce(cnt, group=group)
    dist.all_reduce(tot, group=group)
    global_mean = tot[0] / cnt[0].clamp_min(1)
    my_means = _means_of(q, global_mean)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w_pos = torch.where((w > 0) & (nb_idx >= 0), w, zero)        # (m, k)

    ranks = axis_ranks(mesh, axis)
    num = torch.zeros((shard, n_items), dtype=torch.float32, device=dev)
    den = torch.zeros((shard, n_items), dtype=torch.float32, device=dev)
    cand = q
    for step in range(n):
        if step + 1 < n:
            reqs, nxt = _rotate(cand, ranks, me)
        rel = nb_idx.long() - ((me - step) % n) * shard
        valid = (rel >= 0) & (rel < shard)
        wmat = torch.zeros((shard, shard), dtype=torch.float32, device=dev)
        wmat.scatter_add_(1, rel.clamp(0, shard - 1),
                          torch.where(valid, w_pos, zero))
        mask = (cand > 0).float()
        devn = (cand - _means_of(cand, global_mean)[:, None]) * mask
        num = num + wmat @ devn
        den = den + wmat @ mask
        if step + 1 < n:
            for req in reqs:
                req.wait()
            cand = nxt
    qm = my_means[:, None]
    pred = qm + num / den.clamp_min(_DEN_EPS)
    pred = torch.where(den > _DEN_EPS, pred, qm).clamp(1.0, 5.0)
    return all_gather_rows(pred, group, n)

