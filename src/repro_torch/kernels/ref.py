"""Plain-torch oracles for the port's kernels, under the reference's names
(``repro.kernels.ref``), so the parity tests read alike.  They run on any
device and allocate freely.

Selection oracles are stable two-key sorts — ascending id, then
descending score — with the sentinel id ``N`` on every ``-inf`` slot,
never ``torch.topk`` (whose tie set is arbitrary).
"""

from __future__ import annotations

import torch

from repro_torch.core import predict as core_pred
from repro_torch.core import similarity as core_sim
from repro_torch.kernels.similarity import similarity_plain

_EPS = 1e-8


def similarity_ref(ra: torch.Tensor, rb: torch.Tensor, measure: str = "all",
                   beta: float = core_sim.PCC_SIG_BETA):
    """(m, D) × (n, D) → similarity under ``measure`` (or the jaccard,
    cosine, pcc triple for ``"all"``; ``beta`` is ``pcc_sig``'s horizon):
    the fused-similarity kernel's plain version."""
    return similarity_plain(ra, rb, measure=measure, beta=beta)


def tile_predict_ref(nbr: torch.Tensor, w: torch.Tensor,
                     nb_means: torch.Tensor,
                     q_means: torch.Tensor) -> torch.Tensor:
    """(m, k, T) gathered neighbor ratings, (m, k) masked weights and
    neighbor means, (m,) query means → (m, T) clipped predictions, with
    the k-reduction in the kernel's order."""
    return core_pred._tile_predict(w, nbr.float(), nb_means, q_means)


def support_scores_ref(dev: torch.Tensor, msk: torch.Tensor,
                       nb_idx: torch.Tensor, nb_w: torch.Tensor,
                       q_means: torch.Tensor) -> torch.Tensor:
    """(U, I) deviation/mask tables, (b, k) masked neighbor weights and
    clipped ids → (b, I) clipped predictions: the gathered (b, k, I) rows
    reduced by ``einsum`` (the reference's oracle form, any order).
    Oracle for ``repro_torch.kernels.support.fused_support_scores``."""
    ids = nb_idx.long()
    w = nb_w.float()
    num = torch.einsum("bk,bki->bi", w, dev.float()[ids])
    den = torch.einsum("bk,bki->bi", w, msk.float()[ids])
    eps = torch.full((), _EPS, dtype=torch.float32, device=dev.device)
    qm = q_means.float()[:, None]
    pred = qm + num / torch.maximum(den, eps)
    pred = torch.where(den > _EPS, pred, qm)
    return pred.clamp(1.0, 5.0)


def rerank_scores_ref(q_vals: torch.Tensor, cand_rows: torch.Tensor,
                      cand_norms: torch.Tensor, cand_counts: torch.Tensor,
                      measure: str = "cosine",
                      beta: float | None = None) -> torch.Tensor:
    """(G, J) query rows × (Kc, J) candidate-union rows → (G, Kc) exact
    similarity under ``measure``, with the candidates' full-row norms and
    rated counts passed in.  Oracle for
    ``repro_torch.kernels.rerank.fused_rerank_scores``: ``torch.matmul``
    Gram products (exact on integer ratings in any order) and the
    reference's epilogue order, square roots correctly rounded
    (``core.similarity._sqrt``) and every division tensor by tensor."""
    beta = core_sim.resolve_beta(beta)
    vq = q_vals.float()
    rc = cand_rows.float()
    mq = (vq > 0).float()
    mc = (rc > 0).float()
    eps = torch.full((), _EPS, dtype=torch.float32, device=vq.device)
    if measure == "cosine":
        dot = vq @ rc.T
        nq = core_sim._sqrt((vq * vq).sum(-1))[:, None]
        return dot / torch.maximum(nq * cand_norms[None, :].float(), eps)
    n = mq @ mc.T
    if measure == "jaccard":
        union = mq.sum(-1)[:, None] + cand_counts[None, :].float() - n
        return n / torch.maximum(union, eps)
    dot = vq @ rc.T
    sum_a = vq @ mc.T
    sum_b = mq @ rc.T
    sq_a = (vq * vq) @ mc.T
    sq_b = mq @ (rc * rc).T
    cov = n * dot - sum_a * sum_b
    var_a = n * sq_a - sum_a * sum_a
    var_b = n * sq_b - sum_b * sum_b
    denom = core_sim._sqrt(var_a.clamp_min(0.0) * var_b.clamp_min(0.0))
    valid = (n >= 2) & (denom > _EPS)
    pcc = (cov / torch.maximum(denom, eps)).clamp(-1.0, 1.0)
    zero = torch.zeros((), dtype=torch.float32, device=vq.device)
    s = torch.where(valid, (pcc + 1.0) * 0.5, zero)
    if measure == "pcc_sig":
        b = torch.full((), beta, dtype=torch.float32, device=vq.device)
        s = s * (n.clamp_max(beta) / b)
    return s


def select_topm_ref(scores: torch.Tensor, m: int):
    """(Q, N) scores → canonical top-``m``: ``(values, int32 ids)`` under
    the exact engines' ``(-score, id)`` order (descending score, ties to
    the lower id), every ``-inf`` slot carrying the sentinel id ``N``.
    Two stable sorts: by id (already ascending), then by −score."""
    n = scores.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device=scores.device)
    ids = ids[None, :].expand_as(scores)
    ids = torch.where(torch.isneginf(scores), torch.full_like(ids, n), ids)
    order = torch.sort(-scores, dim=1, stable=True).indices
    m = min(m, n)
    return (torch.gather(scores, 1, order[:, :m]),
            torch.gather(ids, 1, order[:, :m]))


def proxy_scores_ref(q: torch.Tensor, proxies: torch.Tensor) -> torch.Tensor:
    """(Q, P) × (N, P) → (Q, N) dot products summed in order p = 0..P−1,
    each product and each sum rounded on its own (no multiply-add) — the
    order of the CUDA scan kernel, so the two agree bit for bit and a row's
    scores do not depend on the rows beside it."""
    q = q.float()
    proxies = proxies.float()
    s = torch.zeros((q.shape[0], proxies.shape[0]), dtype=torch.float32,
                    device=q.device)
    for p in range(q.shape[1]):
        s = s + q[:, p, None] * proxies[None, :, p]
    return s


def scan_topm_ref(q: torch.Tensor, proxies: torch.Tensor,
                  q_ids: torch.Tensor, m: int):
    """(Q, P) query proxies × (N, P) pool → canonical top-``m`` of the
    proxy scores with the self-pair knockout.  Oracle for
    ``repro_torch.kernels.select.fused_scan_topm``."""
    s = proxy_scores_ref(q, proxies)
    col = torch.arange(proxies.shape[0], device=q.device)[None, :]
    s = s.masked_fill(col == q_ids.long()[:, None], float("-inf"))
    return select_topm_ref(s, m)


def centroid_distances_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(m, D) rows × (n, D) centroids → (m, n) squared Euclidean distances
    ``max((‖x‖² − 2x·c) + ‖c‖², 0)``, every sum taken in order d = 0..D−1
    with separately rounded products.  Oracle and plain version of
    ``repro_torch.kernels.cluster.fused_centroid_distances``: a row's
    distances do not depend on the batch it is computed in."""
    x = x.float()
    c = c.float()
    xx = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    cc = torch.zeros(c.shape[0], dtype=torch.float32, device=x.device)
    dot = torch.zeros((x.shape[0], c.shape[0]), dtype=torch.float32,
                      device=x.device)
    for d in range(x.shape[1]):
        xd = x[:, d]
        cd = c[:, d]
        xx = xx + xd * xd
        cc = cc + cd * cd
        dot = dot + xd[:, None] * cd[None, :]
    return ((xx[:, None] - 2.0 * dot) + cc[None, :]).clamp_min(0.0)


# -- attention ----------------------------------------------------------------

def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Naive attention oracle.  q: (B, Hq, Sq, d); k: (B, Hkv, Skv, d);
    v: (B, Hkv, Skv, dv).  GQA: the kv heads are repeated Hq/Hkv times.
    The causal mask aligns queries to the end of the keys; with ``kv_len``
    (B,) keys at positions ≥ ``kv_len[b]`` are masked and row b's queries
    align to ``kv_len[b] − Sq``.  As the reference oracle, a fully masked
    row comes out NaN (the kernels give 0 there).  Oracle for
    ``repro_torch.kernels.flash_attention.flash_attention``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    kv_req = (torch.full((b,), skv, device=q.device) if kv_len is None
              else kv_len.long())
    kpos = torch.arange(skv, device=q.device)
    mask = (kpos[None, :] < kv_req[:, None])[:, None, :]        # (B, 1, Skv)
    if causal:
        qpos = (kv_req - sq)[:, None] + torch.arange(sq, device=q.device)
        mask = mask & (qpos[:, :, None] >= kpos[None, None, :])
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


# -- embedding bag --------------------------------------------------------------

def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor, *,
                      combiner: str = "sum") -> torch.Tensor:
    """(V, D) table, (B, L) ids with -1 padding → (B, D) bags: the gathered
    (B, L, D) rows masked and summed in the table's dtype, the mean divided
    by max(count, 1) in that dtype.  Ids ≥ V are clamped to V − 1, as the
    reference oracle's indexing does (they lie outside the contract).
    Oracle for ``repro_torch.kernels.embedding_bag.embedding_bag``."""
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long().clamp_max(table.shape[0] - 1)
    rows = table[safe] * valid[..., None].to(table.dtype)      # (B, L, D)
    bags = rows.sum(dim=1)
    if combiner == "mean":
        cnt = valid.sum(dim=1, keepdim=True).clamp_min(1)
        bags = bags / cnt.to(bags.dtype)
    elif combiner != "sum":
        raise ValueError(f"unknown combiner {combiner!r}")
    return bags
