"""Canonical top-M selection for the shortlist scan: the hand-written CUDA
kernels (``csrc/select.cu``) and their plain PyTorch versions.

Ports of two Pallas TPU kernels of ``repro.kernels.select`` that share one
running merge:

* :func:`fused_scan_topm` (``fused_scan_topm`` / ``_scan_kernel``) — proxy
  scores of a query block against the whole pool, self-pair knocked out,
  canonical top-``m`` per query.  On the card it is two launches on one
  stream: the scores in the plain version's fixed order into a device
  workspace, then the radix select of :func:`select_topm` over them;
* :func:`select_topm` (``select_topm`` / ``_select_kernel``) — the same
  selection over precomputed (Q, N) scores; the MoE router's top-k
  (:func:`router_topk`) runs on it too.

Selection policy, pinned by ``ref.select_topm_ref``: descending score,
ties to the lower candidate id, every ``-inf`` slot carrying the sentinel
id ``N``.  Proxy scores are dot products summed in one fixed order
(``ref.proxy_scores_ref``) in the kernel and the plain version alike, so
the two give the same bits.  The CUDA kernel is held to the oracle, not
to the Pallas kernel (which misses its own oracle at Q=130, N=257,
P=33, m=17).  The radix select takes ``m`` ≤ :data:`SELECT_M_MAX`; both
wrappers raise past it (the scan before its launch).

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — it never falls back; on a meta tensor (a
dry run, ``launch/dryrun.py``) it returns meta outputs and hands
:func:`scan_work` / :func:`select_work` to the run's counter.  The index's other
canonical selections (smallest-``k`` distances, the rerank's final sort)
live here too, as stable sorts.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import scan_topm_ref, select_topm_ref

scan_topm_plain = scan_topm_ref

# the radix select's sort buffer (m entries, rounded up to a power of two,
# 8 bytes each) lives in shared memory
SELECT_M_MAX = 16384
# the radix select stages a row of at most ROW_STAGE_MAX scores in shared
# memory (radix_topm_kernel<true>, when the sort buffer fits beside it); a
# longer row is read from global memory on every pass over it
# (radix_topm_kernel<false>): csrc/select.cu
ROW_STAGE_MAX = 32768


def scan_topm_twin(q: torch.Tensor, proxies: torch.Tensor,
                   q_ids: torch.Tensor, *, m: int, approx: bool = False):
    """Plain twin of the reference's ``scan_topm_xla``: the exact path
    only.  ``approx=True`` (the TPU's ``approx_max_k``, recall < 1) has no
    counterpart in the port."""
    if approx:
        raise NotImplementedError(
            "approx=True (approx_max_k) is not ported: the port's scan is "
            "exact only")
    return scan_topm_plain(q, proxies, q_ids, min(m, proxies.shape[0]))


def scan_work(q: torch.Tensor, proxies: torch.Tensor, m: int):
    """(operations, bytes) of one :func:`fused_scan_topm` call, as
    ``PERF.md``'s bound for kernel 4 counts them: 2·Q·N·P operations for
    the scores; both proxy blocks and the query ids read once and the
    (Q, m) values and ids written once."""
    n_q, p = q.shape
    n = proxies.shape[0]
    m = min(m, n)
    return 2.0 * n_q * n * p, (n_q + n) * p * 4.0 + n_q * 4.0 + n_q * m * 8.0


def select_work(scores: torch.Tensor, m: int):
    """(operations, bytes) of one :func:`select_topm` call, as ``PERF.md``'s
    bound for kernel 5 counts them: one operation a score; the (Q, L)
    scores and the query ids read once and the (Q, m) values and ids
    written once."""
    n_q, n = scores.shape
    m = min(m, n)
    return float(n_q * n), n_q * n * 4.0 + n_q * 4.0 + n_q * m * 8.0


def _topm_meta(name, work, n_q, n, m, device, workspace=False):
    if workspace:                      # the scan's (Q, N) f32 scores
        torch.empty((n_q, n), dtype=torch.float32, device=device)
    _build.meta_call(name, work)
    return (torch.empty((n_q, m), dtype=torch.float32, device=device),
            torch.empty((n_q, m), dtype=torch.int32, device=device))


def _lib(name):
    lib = _build.load("select")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"repro_scan_topm": [p, p, p, p, p, p, i, i, i, i, p],
                       "repro_proxy_scores": [p, p, p, i, i, i, p],
                       "repro_select_topm": [p, p, p, p, i, i, i, p]}[name]
        fn.restype = ctypes.c_int
    return fn


def _check_ids(q_ids: torch.Tensor, n_q: int, device) -> None:
    if q_ids.shape != (n_q,) or q_ids.device != device:
        raise ValueError(f"q_ids must be ({n_q},) on {device}, got "
                         f"{tuple(q_ids.shape)} on {q_ids.device}")


def _scan_operands(q: torch.Tensor, proxies: torch.Tensor):
    """Both operands as rows of a multiple of 4 floats, 16-byte aligned:
    each zero pad adds 0·0 = +0 to a sum that starts at +0 and so is
    never −0, which leaves every score's bits as they are."""
    p4 = -(-q.shape[1] // 4) * 4
    return _build.padded_rows(q, p4), _build.padded_rows(proxies, p4), p4


def proxy_scores_cuda(q: torch.Tensor, proxies: torch.Tensor):
    """The scan's first launch alone: (Q, P) × (N, P) → (Q, N) f32 scores
    in ``ref.proxy_scores_ref``'s order, on the card (f32, contiguous).
    For timing and checking the two launches apart; the scan path goes
    through :func:`fused_scan_topm`, and this launch is not counted."""
    n_q, n = q.shape[0], proxies.shape[0]
    q, proxies, p4 = _scan_operands(q, proxies)
    out = torch.empty((n_q, n), dtype=torch.float32, device=q.device)
    if n_q and n:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib("repro_proxy_scores")(
                q.data_ptr(), proxies.data_ptr(), out.data_ptr(), n_q, n,
                p4, stream)
        _build.check(status, "proxy_scores_cuda")
    return out


def fused_scan_topm(q: torch.Tensor, proxies: torch.Tensor,
                    q_ids: torch.Tensor, *, m: int):
    """(Q, P) query proxies × (N, P) pool proxies → canonical top-``m``
    per query: ``(values (Q, m) f32, ids (Q, m) int32)``, ``m`` clamped
    to N.

    ``q_ids``: (Q,) global ids for the self-pair knockout (out-of-range,
    e.g. -1 or N, for padding queries).  Knocked-out slots come back as
    ``-inf`` with id ``N``.  CUDA tensors launch the score kernel and the
    radix select on the current stream (``m`` ≤ :data:`SELECT_M_MAX`
    after clamping; it raises past that) and add one to
    ``fused_scan_topm.launches``; CPU tensors run the plain version.
    """
    if q.dim() != 2 or proxies.dim() != 2 or q.shape[1] != proxies.shape[1]:
        raise ValueError(f"need (Q, P) × (N, P), got {tuple(q.shape)} × "
                         f"{tuple(proxies.shape)}")
    n_q, n = q.shape[0], proxies.shape[0]
    if n == 0 or m < 1:
        raise ValueError(f"need a non-empty pool and m ≥ 1 (N={n}, m={m})")
    m = min(m, n)
    if proxies.device != q.device:
        raise ValueError(f"q on {q.device} but proxies on {proxies.device}")
    _check_ids(q_ids, n_q, q.device)
    if q.device.type == "cpu":
        return scan_topm_plain(q, proxies, q_ids, m)
    if q.device.type == "meta":
        return _topm_meta("fused_scan_topm", scan_work(q, proxies, m), n_q,
                          n, m, q.device, workspace=n_q > 0)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.float32 or proxies.dtype != torch.float32 \
            or q_ids.dtype != torch.int32:
        raise TypeError(f"need f32 proxies and int32 q_ids, got {q.dtype}, "
                        f"{proxies.dtype}, {q_ids.dtype}")
    if not (q.is_contiguous() and proxies.is_contiguous()
            and q_ids.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if m > SELECT_M_MAX:
        raise ValueError(f"fused_scan_topm: m = {m} is past the radix "
                         f"select's domain (m ≤ {SELECT_M_MAX}, its sort "
                         f"buffer's shared memory)")
    q, proxies, p4 = _scan_operands(q, proxies)
    out_v = torch.empty((n_q, m), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n_q, m), dtype=torch.int32, device=q.device)
    if n_q:
        ws = torch.empty((n_q, n), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib("repro_scan_topm")(
                q.data_ptr(), proxies.data_ptr(), q_ids.data_ptr(),
                ws.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), n_q, n,
                p4, m, stream)
        _build.check(status, "fused_scan_topm")
        fused_scan_topm.launches += 1
    return out_v, out_i


fused_scan_topm.launches = 0


def select_topm(scores: torch.Tensor, q_ids: torch.Tensor, *, m: int):
    """Canonical top-``m`` over precomputed (Q, N) f32 scores: ``(values,
    int32 ids)``, same contract as :func:`fused_scan_topm`; pass
    out-of-range ``q_ids`` (e.g. -1) when the scores already carry their
    knockouts.  CUDA tensors launch the radix-select kernel (``m`` ≤
    :data:`SELECT_M_MAX` after clamping to N; it raises past that) and
    add one to ``select_topm.launches``; CPU tensors run the plain
    version."""
    if scores.dim() != 2:
        raise ValueError(f"need (Q, N) scores, got {tuple(scores.shape)}")
    n_q, n = scores.shape
    if n == 0 or m < 1:
        raise ValueError(f"need N ≥ 1 and m ≥ 1 (N={n}, m={m})")
    m = min(m, n)
    _check_ids(q_ids, n_q, scores.device)
    if scores.device.type == "cpu":
        return select_topm_twin(scores, q_ids, m=m)
    if scores.device.type == "meta":
        return _topm_meta("select_topm", select_work(scores, m), n_q, n, m,
                          scores.device)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if scores.dtype != torch.float32 or q_ids.dtype != torch.int32:
        raise TypeError(f"need f32 scores and int32 q_ids, got "
                        f"{scores.dtype}, {q_ids.dtype}")
    if not (scores.is_contiguous() and q_ids.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    out_v = torch.empty((n_q, m), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((n_q, m), dtype=torch.int32, device=scores.device)
    if n_q:
        with torch.cuda.device(scores.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib("repro_select_topm")(
                scores.data_ptr(), q_ids.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), n_q, n, m, stream)
        _build.check(status, "select_topm")
        select_topm.launches += 1
    return out_v, out_i


select_topm.launches = 0


def select_topm_twin(scores: torch.Tensor, q_ids: torch.Tensor, *, m: int):
    """Plain version of :func:`select_topm` on any device."""
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    knock = col == q_ids.long()[:, None]
    return select_topm_ref(scores.masked_fill(knock, float("-inf")),
                           min(m, scores.shape[1]))


def router_topk(probs: torch.Tensor, k: int, *, use_kernel: bool = True):
    """A MoE router's top-``k`` experts of each token: (T, E) f32 gate
    probabilities → ``(values (T, k), int32 ids (T, k))``, descending with
    ties to the lower expert id — the reference's ``lax.top_k`` on them
    (``repro/models/transformer.py:476``).  The ids come from
    :func:`select_topm` (kernel 5 on a CUDA tensor, one launch a call; its
    plain version on a CPU tensor) or, with ``use_kernel=False``, from
    :func:`select_topm_twin`; the values are ``probs`` gathered at them,
    the same bits as the selection's, so that a gradient reaches the
    router on any device."""
    scores = probs.detach().float().contiguous()
    q_ids = torch.full((scores.shape[0],), -1, dtype=torch.int32,
                       device=scores.device)
    select = select_topm if use_kernel else select_topm_twin
    ids = select(scores, q_ids, m=k)[1]
    return torch.gather(probs, 1, ids.long()), ids


def smallest_k(d: torch.Tensor, k: int):
    """Canonical smallest-``k`` per row of a distance matrix: ``(values,
    int32 column ids)``, ties to the lower column id (a stable ascending
    sort) — the reference's ``lax.top_k(-d, k)`` on spill and probe
    distances."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order), order.to(torch.int32)


def topk_canonical(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Best ``k`` of each row under ``(-score, id)``: a stable sort by id,
    then a stable sort by descending score (``lax.sort`` with two keys)."""
    order = torch.sort(ids, dim=1, stable=True).indices
    scores = torch.gather(scores, 1, order)
    ids = torch.gather(ids, 1, order)
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return torch.gather(scores, 1, order), torch.gather(ids, 1, order)

