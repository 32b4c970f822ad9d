"""Causal GQA flash attention (forward): the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention`` (``_flash_kernel``): q (B, Hq, Sq, d), k (B, Hkv, Skv, d),
v (B, Hkv, Skv, dv) → (B, Hq, Sq, dv) in q's dtype, with Hq = g·Hkv, an
online softmax over KV blocks accumulated in f32, queries aligned to the
end of the keys (``q_offset = Skv − Sq``) and fully masked rows at 0.
Unlike the TPU kernel, Sq and Skv need not divide any block size.

``kv_len`` (B,) int32 gives each batch row its own key count: keys at
positions ≥ ``kv_len[b]`` are masked and the row's queries align to
``kv_len[b] − Sq``.  With Sq = 1 that is the reference's
``repro.models.common.decode_attention`` over a cache of ``cache_len + 1``
keys; with ``kv_len=None`` it is exactly the TPU kernel's contract.

On a CUDA tensor the wrapper takes one of three routes of the kernel,
by dtype and by packed rows R = Sq·Hq/Hkv (the query positions times the
heads of a GQA group): f32 → ``"simt"`` (f32 FMAs, the 1e-5 contract);
bf16 with R > 16 → ``"mma"`` (tensor-core prefill, on the tile
:func:`mma_tile` names: d padded to 64, 128, 192 — MLA's q·k width — or
256, dv to 64, 128 or 256); bf16 with R ≤ 16 → ``"split"`` (split-K
decode, two launches and an f32 workspace).  It
launches that route or raises — it never falls back; on a CPU tensor it
runs the plain version; on a meta tensor (a dry run, ``launch/dryrun.py``)
it returns meta outputs and workspaces and hands :func:`work` (the
backward: :func:`bwd_work`) to the run's counter.

The gradient (no TPU counterpart: the reference differentiates its XLA
``chunked_attention`` under ``jax.checkpoint``) is
:class:`FlashAttentionFn`, whose forward is the kernel above (asked for
its log-sum-exp) and whose backward is :func:`flash_attention_bwd`: the
hand-written CUDA kernel of ``csrc/flash_attention_bwd.cu`` on a CUDA
tensor — route ``"mma"`` (bf16 tensor cores) for bf16 with d ≤ 192 and
dv ≤ 128 (up to MLA's 192 / 128 heads), ``"simt"`` (f32 FMAs) for f32 and
for wider heads, chosen by :func:`bwd_route` with no fallback — and
:func:`flash_attention_bwd_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
MAX_HEAD_DIM = 256          # shared-memory tiles hold d, dv ≤ 256
PLAIN_BLOCK_KV = 512        # the plain version's KV block
SPLIT_MAX_ROWS = 16         # packed rows the split-K decode route holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"simt": 0, "mma": 1, "split": 2}
_BWD_ROUTES = {"simt": 0, "mma": 1}
MMA_BWD_MAX_DK = 192        # the widest d and dv the backward's
MMA_BWD_MAX_DV = 128        # tensor-core route takes


def _check(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need 4-d q, k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k must be (B, Hkv, Skv, {d}) and v (B, Hkv, Skv, "
                         f"dv), got {tuple(k.shape)} and {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be ({b},), got {tuple(kv_len.shape)}")
    tensors = (q, k, v) if kv_len is None else (q, k, v, kv_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          kv_len: torch.Tensor | None = None,
                          block_q: int | None = None,
                          block_kv: int = PLAIN_BLOCK_KV,
                          return_lse: bool = False):
    """Plain PyTorch version: the online softmax of ``chunked_attention``
    over KV blocks of ``block_kv`` keys for query chunks of ``block_q``
    rows (None: all rows at once), f32 throughout, with the TPU kernel's
    guards (``NEG_INF`` = finfo(f32).min, p and alpha at 0 where their
    operand is ``NEG_INF``, division by max(l, 1e-30)); keys and values at
    or past ``kv_len[b]`` take no part, whatever they hold.  With
    ``return_lse`` it returns ``(out, lse)``: lse (B, Hq, Sq) f32 is each
    row's m + log(max(l, 1e-30)) from the same loop (``NEG_INF`` on a row
    with no visible key)."""
    _check(q, k, v, kv_len)
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)
    if kv_len is None:
        kv_req = torch.full((b,), skv, dtype=torch.long, device=dev)
    else:
        kv_req = kv_len.long()
    kv_end = kv_req.clamp(0, skv)
    qpos = (kv_req - sq)[:, None] + torch.arange(sq, device=dev)  # (B, Sq)
    bq = block_q or max(sq, 1)
    out, lse = [], []
    for q0 in range(0, sq, bq):
        qc, pc = qf[:, :, :, q0:q0 + bq], qpos[:, q0:q0 + bq]
        m = torch.full(qc.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape[:-1] + (dv,), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, skv, block_kv):
            kc = k[:, :, k0:k0 + block_kv].float()
            vc = v[:, :, k0:k0 + block_kv].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            kpos = k0 + torch.arange(kc.shape[2], device=dev)
            present = kpos[None, :] < kv_end[:, None]            # (B, bk)
            # values past kv_end are never read, as in the kernel
            vc = torch.where(present[:, None, :, None], vc, 0.0)
            valid = present[:, None, :]                          # (B, 1, bk)
            if causal:
                valid = valid & (pc[:, :, None] >= kpos[None, None, :])
            s = torch.where(valid[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(torch.where(s == NEG_INF, NEG_INF, s - m_new))
            alpha = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_new))
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
            m = m_new
        out.append(acc / l.clamp_min(1e-30))
        lse.append(m + torch.log(l.clamp_min(1e-30)))
    out = torch.cat(out, 3) if out else qf.new_zeros((b, hkv, g, 0, dv))
    out = out.reshape(b, hq, sq, dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.cat(lse, 3) if lse else qf.new_zeros((b, hkv, g, 0, 1))
    return out, lse.reshape(b, hq, sq)


def visible_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """(query, key) pairs of one (batch row, head) that a call scores:
    every pair without ``causal``; with it, query i (aligned to the end of
    the keys) sees ``skv − sq + i + 1`` keys, none where that is ≤ 0."""
    if not causal:
        return sq * skv
    off = skv - sq
    start = max(0, -off)               # the first query that sees a key
    n = max(0, sq - start)
    first = off + start + 1
    return n * first + n * (n - 1) // 2


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, kv_len: int | None = None,
         return_lse: bool = False):
    """(operations, bytes) of one call, as ``PERF.md``'s bounds for kernel 8
    count them: 2·(d + dv) operations a visible (query, key) pair and head
    (the two products), q, the visible keys' k and v and the output each
    moved once (and the f32 log-sum-exp written with ``return_lse``).
    ``kv_len`` (the keys a row reads, the decode's cache length) depends
    on the data; without it every key of the cache counts."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    keys = skv if kv_len is None else min(kv_len, skv)
    pairs = visible_pairs(sq, keys, causal)
    n_bytes = (b * hq * sq * (d + dv) + b * hkv * keys * (d + dv)) \
        * q.element_size() + (b * hq * sq * 4 if return_lse else 0)
    return 2.0 * (d + dv) * pairs * b * hq, float(n_bytes)


def bwd_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True):
    """(operations, bytes) of one backward call, as ``PERF.md``'s bound for
    8b counts them: the function's five products (S and dP again, dV, dQ,
    dK: 2·(3·d + 2·dv) operations a visible pair and head), q, o, dO, dQ
    and k, v, dK, dV each moved once."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    pairs = visible_pairs(sq, skv, causal)
    n_bytes = (b * hq * sq + b * hkv * skv) * (2 * d + 2 * dv) \
        * q.element_size()
    return 2.0 * (3 * d + 2 * dv) * pairs * b * hq, float(n_bytes)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, i, i, ctypes.c_float, i, i, i, p, p]
        fn.restype = ctypes.c_int
        ws = lib.repro_flash_split_workspace
        ws.argtypes = [i, i, i, i]
        ws.restype = ctypes.c_longlong
    return lib


def route(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel route a CUDA call with these q, k takes: ``"simt"`` for
    f32, ``"mma"`` for bf16 with more than ``SPLIT_MAX_ROWS`` packed rows
    (Sq·Hq/Hkv), ``"split"`` for bf16 with at most that many."""
    if q.dtype == torch.float32:
        return "simt"
    rows = q.shape[2] * (q.shape[1] // k.shape[1])
    return "mma" if rows > SPLIT_MAX_ROWS else "split"


def mma_tile(d: int, dv: int) -> str:
    """The ``"mma"`` route's tile for heads of width d (q·k) and dv,
    ``"DKxDV"``: d padded to 64, 128, 192 or 256 and dv to 64, 128 or 256
    (``csrc/flash_attention.cu``'s ``launch_mma_all`` / ``launch_mma_dv``,
    whose zero columns are exact)."""
    dk = next(w for w in (64, 128, 192, 256) if d <= w)
    dvp = next(w for w in (64, 128, 256) if dv <= w)
    return f"{dk}x{dvp}"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_len: torch.Tensor | None = None,
                    return_lse: bool = False):
    """q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv) → (B, Hq,
    Sq, dv) in q's dtype; ``kv_len`` (B,) int32 or None (see the module
    docstring).  With ``return_lse`` it returns ``(out, lse)``, lse (B,
    Hq, Sq) f32 as :func:`flash_attention_plain` defines it, written by
    the route's epilogue (the backward reads it in place of recomputing
    each row's softmax statistics).

    CUDA tensors (f32 or bf16, unit stride on the last axis, any other
    strides; d, dv ≤ 256) launch the kernel's route (:func:`route`) on
    the current stream and add one to ``flash_attention.launches``, to
    ``flash_attention.routes[route]`` and, on ``"mma"``, to
    ``flash_attention.tiles[mma_tile(d, dv)]``; the output is allocated
    (B, Sq, Hq, dv) and returned as its (B, Hq, Sq, dv) view, so the
    model's head merge is free.  CPU tensors run the plain version.
    """
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len, return_lse=return_lse)
    if q.device.type == "meta":
        return _meta(q, k, v, causal, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"need q, k, v all f32 or all bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or not kv_len.is_contiguous()):
        raise TypeError("kv_len must be a contiguous int32 tensor")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need unit stride on the head dim")
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"d={d}, dv={dv}: the kernel takes at most "
                         f"{MAX_HEAD_DIM}")
    if return_lse and dv == 0:
        raise ValueError("return_lse needs dv ≥ 1: the kernel writes lse")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        path = route(q, k)
        strides = (ctypes.c_longlong * 12)(*(
            s for t in (q, k, v, out) for s in t.stride()[:3]))
        with torch.cuda.device(q.device):
            lib = _lib()
            ws = None
            if path == "split":
                ws = torch.empty(lib.repro_flash_split_workspace(
                    b, hkv, skv, dv), dtype=torch.float32, device=q.device)
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if kv_len is None else kv_len.data_ptr(), strides, b,
                hq, hkv, sq, skv, d, dv, scale, int(causal),
                _DTYPES[q.dtype], _ROUTES[path],
                None if ws is None else ws.data_ptr(), stream)
        _build.check(status, f"flash_attention ({path})")
        flash_attention.launches += 1
        flash_attention.routes[path] += 1
        if path == "mma":
            tile = mma_tile(d, dv)
            flash_attention.tiles[tile] = \
                flash_attention.tiles.get(tile, 0) + 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(_ROUTES, 0)
flash_attention.tiles = {}      # "mma" launches by mma_tile


def _meta(q, k, v, causal, return_lse):
    """The forward on meta tensors: the (B, Hq, Sq, dv) view of a (B, Sq,
    Hq, dv) output, the lse and the split route's f32 workspace, as the
    card allocates them; its work handed to the dry run's counter."""
    b, hq, sq, _ = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() and route(q, k) == "split":
        keys = _build.source_constant("flash_attention", "SPLIT_KEYS")
        rows = _build.source_constant("flash_attention", "SPLIT_ROWS")
        splits = -(-skv // keys) if skv > 0 else 1
        torch.empty((b * hkv * splits * rows * (dv + 2),),
                    dtype=torch.float32, device=q.device)
    if out.numel():
        _build.meta_call("flash_attention", work(q, k, v, causal=causal,
                                                 return_lse=return_lse))
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor,
                              lse: torch.Tensor | None = None, *,
                              causal: bool = True,
                              scale: float | None = None,
                              block_q: int = 1024):
    """Plain PyTorch gradient of the attention (no ``kv_len``): for each
    chunk of ``block_q`` query rows, P in f32 — exp(s − lse) from the
    forward's log-sum-exp ``lse`` (B, Hq, Sq) when given, else recomputed
    as softmax(s) (``NEG_INF`` where masked) — at 0 where masked (so a row
    with no visible key has none), then dV = Pᵀ·dO, dP = dO·Vᵀ,
    Δ = rowsum(dO ∘ O), dS = P ∘ (dP − Δ), dQ = scale·dS·K and
    dK = scale·dSᵀ·Q, dK and dV summed over each kv head's group.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    _check(q, k, v, None)
    b, hq, sq, d = q.shape
    hkv, skv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = q.device
    kf, vf = k.float(), v.float()
    qf = q.float().reshape(b, hkv, g, sq, d)
    of = o.float().reshape(b, hkv, g, sq, dv_dim)
    dof = do.float().reshape(b, hkv, g, sq, dv_dim)
    lsef = None if lse is None else lse.float().reshape(b, hkv, g, sq, 1)
    kpos = torch.arange(skv, device=dev)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=dev)
    for q0 in range(0, sq, max(block_q, 1)):
        qc = qf[:, :, :, q0:q0 + block_q]
        doc = dof[:, :, :, q0:q0 + block_q]
        qpos = skv - sq + q0 + torch.arange(qc.shape[3], device=dev)
        valid = kpos[None, :] <= qpos[:, None] if causal \
            else torch.ones((qc.shape[3], skv), dtype=torch.bool, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * scale
        if lsef is None:
            s = torch.where(valid, s, NEG_INF)
            m = s.amax(-1, keepdim=True)
            p = torch.where(valid, torch.exp(s - m), 0.0)
            p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        else:
            p = torch.where(valid, torch.exp(
                s - lsef[:, :, :, q0:q0 + block_q]), 0.0)
        delta = (doc * of[:, :, :, q0:q0 + block_q]).sum(-1, keepdim=True)
        dv += torch.einsum("bhgqk,bhgqe->bhke", p, doc)
        ds = p * (torch.einsum("bhgqe,bhke->bhgqk", doc, vf) - delta)
        dq[:, :, :, q0:q0 + block_q] = scale * torch.einsum(
            "bhgqk,bhkd->bhgqd", ds, kf)
        dk += scale * torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] \
            + [i] * 7 + [ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def bwd_route(q: torch.Tensor, v: torch.Tensor) -> str:
    """The backward kernel's route for a CUDA call with these q, v:
    ``"mma"`` (bf16 tensor cores) for bf16 with d ≤ ``MMA_BWD_MAX_DK``
    (192: MLA's q·k width) and dv ≤ ``MMA_BWD_MAX_DV`` (128), else
    ``"simt"`` (f32 FMAs)."""
    if (q.dtype == torch.bfloat16 and q.shape[3] <= MMA_BWD_MAX_DK
            and v.shape[3] <= MMA_BWD_MAX_DV):
        return "mma"
    return "simt"


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` (``kv_len=None``) at its
    output ``o`` and log-sum-exp ``lse`` (``flash_attention(...,
    return_lse=True)``) for the output gradient ``do``.

    CUDA tensors (all f32 or all bf16, unit stride on the last axis; d,
    dv ≤ 256; lse f32) launch ``csrc/flash_attention_bwd.cu`` on the
    current stream by the route :func:`bwd_route` names (three kernels:
    Δ = rowsum(dO ∘ O) into an f32 workspace, dK/dV, dQ; deterministic)
    and add one to ``flash_attention_bwd.launches`` and to
    ``flash_attention_bwd.routes[route]``; the gradients are allocated
    contiguous.  CPU tensors run :func:`flash_attention_bwd_plain`."""
    _check(q, k, v, None)
    if o.shape != q.shape[:3] + v.shape[3:] or do.shape != o.shape:
        raise ValueError(f"o and do must be {tuple(q.shape[:3])} + "
                         f"({v.shape[3]},), got {tuple(o.shape)} and "
                         f"{tuple(do.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         scale=scale)
    if q.device.type == "meta":
        dq, dk, dv = (torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in (q, k, v))
        if q.shape[0] * q.shape[1] * max(q.shape[2], k.shape[2]):
            # the Δ = rowsum(dO ∘ O) workspace
            torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
            _build.meta_call("flash_attention_bwd",
                             bwd_work(q, k, v, causal=causal))
        return dq, dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = (q, k, v, o, do)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"need q, k, v, o, do all f32 or all bf16, got "
                        f"{[t.dtype for t in tensors]}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be f32, got {lse.dtype}")
    if any(t.device != q.device for t in (*tensors, lse)):
        raise ValueError("all inputs must be on one device")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("q, k, v, o, do need unit stride on the head dim")
    b, hq, sq, d = q.shape
    hkv, skv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    if d > MAX_HEAD_DIM or dv_dim > MAX_HEAD_DIM:
        raise ValueError(f"d={d}, dv={dv_dim}: the kernel takes at most "
                         f"{MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    if b * hq * max(sq, skv):
        path = bwd_route(q, v)
        lse = lse.contiguous()
        delta = torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)
        strides = (ctypes.c_longlong * 24)(*(
            s for t in (*tensors, dq, dk, dv) for s in t.stride()[:3]))
        with torch.cuda.device(q.device):
            lib = _bwd_lib()
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.repro_flash_attention_bwd(
                *(t.data_ptr() for t in (*tensors, lse, dq, dk, dv, delta)),
                strides, b, hq, hkv, sq, skv, d, dv_dim, scale, int(causal),
                _DTYPES[q.dtype], _BWD_ROUTES[path], stream)
        _build.check(status, f"flash_attention_bwd ({path})")
        flash_attention_bwd.launches += 1
        flash_attention_bwd.routes[path] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(_BWD_ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable :func:`flash_attention` (``kv_len=None``):
    ``FlashAttentionFn.apply(q, k, v, causal, scale)``.  The forward is
    the forward kernel (its plain version on the CPU) and saves q, k, v,
    the output and its log-sum-exp (the only caller that asks for it);
    the backward is :func:`flash_attention_bwd` (its plain version on the
    CPU, from that log-sum-exp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None
