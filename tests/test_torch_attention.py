"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU, where the wrapper runs its plain version, against the JAX
reference: ``ref.attention_ref``, the Pallas ``flash_attention`` in
interpret mode, ``common.chunked_attention`` and ``common.decode_attention``
(mirroring ``tests/test_kernels.py``'s flash sweeps).  Inputs are numpy
draws from a seed handed to both packages.  Tolerances: 2e-5 in f32 (the
reference's own), 3e-2 in bf16 (one bf16 rounding of outputs near 1).  On
a fully masked row the reference oracle gives NaN while the kernels give
0, so oracle comparisons skip such rows and check them at 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import common as jcm
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import common as tcm

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(seed, b, hq, hkv, sq, skv, d, dv=None):
    rng = np.random.default_rng(seed)
    dv = d if dv is None else dv
    q = rng.normal(0, 1, (b, hq, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, skv, dv)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# (b, hkv, group, sq, skv, d, bq, bk): bq / bk divide sq / skv for the
# Pallas kernel; the ragged cases take one block each
SWEEP = [
    (1, 1, 1, 32, 32, 16, 16, 16),
    (3, 2, 2, 16, 48, 16, 16, 16),     # Sq < Skv: decode alignment
    (2, 1, 2, 9, 13, 16, 9, 13),       # ragged lengths
    (1, 2, 4, 5, 37, 32, 5, 37),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hkv,group,sq,skv,d,bq,bk", SWEEP)
def test_plain_flash_matches_reference(b, hkv, group, sq, skv, d, bq, bk,
                                       causal):
    seed = b * 1000 + hkv * 100 + group * 10 + sq + skv + d
    q, k, v = _qkv(seed, b, hkv * group, hkv, sq, skv, d)
    tq, tk, tv = _t(q, k, v)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before      # CPU: the plain version
    name = f"flash.{b}x{hkv}x{group}x{sq}x{skv}x{d}.causal={causal}"
    assert_parity(f"{name}.port_ref",
                  got, tref.attention_ref(tq, tk, tv, causal=causal), F32_TOL)
    jq, jk, jv = _j(q, k, v)
    assert_parity(f"{name}.jax_ref", got,
                  jref.attention_ref(jq, jk, jv, causal=causal), F32_TOL)
    assert_parity(f"{name}.pallas", got,
                  pallas_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                               interpret=True), F32_TOL)
    assert_parity(f"{name}.chunked", tcm.chunked_attention(
        tq, tk, tv, causal=causal, chunk_q=8, chunk_kv=8, use_kernel=False),
                  jcm.chunked_attention(jq, jk, jv, causal=causal,
                                        chunk_q=8, chunk_kv=8), F32_TOL)
    # the plain version's own query and KV blocking do not change the result
    assert_parity(f"{name}.block_kv", got,
                  flash_attention_plain(tq, tk, tv, causal=causal,
                                        block_q=5, block_kv=7), F32_TOL)


def test_fully_masked_rows_are_zero():
    """Sq > Skv, causal: the first Sq − Skv queries see no key.  The TPU
    kernel (and the port) give 0 there; the oracle's NaN rows are skipped."""
    q, k, v = _qkv(7, 1, 4, 2, 8, 4, 16)
    tq, tk, tv = _t(q, k, v)
    got = flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(got[:, :, :4], torch.zeros_like(got[:, :, :4]))
    jq, jk, jv = _j(q, k, v)
    assert_parity("flash.masked.pallas", got,
                  pallas_flash(jq, jk, jv, causal=True, bq=8, bk=4,
                               interpret=True), F32_TOL)
    want = np.asarray(jref.attention_ref(jq, jk, jv, causal=True))
    assert np.isnan(want[:, :, :4]).all()
    assert_parity("flash.masked.jax_ref", got[:, :, 4:], want[:, :, 4:],
                  F32_TOL)


def test_decode_matches_reference_decode_attention():
    """One query against a cache with ragged per-row lengths: the port's
    ``decode_attention`` (the flash wrapper with ``kv_len``) against the
    reference's masked-softmax ``decode_attention``."""
    b, hkv, group, s, d = 4, 2, 4, 40, 16
    q, k, v = _qkv(11, b, hkv * group, hkv, 1, s, d)
    cache_len = np.array([1, 17, 40, 33], np.int32)
    tq, tk, tv = _t(q, k, v)
    got = tcm.decode_attention(tq, tk, tv, torch.from_numpy(cache_len))
    jq, jk, jv = _j(q, k, v)
    assert_parity("decode.jax_decode", got,
                  jcm.decode_attention(jq, jk, jv, jnp.asarray(cache_len)),
                  F32_TOL)
    # a full cache (kv_len = S) is the TPU kernel's decode alignment
    jq0, jk0, jv0 = _j(q[:1], k[:1], v[:1])
    assert_parity("decode.full.pallas",
                  flash_attention(tq[:1], tk[:1], tv[:1], causal=True),
                  pallas_flash(jq0, jk0, jv0, causal=True, bq=1, bk=8,
                               interpret=True), F32_TOL)


def test_decode_and_mla_dims():
    """Sq = 1 against a long KV with dv ≠ d (reference test_kernels.py:67)."""
    q, k, v = _qkv(3, 2, 4, 2, 1, 128, 24, dv=16)
    tq, tk, tv = _t(q, k, v)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (2, 4, 1, 16)
    jq, jk, jv = _j(q, k, v)
    assert_parity("decode.mla.jax_ref", got,
                  jref.attention_ref(jq, jk, jv, causal=True), F32_TOL)
    assert_parity("decode.mla.pallas", got,
                  pallas_flash(jq, jk, jv, causal=True, bq=1, bk=32,
                               interpret=True), F32_TOL)


def test_kv_len_with_several_queries():
    """A prefill chunk against ragged caches: queries align to
    ``kv_len[b] − Sq`` and keys past ``kv_len[b]`` are masked (the port's
    oracle; the reference has no such entry point)."""
    q, k, v = _qkv(5, 3, 4, 2, 6, 30, 16, dv=8)
    kv_len = torch.tensor([6, 19, 30], dtype=torch.int32)
    tq, tk, tv = _t(q, k, v)
    for causal in (True, False):
        got = flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
        assert_parity(f"kv_len.causal={causal}", got,
                      tref.attention_ref(tq, tk, tv, causal=causal,
                                         kv_len=kv_len), F32_TOL)
    # keys at or past kv_len do not matter
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[0, :, 6:] = 1e4
    tv2[0, :, 6:] = float("nan")
    assert torch.equal(flash_attention(tq, tk2, tv2, kv_len=kv_len)[0],
                       flash_attention(tq, tk, tv, kv_len=kv_len)[0])


def test_bf16():
    """bf16 inputs, f32 accumulation, bf16 output (reference
    test_kernels.py:77)."""
    q, k, v = _qkv(9, 1, 2, 2, 64, 64, 32)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (x.astype(jnp.bfloat16) for x in _j(q, k, v))
    assert_parity("bf16.jax_ref", got.float(),
                  np.asarray(jref.attention_ref(jq, jk, jv, causal=True),
                             np.float32), BF16_TOL)
    assert_parity("bf16.pallas", got.float(),
                  np.asarray(pallas_flash(jq, jk, jv, causal=True, bq=32,
                                          bk=32, interpret=True), np.float32),
                  BF16_TOL)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 3, 4, 8)
    k = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention(q[:, :2], k, torch.zeros(1, 2, 5, 8))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q[:, :2], k, k,
                        kv_len=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("dtype,hq,hkv,sq,want", [
    (torch.float32, 32, 8, 1, "simt"), (torch.float32, 32, 8, 2048, "simt"),
    (torch.bfloat16, 32, 8, 1, "split"), (torch.bfloat16, 16, 2, 2, "split"),
    (torch.bfloat16, 1, 1, 16, "split"), (torch.bfloat16, 1, 1, 17, "mma"),
    (torch.bfloat16, 32, 8, 5, "mma"), (torch.bfloat16, 32, 8, 2048, "mma"),
])
def test_kernel_route_rule(dtype, hq, hkv, sq, want):
    """A CUDA call's route: f32 → simt; bf16 → the split-K decode at up to
    16 packed rows (Sq·Hq/Hkv), the tensor-core prefill past that."""
    from repro_torch.kernels.flash_attention import route
    q = torch.zeros((1, hq, sq, 8), dtype=dtype)
    k = torch.zeros((1, hkv, 4, 8), dtype=dtype)
    assert route(q, k) == want


# -- the backward: the plain gradient and the autograd Function ---------------

@pytest.mark.parametrize("b,hkv,group,sq,skv,d,chunk", [
    (2, 2, 2, 13, 13, 8, 4),     # group 2, S not a multiple of the chunk
    (1, 2, 4, 20, 20, 16, 8),    # group 4
    (1, 1, 4, 7, 5, 8, 4),       # Sq > Skv: the first rows fully masked
])
def test_plain_backward_matches_autograd_and_reference(b, hkv, group, sq,
                                                       skv, d, chunk):
    """``flash_attention_bwd_plain`` against autograd of
    ``flash_attention_plain`` and against ``jax.grad`` of the reference's
    ``chunked_attention`` (its XLA path, the one the reference trains
    through); ``FlashAttentionFn`` gives the plain gradients on the CPU.
    Tolerance 2e-5 (f32; sums in another order)."""
    import jax
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention_bwd, flash_attention_bwd_plain)
    q, k, v = _qkv(sq * 31 + group, b, hkv * group, hkv, sq, skv, d)
    do = np.random.default_rng(9).normal(0, 1, q.shape).astype(np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=True, block_kv=chunk)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    got = flash_attention_bwd_plain(*(t.detach() for t in (tq, tk, tv)),
                                    out.detach(), torch.from_numpy(do),
                                    causal=True, block_q=chunk)

    def ref(qq, kk, vv):
        o = jcm.chunked_attention(qq, kk, vv, causal=True, chunk_q=chunk,
                                  chunk_kv=chunk)
        return jnp.sum(o * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    fn_out = FlashAttentionFn.apply(tq, tk, tv, True, None)
    before = flash_attention_bwd.launches
    via_fn = torch.autograd.grad(fn_out, (tq, tk, tv), torch.from_numpy(do))
    assert flash_attention_bwd.launches == before       # CPU: no launch
    name = f"flash_bwd.{b}x{hkv}x{group}x{sq}x{skv}x{d}"
    for tag, g, a, w, f in zip("qkv", got, auto, want, via_fn):
        assert_parity(f"{name}.d{tag}.autograd", g, a, F32_TOL)
        assert_parity(f"{name}.d{tag}.reference", g, np.asarray(w), F32_TOL)
        assert_parity(f"{name}.d{tag}.function", f, g, F32_TOL)
    if sq > skv:                       # rows with no visible key: dq = 0
        assert float(got[0][:, :, :sq - skv].abs().max()) == 0.0


@pytest.mark.parametrize("b,hkv,group,sq,skv,d,dv,causal", [
    (2, 1, 2, 9, 9, 8, 12, True),      # dv != d
    (1, 2, 2, 11, 17, 16, 16, False),  # not causal, Sq < Skv
    (1, 1, 4, 10, 6, 8, 4, True),      # dv != d, Sq > Skv: masked rows
])
def test_function_gradient_matches_reference(b, hkv, group, sq, skv, d, dv,
                                             causal):
    """``FlashAttentionFn`` (forward with its log-sum-exp, the plain
    backward reading it) against ``jax.grad`` of the reference's
    ``chunked_attention`` beyond the causal d == dv cases above.  Tolerance
    2e-5 (f32; sums in another order)."""
    import jax
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    q, k, v = _qkv(sq * 13 + skv, b, hkv * group, hkv, sq, skv, d, dv)
    do = np.random.default_rng(3).normal(
        0, 1, (b, hkv * group, sq, dv)).astype(np.float32)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = FlashAttentionFn.apply(*leaves, causal, None)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def ref(qq, kk, vv):
        o = jcm.chunked_attention(qq, kk, vv, causal=causal, chunk_q=4,
                                  chunk_kv=4)
        return jnp.sum(o * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    name = f"flash_fn.{b}x{hkv}x{group}x{sq}x{skv}x{d}x{dv}.c{int(causal)}"
    for tag, g, w in zip("qkv", got, want):
        assert_parity(f"{name}.d{tag}", g, np.asarray(w), F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hkv,group,sq,skv,d,block_kv", [
    (2, 2, 2, 13, 13, 8, 4),
    (1, 1, 4, 7, 5, 8, 2),       # Sq > Skv: the first rows see no key
    (2, 2, 1, 3, 20, 16, 8),     # decode alignment
])
def test_plain_lse_is_the_masked_logsumexp(b, hkv, group, sq, skv, d,
                                           block_kv, causal):
    """``flash_attention_plain(..., return_lse=True)``'s lse against
    ``torch.logsumexp`` of the masked f32 scores (``NEG_INF`` where masked,
    so a row with no visible key gives ``NEG_INF`` on both sides); the
    output is the one without ``return_lse``."""
    q, k, v = _t(*_qkv(sq + skv + d, b, hkv * group, hkv, sq, skv, d))
    out, lse = flash_attention_plain(q, k, v, causal=causal,
                                     block_kv=block_kv, return_lse=True)
    assert lse.shape == (b, hkv * group, sq) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention_plain(q, k, v, causal=causal,
                                                  block_kv=block_kv))
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.reshape(b, hkv, group, sq, d), k) / d ** 0.5
    qpos = skv - sq + torch.arange(sq)
    valid = (torch.arange(skv)[None, :] <= qpos[:, None] if causal
             else torch.ones((sq, skv), dtype=torch.bool))
    want = torch.logsumexp(torch.where(valid, s, NEG_INF), -1)
    assert_parity(f"flash_lse.{b}x{hkv}x{group}x{sq}x{skv}.c{int(causal)}",
                  lse, want.reshape(lse.shape), F32_TOL)
    if causal and sq > skv:
        assert bool((lse[:, :, :sq - skv] == NEG_INF).all())
    # the wrapper on the CPU is the plain version, lse included
    got = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert_parity("flash_lse.wrapper", got[1], lse, F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hkv,group,sq,skv,d,dv,chunk", [
    (2, 2, 2, 13, 13, 8, 8, 4),
    (1, 1, 4, 7, 5, 8, 6, 4),    # Sq > Skv, dv != d
    (1, 2, 2, 5, 19, 16, 16, 2),
])
def test_plain_backward_from_lse_matches_recomputed(b, hkv, group, sq, skv,
                                                    d, dv, chunk, causal):
    """``flash_attention_bwd_plain`` with the forward's ``lse`` (P =
    exp(s − lse), masked) against itself without it (P recomputed as the
    masked softmax), within 2e-5; rows with no visible key stay 0."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    q, k, v = _t(*_qkv(sq * 5 + skv, b, hkv * group, hkv, sq, skv, d, dv))
    out, lse = flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=True)
    do = torch.from_numpy(np.random.default_rng(sq).normal(
        0, 1, out.shape).astype(np.float32))
    want = flash_attention_bwd_plain(q, k, v, out, do, causal=causal,
                                     block_q=chunk)
    got = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal,
                                    block_q=chunk)
    via = flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    name = f"flash_bwd_lse.{b}x{hkv}x{group}x{sq}x{skv}.c{int(causal)}"
    for tag, g, w, x in zip("qkv", got, want, via):
        assert_parity(f"{name}.d{tag}", g, w, F32_TOL)
        assert_parity(f"{name}.d{tag}.wrapper", x, g, F32_TOL)
    if causal and sq > skv:
        assert float(got[0][:, :, :sq - skv].abs().max()) == 0.0


def test_chunked_attention_takes_the_function_with_grad():
    """With a gradient needed, ``chunked_attention(use_kernel=True)`` goes
    through ``FlashAttentionFn`` (its output has that grad_fn); without,
    it is the forward alone."""
    q, k, v = _t(*_qkv(4, 1, 4, 2, 6, 6, 8))
    q.requires_grad_()
    out = tcm.chunked_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert tcm.chunked_attention(q, k, v).grad_fn is None
    plain = tcm.chunked_attention(q, k, v, use_kernel=False)
    assert type(plain.grad_fn).__name__ != "FlashAttentionFnBackward"
    assert_parity("flash_fn.forward", out, plain, F32_TOL)


def test_backward_kernel_source_and_wrapper():
    """``csrc/flash_attention_bwd.cu`` is built like the other kernels
    (a plain C entry point returning ``cudaGetLastError``, its bound
    stated, listed in ``_build.KERNELS``); its wrapper counts launches,
    checks its shapes, and on a dry run's meta tensors returns meta
    gradients without a launch."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    src = (Path(_build.CSRC) / "flash_attention_bwd.cu").read_text()
    assert 'extern "C"' in src and "cudaGetLastError" in src
    assert "Bound." in src and "repro/models/common.py" in src
    # both bounds: the function's five products, the seven it runs
    bound = src[src.index("// Bound."):]
    assert "0.174 ms" in bound and "0.243 ms" in bound
    # deterministic: no gradient written with atomics; no stats pass
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"\batomic\w*\s*\(|\bred\.", code)
    assert "stats_kernel" not in src and "mma.sync" in src
    assert "flash_attention_bwd" in _build.KERNELS
    assert isinstance(flash_attention_bwd.launches, int)
    assert set(flash_attention_bwd.routes) == {"simt", "mma"}
    q = torch.zeros(1, 2, 3, 8, device="meta")
    lse = torch.zeros(1, 2, 3, device="meta")
    launches = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, q[:, :1], q[:, :1], q, q, lse)
    assert [(g.shape, g.device.type) for g in grads] == [
        (q.shape, "meta"), (q[:, :1].shape, "meta"), (q[:, :1].shape, "meta")]
    assert flash_attention_bwd.launches == launches
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, q[:, :1], q[:, :1], q, q, lse[:, :, :2])


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 64, 64, "mma"), (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 40, 72, "mma"), (torch.bfloat16, 192, 128, "mma"),
    (torch.bfloat16, 64, 256, "simt"), (torch.float32, 64, 64, "simt"),
    (torch.bfloat16, 136, 128, "mma"), (torch.bfloat16, 192, 136, "simt"),
    (torch.bfloat16, 200, 128, "simt"),
])
def test_backward_route_rule(dtype, d, dv, want):
    """A CUDA backward's route: bf16 with d ≤ 192 (MLA's q·k width) and
    dv ≤ 128 → the tensor-core ``"mma"`` route; f32, a q·k width past 192
    or a v width past 128 → ``"simt"``."""
    from repro_torch.kernels.flash_attention import bwd_route
    q = torch.zeros((1, 4, 3, d), dtype=dtype)
    v = torch.zeros((1, 2, 5, dv), dtype=dtype)
    assert bwd_route(q, v) == want
