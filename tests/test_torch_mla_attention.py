"""Kernel 8 and its backward at DeepSeek-V2's MLA heads (q·k width 192 =
128 nope + 64 rope, v width 128) on the CPU, where the wrappers run their
plain versions: the forward against the reference's
``models/common.py::chunked_attention`` and the backward against
``jax.vjp`` of it, on numpy draws from a seed handed to both packages, in
f32, within 1e-5 of the largest |value| of each compared tensor (the two
sum in another order).  Then the tensor-core route's tile rule,
``mma_tile``, and the backward's route rule against the dispatch the
CUDA sources state (the kernels themselves run only on the card:
``tests/test_torch_kernels_cuda.py``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from repro.models import common as jcm
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    MMA_BWD_MAX_DK, MMA_BWD_MAX_DV, FlashAttentionFn, bwd_route,
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain, mma_tile)

QK, V = 192, 128                 # DeepSeek-V2's q·k and v head widths
SCALE = 1.0 / QK ** 0.5          # the model's 1/√qk_dim
REL = 1e-5

# (b, h, sq, skv, chunk): MLA has no grouping (Hq = Hkv); ragged lengths
# that no chunk divides, Sq == Skv as in training and prefill, and one
# Sq < Skv case (queries aligned to the end of the keys)
CASES = [
    (2, 3, 77, 77, 32),
    (1, 2, 40, 40, 16),
    (1, 2, 21, 45, 8),
]


def _inputs(seed, b, h, sq, skv):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, sq, QK)).astype(np.float32)
    k = rng.normal(0, 1, (b, h, skv, QK)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, skv, V)).astype(np.float32)
    do = rng.normal(0, 1, (b, h, sq, V)).astype(np.float32)
    return q, k, v, do


def _close(name, got, want):
    want = np.asarray(want)
    assert_parity(name, got, want, REL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("b,h,sq,skv,chunk", CASES)
def test_plain_forward_matches_reference_at_mla_width(b, h, sq, skv, chunk):
    """``flash_attention_plain`` (and the wrapper, which is it on the CPU)
    at q·k 192 / v 128, causal, against the reference's
    ``chunked_attention`` with the model's scale 1/√192."""
    q, k, v, _ = _inputs(sq * 11 + skv, b, h, sq, skv)
    want = jcm.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, scale=SCALE,
                                 chunk_q=chunk, chunk_kv=chunk)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    name = f"mla_fwd.{b}x{h}x{sq}x{skv}"
    got = flash_attention_plain(tq, tk, tv, causal=True, scale=SCALE,
                                block_q=chunk, block_kv=chunk)
    assert got.shape == (b, h, sq, V)
    _close(name, got, want)
    _close(f"{name}.wrapper", flash_attention(tq, tk, tv, scale=SCALE), want)


@pytest.mark.parametrize("b,h,sq,skv,chunk", CASES)
def test_plain_backward_matches_reference_vjp_at_mla_width(b, h, sq, skv,
                                                           chunk):
    """``flash_attention_bwd_plain`` at q·k 192 / v 128, causal — from the
    forward's log-sum-exp and with the softmax recomputed — and
    ``FlashAttentionFn`` (its CPU backward), against ``jax.vjp`` of the
    reference's ``chunked_attention`` for the same output gradient."""
    q, k, v, do = _inputs(sq * 13 + skv + 1, b, h, sq, skv)

    def ref(qq, kk, vv):
        return jcm.chunked_attention(qq, kk, vv, causal=True, scale=SCALE,
                                     chunk_q=chunk, chunk_kv=chunk)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=True, scale=SCALE,
                                     return_lse=True)
    from_lse = flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse,
                                         causal=True, scale=SCALE,
                                         block_q=chunk)
    recomputed = flash_attention_bwd_plain(tq, tk, tv, out, tdo,
                                           causal=True, scale=SCALE)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    launches = flash_attention_bwd.launches
    via_fn = torch.autograd.grad(
        FlashAttentionFn.apply(*leaves, True, SCALE), leaves, tdo)
    assert flash_attention_bwd.launches == launches      # CPU: no launch
    name = f"mla_bwd.{b}x{h}x{sq}x{skv}"
    for tag, w, a, c, f, x in zip("qkv", want, from_lse, recomputed, via_fn,
                                  (q, k, v)):
        assert a.shape == x.shape
        _close(f"{name}.d{tag}.lse", a, w)
        _close(f"{name}.d{tag}.recomputed", c, w)
        _close(f"{name}.d{tag}.function", f, w)


@pytest.mark.parametrize("d,dv,want", [
    (64, 64, "64x64"), (40, 72, "64x128"), (128, 128, "128x128"),
    (129, 128, "192x128"), (160, 128, "192x128"), (192, 128, "192x128"),
    (192, 64, "192x64"), (193, 128, "256x128"), (192, 136, "192x256"),
    (256, 256, "256x256"),
])
def test_forward_tile_rule(d, dv, want):
    """The ``"mma"`` route's tile: d padded to 64, 128, 192 or 256 and dv
    to 64, 128 or 256 — MLA's 192 / 128 heads on a tile of their own, not
    padded to 256."""
    assert mma_tile(d, dv) == want


def _dispatch(text, fn, arg):
    """The (bound, width) pairs of ``if (a.<arg> <= bound) return
    <fn><width>`` in ``text``'s ``int <fn>_…`` dispatch, and its last
    (unconditional) width."""
    body = re.search(rf"int {fn}\([^)]*\) {{(.*?)\n}}", text, re.S).group(1)
    pairs = [(int(b), int(w)) for b, w in re.findall(
        rf"if \(a\.{arg} <= (\d+)\) return launch_mma\w*<(?:DK, )?(\d+)",
        body)]
    last = int(re.findall(r"return launch_mma\w*<(?:DK, )?(\d+)", body)[-1])
    return pairs, last


def test_tile_rule_is_the_kernel_dispatch():
    """``mma_tile`` states ``csrc/flash_attention.cu``'s dispatch
    (``launch_mma_all`` by d, ``launch_mma_dv`` by dv) for every d, dv in
    1 … 256, and that file has a 192-wide instantiation."""
    text = (Path(_build.CSRC) / "flash_attention.cu").read_text()
    by_d, last_d = _dispatch(text, "launch_mma_all", "d")
    by_dv, last_dv = _dispatch(text, "launch_mma_dv", "dv")
    assert (192, 192) in by_d and last_d == 256 and last_dv == 256

    def pick(pairs, last, x):
        return next((w for b, w in pairs if x <= b), last)

    for d in range(1, 257):
        for dv in range(1, 257, 7):
            assert mma_tile(d, dv) == \
                f"{pick(by_d, last_d, d)}x{pick(by_dv, last_dv, dv)}"


@pytest.mark.parametrize("d,dv,want", [
    (192, 128, "mma"), (136, 128, "mma"), (160, 64, "mma"),
    (192, 136, "simt"), (200, 128, "simt"), (256, 128, "simt"),
])
def test_backward_route_at_mla_widths_is_the_c_guard(d, dv, want):
    """``bwd_route`` for bf16 past 128 agrees with the C entry's guard on
    route 1 (``d <= 192 && dv_dim <= 128``), and the 192 / 128
    instantiation the dispatch sends every d in 129 … 192 to exists."""
    text = (Path(_build.CSRC) / "flash_attention_bwd.cu").read_text()
    guard = re.search(r"route == 1 && dtype == 1 && d <= (\d+) && "
                      r"dv_dim <= (\d+)", text)
    assert (int(guard.group(1)), int(guard.group(2))) == (MMA_BWD_MAX_DK,
                                                         MMA_BWD_MAX_DV)
    assert "if (a.d > 128) return launch_mma<192, 128>(a, batch, st);" in text
    q = torch.zeros((1, 2, 3, d), dtype=torch.bfloat16)
    v = torch.zeros((1, 2, 5, dv), dtype=torch.bfloat16)
    assert bwd_route(q, v) == want
    assert bwd_route(q.float(), v.float()) == "simt"
