"""Time patched copies of the tensor-core prefill kernel of
``src/repro_torch/csrc/flash_attention.cu`` at Llama-3.2-1B's prefill
launch, and check each against the plain version.

    python3 tools/flash_variants.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Each variant is the shipped source with one change: the K/V tile's keys
(64, 16; 32 ships), 128-row blocks of 8 warps, ``__launch_bounds__`` with
5 blocks an SM, a three-stage cp.async ring (one barrier a tile), two
16-row groups a warp (each K/V fragment feeding both), and three
diagnostics that cannot ship: ``__expf`` for ``expf``, no masks (wrong on
edge tiles) and one bf16 P instead of the hi + lo split.  They are built
in parallel into ``src/repro_torch/build/variants/`` and timed in turns
(forward, then backward order, CUDA events) at B 4, Hq 32, Hkv 8, S
2048, d 64, bf16, causal; each prints its registers, its time and
whether every output of seven shapes (the prefill, ragged, a per-row
kv_len with NaN past it, d 192 / dv 128, d 40 / dv 72, non-causal, fully
masked rows) is within 2e-2 and one bf16 ulp + 1e-5 of the plain f32
result rounded to bf16.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

LAUNCH = "__global__ void __launch_bounds__(MMA_THREADS)\nmma_kernel"
KEYS = "constexpr int MMA_KEYS = 32;"
ROWS = "constexpr int MMA_BR = 64;"
THREADS = "constexpr int MMA_THREADS = 128;"
EXP = "const float p = s[n][e] == NEG_INF ? 0.f : expf(s[n][e] - mn);"
EDGE = "k0 + BK > kv_end || (a.causal && k0 + BK - 1 > qpos_first);"
LO = ("        mma_bf16(o[2 * n2], al, vf[0], vf[1]);\n",
      "        mma_bf16(o[2 * n2 + 1], al, vf[2], vf[3]);\n")
RING = (("  if (n_tiles > 0) load_kv(0, 0);\n",
         "  if (n_tiles > 0) load_kv(0, 0);\n"
         "  if (n_tiles > 1) load_kv(1, 1);\n"),
        ("""    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
""", """    const int st = t % 3;
    if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    if (t + 2 < n_tiles) load_kv(t + 2, (t + 2) % 3);
"""),
        ("    __syncthreads();  // this stage is consumed before it is "
         "refilled\n", ""),
        ("  bf16* v_s = k_s + 2 * BK * LDK;", "  bf16* v_s = k_s + 3 * BK * LDK;"),
        ("  return 2 * (MMA_BR * (dk + 8) + 2 * MMA_KEYS * (dk + 8) +\n"
         "              2 * MMA_KEYS * (dv + 8));",
         "  return 2 * (MMA_BR * (dk + 8) + 3 * MMA_KEYS * (dk + 8) +\n"
         "              3 * MMA_KEYS * (dv + 8));"))
# mma_kernel with RG 16-row groups a warp: every per-row array gains a
# row-group axis, and each K / V fragment feeds the warp's RG groups (it
# writes no log-sum-exp: the variants are timed without one)
ROW_GROUP_KERNEL = r"""template <int DK, int DV, bool LSE>
__global__ void __launch_bounds__(MMA_THREADS)
mma_kernel(const Args a) {
  constexpr int BK = MMA_KEYS;
  constexpr int RG = MMA_RG;
  constexpr int LDK = DK + 8, LDV = DV + 8;
  constexpr bool QREG = DK <= 128 && DV <= 128;
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* k_s = q_s + MMA_BR * LDK;
  bf16* v_s = k_s + 2 * BK * LDK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int n_rows = a.Sq * group;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MMA_BR;
  const int kv_req = a.kv_len != nullptr ? a.kv_len[b] : a.Skv;
  const int kv_end = max(0, min(kv_req, a.Skv));
  const int q_off = kv_req - a.Sq;
  int key_end = kv_end;
  if (a.causal) {
    const int last_qi = (min(r0 + MMA_BR, n_rows) - 1) / group;
    key_end = min(kv_end, max(0, q_off + last_qi + 1));
  }
  const int n_tiles = (key_end + BK - 1) / BK;
  const int qpos_first = q_off + r0 / group;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const bool vec = a.vec != 0;

  stage_bf16(q_s, LDK, MMA_BR, a.d, DK, vec, a.q, [&](int r) -> const bf16* {
    const int pr = r0 + r;
    if (pr >= n_rows) return nullptr;
    const int qi = pr / group, h = hk * group + (pr - qi * group);
    return qb + h * a.qs[1] + qi * a.qs[2];
  });
  cp_async_commit();
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    stage_bf16(k_s + st * BK * LDK, LDK, BK, a.d, DK, vec, a.k,
               [&](int r) -> const bf16* {
                 const int p = k0 + r;
                 return p < key_end ? kb + p * a.ks[2] : nullptr;
               });
    stage_bf16(v_s + st * BK * LDV, LDV, BK, a.dv, DV, vec, a.v,
               [&](int r) -> const bf16* {
                 const int p = k0 + r;
                 return p < key_end ? vb + p * a.vs[2] : nullptr;
               });
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0, 0);

  const int wr = warp * 16 * RG;
  int qpos[RG][2];
  float m[RG][2], l[RG][2];
  float o[RG][DV / 8][4];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qpos[r][h] = q_off + (r0 + wr + 16 * r + g + 8 * h) / group;
      m[r][h] = NEG_INF;
      l[r][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][n][e] = 0.f;
  }
  uint32_t qf[RG][QREG ? DK / 16 : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + st * BK * LDK;
    const bf16* vs = v_s + st * BK * LDV;
    const bf16* q_row = q_s + (wr + (lane & 15)) * LDK + (lane >> 4) * 8;
    if (QREG && t == 0) {
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int kc = 0; kc < (QREG ? DK / 16 : 1); ++kc)
          ldsm_x4(qf[r][kc], q_row + 16 * r * LDK + kc * 16);
    }

    float s[RG][BK / 8][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[r][n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      uint32_t af[RG][4];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[r][e] = qf[r][QREG ? kc : 0][e];
        } else {
          ldsm_x4(af[r], q_row + 16 * r * LDK + kc * 16);
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, ks + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
                         kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          mma_bf16(s[r][2 * n2], af[r], bfr[0], bfr[1]);
          mma_bf16(s[r][2 * n2 + 1], af[r], bfr[2], bfr[3]);
        }
      }
    }

    const int k0 = t * BK;
    const bool edge =
        k0 + BK > kv_end || (a.causal && k0 + BK - 1 > qpos_first);
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qp = qpos[r][e >> 1];
          const bool ok = !edge || (p < kv_end && (!a.causal || p <= qp));
          const float x = ok ? __fmul_rn(s[r][n][e], a.scale) : NEG_INF;
          s[r][n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[r][0], mx0), mn1 = fmaxf(m[r][1], mx1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn0 : mn1;
          const float p =
              s[r][n][e] == NEG_INF ? 0.f : expf(s[r][n][e] - mn);
          s[r][n][e] = p;
          if (e < 2) ps0 = __fadd_rn(ps0, p); else ps1 = __fadd_rn(ps1, p);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ps0 = __fadd_rn(ps0, __shfl_xor_sync(0xffffffffu, ps0, off));
        ps1 = __fadd_rn(ps1, __shfl_xor_sync(0xffffffffu, ps1, off));
      }
      const float al0 = m[r][0] == NEG_INF ? 0.f : expf(m[r][0] - mn0);
      const float al1 = m[r][1] == NEG_INF ? 0.f : expf(m[r][1] - mn1);
      l[r][0] = __fadd_rn(__fmul_rn(al0, l[r][0]), ps0);
      l[r][1] = __fadd_rn(__fmul_rn(al1, l[r][1]), ps1);
      m[r][0] = mn0;
      m[r][1] = mn1;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o[r][n][0] = __fmul_rn(o[r][n][0], al0);
        o[r][n][1] = __fmul_rn(o[r][n][1], al0);
        o[r][n][2] = __fmul_rn(o[r][n][2], al1);
        o[r][n][3] = __fmul_rn(o[r][n][3], al1);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ah[RG][4], al[RG][4];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        split_bf16x2(s[r][2 * kk][0], s[r][2 * kk][1], ah[r][0], al[r][0]);
        split_bf16x2(s[r][2 * kk][2], s[r][2 * kk][3], ah[r][1], al[r][1]);
        split_bf16x2(s[r][2 * kk + 1][0], s[r][2 * kk + 1][1], ah[r][2],
                     al[r][2]);
        split_bf16x2(s[r][2 * kk + 1][2], s[r][2 * kk + 1][3], ah[r][3],
                     al[r][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             LDV + n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          mma_bf16(o[r][2 * n2], ah[r], vf[0], vf[1]);
          mma_bf16(o[r][2 * n2], al[r], vf[0], vf[1]);
          mma_bf16(o[r][2 * n2 + 1], ah[r], vf[2], vf[3]);
          mma_bf16(o[r][2 * n2 + 1], al[r], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pr = r0 + wr + 16 * r + g + 8 * half;
      if (pr >= n_rows) continue;
      const int qi = pr / group, h = hk * group + (pr - qi * group);
      bf16* orow = ob + h * a.os[1] + qi * a.os[2];
      const float den = fmaxf(l[r][half], 1e-30f);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t4 + e;
          if (col < a.dv)
            orow[col] =
                __float2bfloat16_rn(__fdiv_rn(o[r][n][2 * half + e], den));
        }
    }
}

"""


def patch(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant patch does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    start = src.index("template <int DK, int DV, bool LSE>\n" + LAUNCH)
    end = src.index("template <int DK, int DV>\nint launch_mma(")
    groups = (src[:start] + ROW_GROUP_KERNEL + src[end:]).replace(
        ROWS, "constexpr int MMA_RG = 2;\nconstexpr int MMA_BR = 128;")
    return {
        "shipped (32 keys)": src,
        "64 keys": patch(src, (KEYS, KEYS.replace("32", "64"))),
        "16 keys": patch(src, (KEYS, KEYS.replace("32", "16"))),
        "128-row blocks": patch(src, (ROWS, ROWS.replace("64", "128")),
                                (THREADS, THREADS.replace("128", "256"))),
        "5 blocks an SM": patch(src, (LAUNCH, LAUNCH.replace(
            "(MMA_THREADS)", "(MMA_THREADS, 5)"))),
        "three-stage ring": patch(src, *RING),
        "two row groups a warp": groups,
        "diagnostic: __expf": patch(src, (EXP, EXP.replace("expf(",
                                                           "__expf("))),
        "diagnostic: no masks": patch(src, (EDGE, "false;")),
        "diagnostic: one bf16 P": patch(src, (LO[0], ""), (LO[1], "")),
    }


def build(vs: dict) -> dict:
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(vs.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        m = re.search(r"mma_kernelILi64ELi64ELb0E.*?Used (\d+) registers", log,
                      re.S)
        print(f"{name}: mma_kernel<64, 64> {m.group(1) if m else '?'} "
              f"registers")
        libs[name] = so
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "flash_attention.cu").read_text()
    libs = build(variants(src))
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    q = rnd(4, 2048, 32, 64).transpose(1, 2)
    k = rnd(4, 2048, 8, 64).transpose(1, 2)
    v = rnd(4, 2048, 8, 64).transpose(1, 2)
    lens = torch.tensor([0, 5, 100, 128, 257, 384], dtype=torch.int32,
                        device=dev)
    kk, vv = rnd(6, 2, 384, 64), rnd(6, 2, 384, 64)
    for row, n in enumerate(lens.tolist()):
        kk[row, :, n:] = float("nan")
        vv[row, :, n:] = float("nan")
    ragged = (rnd(2, 8, 77, 64), rnd(2, 2, 130, 64), rnd(2, 2, 130, 64))
    cases = [((q, k, v), {}), ((rnd(6, 8, 5, 64), kk, vv), {"kv_len": lens}),
             (ragged, {}), (ragged, {"causal": False}),
             ((rnd(1, 8, 40, 192), rnd(1, 2, 100, 192), rnd(1, 2, 100, 128)),
              {}),
             ((rnd(2, 8, 33, 40), rnd(2, 2, 150, 40), rnd(2, 2, 150, 72)), {}),
             ((rnd(1, 2, 20, 64), rnd(1, 1, 8, 64), rnd(1, 1, 8, 64)), {})]
    wants = [fa.flash_attention_plain(*(t.float() for t in args), **kw)
             .bfloat16().float() for args, kw in cases]

    def within(got, want):
        x = got.float()
        over = (x - want).abs() - (2.0 ** -7 * torch.maximum(
            x.abs(), want.abs()) + 1e-5)
        over = torch.where(x == want, torch.zeros_like(x), over)
        return (bool(torch.isfinite(x).all()) and float(over.max()) <= 0
                and float((x - want).abs().max()) <= 2e-2)

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    names = list(libs)
    for order in (names, names[::-1]):
        for name in order:
            _build._libs["flash_attention"] = ctypes.CDLL(str(libs[name]))
            ok = all(within(fa.flash_attention(*args, **kw), want)
                     for (args, kw), want in zip(cases, wants))
            ms = timed(lambda: fa.flash_attention(q, k, v))
            print(f"{name:24s} prefill {ms:.4f} ms, every case within "
                  f"one bf16 ulp: {ok}")
    sdpa = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(f"scaled_dot_product_attention {sdpa:.4f} ms; "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
