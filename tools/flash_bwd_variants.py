"""Time patched copies of the tensor-core ("mma") route of
``src/repro_torch/csrc/flash_attention_bwd.cu`` (kernel 8's backward) at
``chip_smoke.py`` phase 22's shape, and check each against the plain
backward.

    python3 tools/flash_bwd_variants.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Each variant is the shipped source with one change: 32-row q stages in
the dK/dV kernel or 32-key stages in the dQ kernel (64 ship at d, dv ≤
64), ``__launch_bounds__`` asking for 3 dK/dV or 4 dQ blocks an SM, and
two diagnostics that cannot ship: the dK/dV kernel alone and the dQ
kernel alone (each with the Δ pass), whose times split the backward's.
They are built in parallel into ``src/repro_torch/build/variants/`` and
timed in turns (forward, then backward order, CUDA events) at B 4, Hq
32, Hkv 8, S 2048, d 64, bf16, causal; each prints its registers, its
time and whether dQ, dK and dV of five shapes (Llama's heads at S 256,
ragged tiles, Sq > Skv, non-causal, d = dv = 128) are within 1e-2 of the
largest |gradient| of the plain backward on f32 copies.
"""

from __future__ import annotations

import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

DKDV_BN = ("constexpr int dkdv_bn(int dk, int dv) {\n"
           "  return dk <= 64 && dv <= 64 ? 64 : 32;")
DQ_BN = ("constexpr int dq_bn(int dk, int dv) {\n"
         "  return dk <= 64 && dv <= 64 ? 64 : 32;")
DKDV = "__launch_bounds__(MMA_THREADS)\ndkdv_mma_kernel"
DQ = "__launch_bounds__(MMA_THREADS)\ndq_mma_kernel"
LAUNCH_DKDV = "k2<<<dim3(k_tiles, a.Hkv, batch), MMA_THREADS, b2, st>>>(a);"
LAUNCH_DQ = "k3<<<dim3(q_tiles, a.Hq, batch), MMA_THREADS, b3, st>>>(a);"


def patch(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant patch does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    return {
        "shipped": src,
        "dK/dV 32-row q stages": patch(src, (DKDV_BN, DKDV_BN.replace(
            "? 64 : 32", "? 32 : 32"))),
        "dQ 32-key stages": patch(src, (DQ_BN, DQ_BN.replace(
            "? 64 : 32", "? 32 : 32"))),
        "dK/dV 3 blocks an SM": patch(src, (DKDV, DKDV.replace(
            "(MMA_THREADS)", "(MMA_THREADS, 3)"))),
        "dQ 4 blocks an SM": patch(src, (DQ, DQ.replace(
            "(MMA_THREADS)", "(MMA_THREADS, 4)"))),
        "diagnostic: dK/dV alone": patch(src, (LAUNCH_DQ, "(void)b3;")),
        "diagnostic: dQ alone": patch(src, (LAUNCH_DKDV, "(void)b2;")),
    }


def build(vs: dict) -> dict:
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(vs.items()):
        cu = out_dir / f"bwd{i}.cu"
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
        regs = {fn: (r, spill) for fn, r, spill in _build.ptxas_report(log)
                if re.match(r"(dkdv|dq)_mma_kernelILi64ELi64E", fn)}
        print(f"{name}: registers, spill bytes {regs}")
        libs[name] = so
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "flash_attention_bwd.cu").read_text()
    libs = build(variants(src))
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(22)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    def case(b, hkv, group, sq, skv, d, dv, causal=True):
        q, k, v = (rnd(b, hkv * group, sq, d), rnd(b, hkv, skv, d),
                   rnd(b, hkv, skv, dv))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        do = rnd(*o.shape)
        want = fa.flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, o, do)), causal=causal)
        return (q, k, v, o, do, lse), causal, want

    cases = [case(1, 8, 4, 256, 256, 64, 64), case(2, 2, 1, 77, 77, 64, 64),
             case(1, 1, 2, 20, 8, 64, 64),
             case(2, 1, 2, 100, 100, 64, 64, causal=False),
             case(1, 2, 4, 50, 130, 128, 128)]
    b, hq, hkv, s, d = 4, 32, 8, 2048, 64
    q, k, v = rnd(b, hq, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    do = rnd(*o.shape)

    def within(args, causal, want):
        got = fa.flash_attention_bwd(*args, causal=causal)
        return all(float((x.float() - w).abs().max())
                   <= 1e-2 * max(1.0, float(w.abs().max()))
                   for x, w in zip(got, want))

    def timed(fn, reps=10):
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
            _build._libs["flash_attention_bwd"] = ctypes.CDLL(str(libs[name]))
            ok = all(within(*c) for c in cases)
            ms = timed(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse))
            print(f"{name:26s} backward {ms:.4f} ms, every case within "
                  f"1e-2: {ok}")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
