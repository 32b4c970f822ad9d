"""Time patched copies of kernels 1, 7 and 2 —
``src/repro_torch/csrc/similarity.cu`` (the int8 pcc route),
``src/repro_torch/csrc/support.cu`` (the int8 route) and
``src/repro_torch/csrc/predict.cu`` (the int8 route) — at their path
shapes, and check each against its plain version.

    python3 tools/exact_variants.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Each variant is the shipped source with one change.  Similarity (pcc,
int8, one exact-fit launch: (6040, 3952) × (1024, 3952) of the ML-1M
surrogate, max_value 5): a four-stage ring, 64-byte K slices, 8 warps
on 128 × 64 (a 64 × 16 warp tile, one block an SM, 255 registers), 8
warps on 64 × 64 with two blocks an SM, and two diagnostics that cannot
ship: the values used as their own masks (the in-register mask work
skipped) and four products (the sq_a / sq_b products skipped).  Support
(int8 route, the approx recommend's 6040-user chunk, k 40 exact pcc
neighbors, I' 4096): without the fast path for w·0 = +0 (every element
through the general selects), four neighbors unrolled, 64 threads a
block, and the diagnostic that loads the neighbor rows and does no
arithmetic.  Tile predict (int8 route, k 40 exact pcc neighbors, one
whole-range launch [0, 3952) for the exact recommend's 1024-user block
and for a 32-user serving batch): two or eight neighbor rows in flight
(four shipped), eight warps a block, without the skip of unrated terms,
signed bytes read by one XOR a word in place of ``__vcmpgts4`` (the
shared header inlined and patched), and the diagnostic that loads the
neighbor rows and does no arithmetic.  Variants are built in parallel into
``src/repro_torch/build/variants/`` and timed in turns (forward, then
backward order, CUDA events); each prints its registers and spills, its
time and whether it equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from index_variants import bitwise, build, time_ms  # noqa: E402

SHAPE = ("  static constexpr int WM = SIX ? 4 : 2, WN = 4;\n"
         "  static constexpr int TM = SIX ? 2 : 4, TN = SIX ? 2 : 4;\n"
         "  static constexpr int NT = WM * WN * 32;\n"
         "  static constexpr int MIN_BLOCKS = SIX ? 1 : 2;")
SQ_MMA = ("              mma_us(acc[4][i][j], aq[i], bm[j][0], bm[j][1]);\n",
          "              mma_su(acc[5][i][j], am[i], bq[j][0], bq[j][1]);\n")

SIMILARITY = {
    "shipped: 16 warps on 128 x 64, 3 stages of 128 bytes": [],
    "four-stage ring": [("constexpr int STAGES = 3;",
                         "constexpr int STAGES = 4;")],
    "64-byte K slices": [("BK = PLANES == 2 ? 128 : 64;",
                          "BK = PLANES == 2 ? 64 : 64;")],
    "8 warps on 128 x 64 (64 x 16 warp tiles), one block an SM": [
        (SHAPE, SHAPE.replace("WM = SIX ? 4 : 2", "WM = 2")
         .replace("TM = SIX ? 2 : 4", "TM = 4"))],
    "8 warps on 64 x 64, two blocks an SM": [
        (SHAPE, SHAPE.replace("WM = SIX ? 4 : 2", "WM = 2")
         .replace("MIN_BLOCKS = SIX ? 1 : 2", "MIN_BLOCKS = 2"))],
    "diagnostic: values as masks (wrong)": [
        ("am[i][e] = mask4(av[i][e]);", "am[i][e] = av[i][e];"),
        ("bm[j][0] = mask4(bv[j][0]);", "bm[j][0] = bv[j][0];"),
        ("bm[j][1] = mask4(bv[j][1]);", "bm[j][1] = bv[j][1];")],
    "diagnostic: four products (wrong)": [(SQ_MMA[0], ""), (SQ_MMA[1], "")],
}
FAST = "      if (__float_as_uint(w0) == 0u) {   // block-uniform\n"
BODY = (FAST + "        neighbor<VEC, true>(v, src, c0, n_items, mu, w1, w0,"
        " w0, wj, num,\n                            den);\n      } else {\n"
        "        neighbor<VEC, false>(v, src, c0, n_items, mu, w1, w0, w0, "
        "wj, num,\n                             den);\n      }\n")
SUPPORT = {
    "shipped: 128 threads, 16 columns each, unroll 2": [],
    "no fast path for w·0 = +0": [(FAST, FAST.replace(
        "__float_as_uint(w0) == 0u", "false"))],
    "four neighbors unrolled": [("#pragma unroll 2\n    for (int j = 0; "
                                 "j < kc; ++j) {",
                                 "#pragma unroll 4\n    for (int j = 0; "
                                 "j < kc; ++j) {")],
    "64 threads a block": [("constexpr int BT8 = 2048;",
                            "constexpr int BT8 = 1024;")],
    "diagnostic: loads only (wrong)": [(BODY, (
        "      num[0] = __fadd_rn(num[0], __uint_as_float((v.x ^ v.y ^ v.z"
        " ^ v.w) & 1u));\n"))],
}


ROWS_H = (Path(__file__).resolve().parent.parent
          / "src/repro_torch/csrc/rating_rows.cuh").read_text()
INLINE_ROWS = ('#include "rating_rows.cuh"', ROWS_H)
SKIP = "        if ((zero >> (j + u)) & 1u) {             // warp-uniform\n"
PREDICT = {
    "shipped: 4 warps, 16 items a lane, 4 rows in flight": [],
    "2 rows in flight": [("constexpr int UNROLL = 4;",
                          "constexpr int UNROLL = 2;")],
    "8 rows in flight": [("constexpr int UNROLL = 4;",
                          "constexpr int UNROLL = 8;")],
    "8 warps a block": [("constexpr int WARPS = 4;",
                         "constexpr int WARPS = 8;")],
    "no skip of unrated terms": [(SKIP, SKIP.replace(
        "(zero >> (j + u)) & 1u", "false"))],
    "signed bytes by one XOR a word": [
        INLINE_ROWS,
        ("      const unsigned pw = wd[q] & __vcmpgts4(wd[q], 0u);",
         "      const unsigned pw = wd[q] ^ 0x80808080u;"),
        ("        const float x = byte_value(pw, b);",
         "        const float x = __fsub_rn(__uint_as_float(__byte_perm("
         "pw, 0x4B000000u, 0x7540 + b)), 8388736.f);")],
    "diagnostic: loads only (wrong)": [(
        "          neighbor<VEC, true>(v[u], p, c0, t_len, mu, wj, 0.f, 0.f,"
        " wj,\n                              num, den);",
        "          num[0] = __fadd_rn(num[0], __uint_as_float((v[u].x ^ "
        "v[u].y ^ v[u].z ^ v[u].w) & 1u));")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("exact_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels.similarity import similarity_plain
    from repro_torch.kernels.support import (support_scores_int8_plain,
                                             support_width)
    dev = "cuda"
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    sim = build("similarity", SIMILARITY)
    sup = build("support", SUPPORT)
    pre = build("predict", PREDICT)

    train, _, _ = load_ml1m_synthetic()
    r = torch.from_numpy(train).to(dev)
    r8 = r.to(torch.int8)
    m, d = r8.shape
    b8 = r8[:1024]
    n = b8.shape[0]
    want_sim = similarity_plain(r, r[:1024], measure="pcc")
    sq_a = torch.empty((1, m, d), dtype=torch.uint8, device=dev)
    sq_b = torch.empty((1, n, d), dtype=torch.uint8, device=dev)
    st_a = torch.empty((2, m), device=dev)
    st_b = torch.empty((2, n), device=dev)
    n_bad = torch.zeros(1, dtype=torch.int32, device=dev)

    def sim_call(lib):
        fn = lib.repro_similarity_imma
        fn.argtypes = [p_] * 9 + [i_] * 6 + [p_, f_, p_]
        fn.restype = i_
        out = torch.empty((m, n), device=dev)

        def call():
            status = fn(r8.data_ptr(), b8.data_ptr(), sq_a.data_ptr(),
                        sq_b.data_ptr(), st_a.data_ptr(), st_b.data_ptr(),
                        out.data_ptr(), 0, 0, m, n, d, 2, 0, 5,
                        n_bad.data_ptr(), 50.0, stream)
            assert status == 0, status
        return call, out

    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   device=dev).fit()
    ratings, scores, idx, means = eng.snapshot()
    safe = torch.where(idx >= 0, idx, 0).to(torch.int32).contiguous()
    w = torch.where((scores > 0) & (idx >= 0), scores,
                    torch.zeros_like(scores)).contiguous()
    means = means.contiguous()
    width = support_width(d)
    want_sup = support_scores_int8_plain(r8, means, safe, w, means)
    b, k = safe.shape

    def sup_call(lib):
        fn = lib.repro_support_scores_int8
        fn.argtypes = [p_, p_, i_, i_, i_, p_, p_, p_, p_, i_, i_, p_]
        fn.restype = i_
        out = torch.empty((b, width), device=dev)

        def call():
            status = fn(r8.data_ptr(), means.data_ptr(), m, d, width,
                        safe.data_ptr(), w.data_ptr(), means.data_ptr(),
                        out.data_ptr(), b, k, stream)
            assert status == 0, status
        return call, out

    from repro_torch.kernels.predict import tile_predict_plain
    src8 = ratings.to(torch.int8)

    def pred_call(lib, rows):
        fn = lib.repro_tile_predict
        fn.argtypes = [p_, i_, i_, i_] + [p_] * 5 + [i_] * 4 + [p_]
        fn.restype = i_
        ids = safe[:rows].contiguous()
        wr = w[:rows].contiguous()
        nbm = means[ids.long()].contiguous()
        qm = means[:rows].contiguous()
        out = torch.empty((rows, d), device=dev)
        want = tile_predict_plain(src8, ids, wr, nbm, qm, 0, d)

        def call():
            status = fn(src8.data_ptr(), 1, m, d, ids.data_ptr(),
                        wr.data_ptr(), nbm.data_ptr(), qm.data_ptr(),
                        out.data_ptr(), rows, k, 0, d, stream)
            assert status == 0, status
        return call, out, want

    cases = []   # (label, call, check)
    for name, (lib, regs) in sim.items():
        call, out = sim_call(lib)
        six = [x for x in regs if x.startswith("imma_kernelILi2ELb0E")]
        cases.append((f"similarity pcc {name} [{'; '.join(six)}]", call,
                      lambda out=out: bitwise(out, want_sim)))
    for name, (lib, regs) in sup.items():
        call, out = sup_call(lib)
        vec = [x for x in regs if "int8_kernelILb1E" in x]
        cases.append((f"support int8 {name} [{'; '.join(vec)}]", call,
                      lambda out=out: bitwise(out, want_sup)))
    for name, (lib, regs) in pre.items():
        vec = [x for x in regs if "int8_kernelILb1E" in x]
        for rows in (1024, 32):
            call, out, want = pred_call(lib, rows)
            cases.append((f"predict int8 m={rows} [0,{d}) {name} "
                          f"[{'; '.join(vec)}]", call,
                          lambda out=out, want=want: bitwise(out, want)))
    times = {label: [] for label, _, _ in cases}
    for order in (cases, cases[::-1]):
        for label, call, _ in order:
            times[label].append(time_ms(call))
    for label, call, check in cases:
        call()
        torch.cuda.synchronize()
        print(f"{label}: {times[label][0]:.4f} / {times[label][1]:.4f} ms, "
              f"bitwise {check()}", flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
