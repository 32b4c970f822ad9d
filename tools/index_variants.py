"""Time patched copies of the approximate index's kernels 6, 4 and 3 —
``src/repro_torch/csrc/rerank.cu`` (the int8 pcc route),
``src/repro_torch/csrc/select.cu`` (the scan's score launch and the radix
select) and ``src/repro_torch/csrc/cluster.cu`` (centroid distances) — at
the approx path's block shapes, and check each against its plain
version.

    python3 tools/index_variants.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Each variant is the shipped source with one change.  Rerank (pcc, int8,
one 2048-query block × 6041 union columns × 3952 items of the ML-1M
surrogate): 8 warps on 64 × 64 with one or two blocks an SM (the shipped
pcc tile is 16 warps on 128 × 64), a four-stage ring, and two
diagnostics that cannot ship: no square planes (the per-stage transform
skipped) and four products (the sq_a / sq_b products skipped); the
shipped cosine instantiation at the same shape as a one-product
reference.  Scores (Q 2048, N 6040, P 256, seeded unit rows): two blocks
an SM (128 registers) and the diagnostic FMA (not the pinned order).
Select over those scores (m 906): the diagnostic without the final
bitonic sort.  Centroid distances (seeded unit rows, (6040, 256) × (78,
256) and the U = 32768 index's (2048, 512) × (182, 512)): register tiles
of 2 × 8, 1 × 8, 2 × 4 and 4 × 8 outputs a thread (4 × 4 shipped), the
full stages' loop not unrolled, 16-feature stages, plain staging in
place of ``cp.async``, and the diagnostics without the norms, without
the staging (the stages' loads dropped) and without the cross term.
Variants are built in parallel into
``src/repro_torch/build/variants/`` and timed in turns (forward, then
backward order, CUDA events); each prints its registers and spills, its
time and whether it equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PCC_SHAPE = ("  static constexpr int WM = SIX ? 4 : 2, WN = 4;",
             "  static constexpr int MIN_BLOCKS = SIX ? 1 : 2;")
TRANSFORM = "      for (int w = tid; w < (BM + BN) * (BK / 4); w += NT) {"
SQ_MMA = ("              mma_us(acc[4][m][n], aq[m], bm[n][0], bm[n][1]);\n",
          "              mma_su(acc[5][m][n], am[m], bq[n][0], bq[n][1]);\n")
SCORE_BOUNDS = "__global__ void __launch_bounds__(NT, 1)\nproxy_scores_kernel("
FMA = [(f"          s = __fadd_rn(s, __fmul_rn(a.{c}, b[jj].{c}));",
        f"          s = fmaf(a.{c}, b[jj].{c}, s);") for c in "xyzw"]
SORT = "  for (int size = 2; size <= len; size <<= 1) {"

RERANK = {
    "shipped: 16 warps on 128 x 64": [],
    "8 warps on 64 x 64, one block an SM": [
        (PCC_SHAPE[0], "  static constexpr int WM = 2, WN = 4;")],
    "8 warps on 64 x 64, two blocks an SM": [
        (PCC_SHAPE[0], "  static constexpr int WM = 2, WN = 4;"),
        (PCC_SHAPE[1], "  static constexpr int MIN_BLOCKS = 2;")],
    "four-stage ring": [("constexpr int STAGES = 3;",
                         "constexpr int STAGES = 4;")],
    "diagnostic: no square planes (wrong)": [
        (TRANSFORM, TRANSFORM.replace("w < (BM + BN) * (BK / 4)", "w < 0"))],
    "diagnostic: four products (wrong)": [(SQ_MMA[0], ""), (SQ_MMA[1], "")],
}
SELECT = {
    "shipped": [],
    "scores with two blocks an SM": [
        (SCORE_BOUNDS, SCORE_BOUNDS.replace("(NT, 1)", "(NT, 2)"))],
    "diagnostic: scores with FMA (wrong order)": FMA,
    "diagnostic: select without its final sort (wrong order)": [
        (SORT, SORT.replace("size <= len", "size <= 0"))],
}


TILE = "constexpr int TM = 4, TN = 4;"
FULL_STAGE = ("    if (kend == BK) {   // a full stage, unrolled: loads "
              "hoisted ahead")
CROSS = ("      for (int f = 0; f < BK; f += 4) step(f);",
         "      for (int f = 0; f < kend; f += 4) step(f);")
NORMS = ("    for (int e = tid; e < n_norm; e += nthreads) {\n"
         "      const float* p")
CLUSTER = {
    "shipped: 4 x 4 a thread, 32-feature stages unrolled, cp.async": [],
    "2 x 8 a thread": [(TILE, TILE.replace("4, TN = 4", "2, TN = 8"))],
    "1 x 8 a thread": [(TILE, TILE.replace("4, TN = 4", "1, TN = 8"))],
    "2 x 4 a thread": [(TILE, TILE.replace("4, TN = 4", "2, TN = 4"))],
    "4 x 8 a thread": [(TILE, TILE.replace("4, TN = 4", "4, TN = 8"))],
    "stages not unrolled": [(FULL_STAGE, "    if (false) {")],
    "16-feature stages": [("constexpr int BK = 32;",
                           "constexpr int BK = 16;")],
    "plain staging (no cp.async)": [("const bool vec = d % 4 == 0 &&",
                                     "const bool vec = false &&")],
    "diagnostic: no norms (wrong)": [(NORMS, NORMS.replace(
        "e < n_norm;", "e < 0;"))],
    "diagnostic: no staging (wrong)": [
        ("  if (n_stages) load(0, 0);", ""),
        ("      load(s + 1, (s + 1) & 1);\n", "")],
    "diagnostic: no cross term (wrong)": [(CROSS[0], ""), (CROSS[1], "")],
}


def build(kind: str, variants: dict) -> dict:
    """Compile each variant of csrc/<kind>.cu (the shared csrc/*.cuh
    headers on the include path); returns name → (library, ptxas lines of
    its entry functions)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{kind}.cu").read_text()
    out_dir = ROOT / "src/repro_torch/build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{kind} variant {name!r}: patch target "
                                   f"not found: {old[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{kind}_{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"{kind}_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {name!r}:\n{log}")
        regs = [f"{fn}: {used} regs, {spill} B spilled"
                for fn, used, spill in _build.ptxas_report(log)]
        built[name] = (ctypes.CDLL(str(lib)), regs)
    return built


def time_ms(fn, reps: int = 20) -> float:
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


def bitwise(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main() -> int:
    if not torch.cuda.is_available():
        print("index_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels.ref import proxy_scores_ref
    from repro_torch.kernels.rerank import rerank_scores_plain
    from repro_torch.kernels.select import select_topm_twin
    dev = "cuda"
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    rr = build("rerank", RERANK)
    sel = build("select", SELECT)
    cl = build("cluster", CLUSTER)

    train, _, _ = load_ml1m_synthetic()
    r8 = torch.from_numpy(train).to(dev).to(torch.int8)
    n, j = r8.shape
    cols = torch.arange(n + 1, device=dev).clamp_max(n - 1)  # + sentinel
    q8, c8 = r8[:2048].contiguous(), r8[cols].contiguous()
    cf = c8.float()
    cn = torch.sqrt((cf.double() ** 2).sum(1)).float()
    cc = (cf > 0).sum(1).float()
    g, kc = q8.shape[0], c8.shape[0]
    want = {m: rerank_scores_plain(q8, c8, cn, cc, measure=m)
            for m in ("pcc", "cosine")}

    def rerank_call(lib, measure):
        fn = lib.repro_rerank_scores
        fn.argtypes = [p_] * 5 + [i_] * 6 + [ctypes.c_float, p_]
        fn.restype = i_
        out = torch.empty((g, kc), device=dev)
        code = {"cosine": 1, "pcc": 2}[measure]

        def call():
            status = fn(q8.data_ptr(), c8.data_ptr(), cn.data_ptr(),
                        cc.data_ptr(), out.data_ptr(), g, kc, j, 1, 1, code,
                        50.0, stream)
            assert status == 0, status
        return call, out

    rng = np.random.default_rng(0)
    x = rng.normal(size=(6040, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    pool = torch.from_numpy(x).to(dev)
    q = pool[:2048].contiguous()
    ids = torch.arange(2048, dtype=torch.int32, device=dev)
    s_want = proxy_scores_ref(q, pool)
    t_want = select_topm_twin(s_want, ids, m=906)

    def score_call(lib):
        fn = lib.repro_proxy_scores
        fn.argtypes = [p_] * 3 + [i_] * 3 + [p_]
        fn.restype = i_
        out = torch.empty((2048, 6040), device=dev)
        return (lambda: fn(q.data_ptr(), pool.data_ptr(), out.data_ptr(),
                           2048, 6040, 256, stream)), out

    def select_call(lib):
        fn = lib.repro_select_topm
        fn.argtypes = [p_] * 4 + [i_] * 3 + [p_]
        fn.restype = i_
        v = torch.empty((2048, 906), device=dev)
        i = torch.empty((2048, 906), dtype=torch.int32, device=dev)
        return (lambda: fn(s_want.data_ptr(), ids.data_ptr(), v.data_ptr(),
                           i.data_ptr(), 2048, 6040, 906, stream)), (v, i)

    cases = []   # (label, call, check)
    for name, (lib, regs) in rr.items():
        call, out = rerank_call(lib, "pcc")
        pcc_regs = [r for r in regs if r.startswith("imma_kernelILi2E")]
        cases.append((f"rerank pcc   {name} [{'; '.join(pcc_regs)}]", call,
                      lambda out=out: bitwise(out, want["pcc"])))
    call, out = rerank_call(rr["shipped: 16 warps on 128 x 64"][0], "cosine")
    cases.append(("rerank cosine shipped (one product)", call,
                  lambda out=out: bitwise(out, want["cosine"])))
    for name, (lib, regs) in sel.items():
        score_regs = [r for r in regs if r.startswith("proxy_scores")]
        call, out = score_call(lib)
        cases.append((f"scores       {name} [{'; '.join(score_regs)}]", call,
                      lambda out=out: bitwise(out, s_want)))
        call, (v, i) = select_call(lib)
        cases.append((f"select m=906 {name}", call,
                      lambda v=v, i=i: torch.equal(i, t_want[1])
                      and bitwise(v, t_want[0])))
    from repro_torch.kernels.cluster import centroid_distances_plain
    shapes = []
    for dm, dn, dd in ((6040, 78, 256), (2048, 182, 512)):
        a, b = (rng.normal(size=(rows, dd)).astype(np.float32)
                for rows in (dm, dn))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        xa, cb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        shapes.append((xa, cb, centroid_distances_plain(xa, cb)))

    def dist_call(lib, xa, cb):
        fn = lib.repro_centroid_distances
        fn.argtypes = [p_] * 3 + [i_] * 3 + [p_]
        fn.restype = i_
        out = torch.empty((xa.shape[0], cb.shape[0]), device=dev)

        def call():
            status = fn(xa.data_ptr(), cb.data_ptr(), out.data_ptr(),
                        xa.shape[0], cb.shape[0], xa.shape[1], stream)
            assert status == 0, status
        return call, out

    for name, (lib, regs) in cl.items():
        vec = [r for r in regs if r.startswith("dist_kernelILb1E")]
        for xa, cb, want_d in shapes:
            call, out = dist_call(lib, xa, cb)
            cases.append((f"distances {tuple(xa.shape)}x{tuple(cb.shape)} "
                          f"{name} [{'; '.join(vec)}]", call,
                          lambda out=out, want_d=want_d: bitwise(out,
                                                                 want_d)))
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
