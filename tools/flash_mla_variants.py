"""Time kernel 8 (``csrc/flash_attention.cu``) and its backward 8b
(``csrc/flash_attention_bwd.cu``) at DeepSeek-V2's MLA heads (q·k 192,
v 128, bf16, causal) on their ``"mma"`` routes beside patched copies, and
check each against the plain versions.

    python3 tools/flash_mla_variants.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Forward, at the MLA prefill launch (B 4, H 128, S 2048): the shipped
``<192, 128>`` tile (Q's fragments reloaded from shared memory per key
tile), the same tile with them kept in registers (``QREG_MAX_DK`` 192),
and the tile before it existed (d padded to 256).  Backward, at
``chip_smoke.py``'s ``MLA_BWD_SHAPE`` (B 1, H 128, S 2048): the shipped
``<192, 128>`` kernels (32-row q tiles in dK/dV, Q restaged in dQ),
16-row q tiles in dK/dV, Q's fragments kept in registers in dQ, and the
``"simt"`` route bf16 took at this width before (the last two copies
are ``chip_smoke.py``'s ``PREVIOUS_MLA_DESIGN``).  Copies are built in
parallel (``_build.build_variants``) and timed in turns (forward, then
backward order, CUDA events); each prints ptxas's registers and spill
bytes of its 192-wide instantiations, its time and whether its outputs
on four shapes
(the timed one, ragged S 77, d 160 with dv 128, Sq ≠ Skv with group 2)
are within one bf16 ulp + 1e-5 of the plain forward (forward) or 1e-2 of
the largest |gradient| of the plain backward on f32 copies (backward).
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import PREVIOUS_MLA_DESIGN  # noqa: E402

FWD = "flash_attention"
BWD = "flash_attention_bwd"
VARIANTS = {
    "fwd: Q in registers": (FWD, [(
        "constexpr int QREG_MAX_DK = 128;",
        "constexpr int QREG_MAX_DK = 192;")]),
    "bwd: dK/dV 16-row q tiles": (BWD, [(
        "return dk <= 64 && dv <= 64 ? 64 : 32;",
        "return dk <= 64 && dv <= 64 ? 64 : dk <= 128 ? 32 : 16;")]),
    "bwd: dQ with Q in registers": (BWD, [(
        "constexpr bool QREG = DK <= 128;",
        "constexpr bool QREG = DK <= 192;")]),
    **{f"before: {label}": patch
       for label, patch in PREVIOUS_MLA_DESIGN.items()},
}


def timed(fn, reps):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_mla_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    _build.build([FWD, BWD])
    libs = {"fwd: shipped": (FWD, _build.library_path(FWD)),
            "bwd: shipped": (BWD, _build.library_path(BWD))}
    libs.update({label: (VARIANTS[label][0], path) for label, path in
                 _build.build_variants(VARIANTS).items()})
    for label, (name, path) in libs.items():
        log = path.with_suffix(".log").read_text()
        regs = [(fn, r, spill) for fn, r, spill in _build.ptxas_report(log)
                if "ILi192E" in fn or ("ILi256ELi128E" in fn and
                                       name == FWD)]
        print(f"{label}: ptxas (entry, registers, spill bytes) {regs}")

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(33)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    scale = 1.0 / 192 ** 0.5
    fq, fk, fv = rnd(4, 128, 2048, 192), rnd(4, 128, 2048, 192), \
        rnd(4, 128, 2048, 128)
    bq, bk, bv = rnd(1, 128, 2048, 192), rnd(1, 128, 2048, 192), \
        rnd(1, 128, 2048, 128)
    small = [(rnd(2, 4, 77, 192), rnd(2, 4, 77, 192), rnd(2, 4, 77, 128)),
             (rnd(1, 4, 60, 160), rnd(1, 4, 60, 160), rnd(1, 4, 60, 128)),
             (rnd(1, 8, 50, 192), rnd(1, 4, 130, 192), rnd(1, 4, 130, 128))]
    fwd_cases = [(fq, fk, fv)] + small
    fwd_want = [fa.flash_attention_plain(*(t.float() for t in c),
                                         scale=scale).bfloat16().float()
                for c in fwd_cases]
    with _build.swapped(FWD, libs["fwd: shipped"][1]):
        bwd_cases = []
        for c in [(bq, bk, bv)] + small:
            o, lse = fa.flash_attention(*c, scale=scale, return_lse=True)
            do = rnd(*o.shape)
            want = fa.flash_attention_bwd_plain(
                *(t.float() for t in (*c, o, do)), scale=scale)
            bwd_cases.append(((*c, o, do, lse), want))
    bargs = bwd_cases[0][0]

    def fwd_ok():
        for c, want in zip(fwd_cases, fwd_want):
            x = fa.flash_attention(*c, scale=scale).float()
            ulp = 2.0 ** -7 * torch.maximum(x.abs(), want.abs()) + 1e-5
            if not bool(((x - want).abs() <= ulp).all()):
                return False
        return True

    def bwd_err():
        worst = 0.0
        for args, want in bwd_cases:
            got = fa.flash_attention_bwd(*args, scale=scale)
            again = fa.flash_attention_bwd(*args, scale=scale)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                return float("inf")
            for g, w in zip(got, want):
                worst = max(worst, float((g.float() - w).abs().max())
                            / max(1.0, float(w.abs().max())))
        return worst

    names = list(libs)
    for order in (names, names[::-1]):
        for label in order:
            name, path = libs[label]
            with _build.swapped(name, path):
                if name == FWD:
                    ms = timed(lambda: fa.flash_attention(
                        fq, fk, fv, scale=scale), reps=10)
                    print(f"{label:34s} forward {ms:.4f} ms at B=4 H=128 "
                          f"S=2048, every case within one bf16 ulp: "
                          f"{fwd_ok()}")
                else:
                    ms = timed(lambda: fa.flash_attention_bwd(
                        *bargs, scale=scale), reps=3)
                    print(f"{label:34s} backward {ms:.4f} ms at B=1 H=128 "
                          f"S=2048, max error / largest |grad| "
                          f"{bwd_err()!r} (two calls bitwise)")
    sdpa = timed(lambda: F.scaled_dot_product_attention(
        fq, fk, fv, is_causal=True, scale=scale), reps=10)
    ql, kl, vl = (t.detach().requires_grad_() for t in (bq, bk, bv))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                         scale=scale)
    sdpa_bwd = timed(lambda: torch.autograd.grad(
        out, (ql, kl, vl), bargs[4], retain_graph=True), reps=3)
    print(f"scaled_dot_product_attention forward {sdpa:.4f} ms, backward "
          f"{sdpa_bwd:.4f} ms; {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
