"""Time kernels 8 and 5 of the PyTorch/CUDA port at their path shapes on
seeded random inputs, beside their library yardsticks.

    python3 tools/kernel_times.py

Run from the repository root on a machine with a CUDA card.  Prints one
line each: the flash-attention prefill launch (Llama-3.2-1B's layer
shape: B 4, Hq 32, Hkv 8, S 2048, d 64, bf16, causal) against
``scaled_dot_product_attention``; its decode launch (Sq 1 against 2049
of 2080 cached keys); each launch's max abs diff from the plain version;
and ``select_topm`` at the cluster query's shape (Q 256, L 8192, m 906)
and the item index's (Q 6040, L 3952, m 512) against ``torch.topk``,
with its plain version (ids and values must be equal).  Times are CUDA
events over back-to-back calls, the host's enqueue included.
"""

from __future__ import annotations

import importlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels.select import select_topm, select_topm_twin
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    b, hq, hkv, s, d = 4, 32, 8, 2048, 64
    q = rnd(b, s, hq, d).transpose(1, 2)
    k = rnd(b, s, hkv, d).transpose(1, 2)
    v = rnd(b, s, hkv, d).transpose(1, 2)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float())
    print(f"prefill ms {time_ms(lambda: fa.flash_attention(q, k, v))!r} "
          f"sdpa {time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))!r} "
          f"diff {float((got.float() - want.bfloat16().float()).abs().max())!r} "
          f"routes {fa.flash_attention.routes}")
    kc, vc = rnd(b, hkv, 2080, d), rnd(b, hkv, 2080, d)
    qd = rnd(b, hq, 1, d)
    kv_len = torch.full((b,), 2049, dtype=torch.int32, device=dev)
    got = fa.flash_attention(qd, kc, vc, kv_len=kv_len)
    want = fa.flash_attention_plain(qd.float(), kc.float(), vc.float(),
                                    kv_len=kv_len)
    print(f"decode ms {time_ms(lambda: fa.flash_attention(qd, kc, vc, kv_len=kv_len), 100)!r} "
          f"sdpa {time_ms(lambda: F.scaled_dot_product_attention(qd, kc[:, :, :2049], vc[:, :, :2049], enable_gqa=True), 100)!r} "
          f"diff {float((got.float() - want.bfloat16().float()).abs().max())!r} "
          f"routes {fa.flash_attention.routes}")
    rng = np.random.default_rng(0)
    for n_q, n, m in ((256, 8192, 906), (6040, 3952, 512)):
        sc = torch.from_numpy((rng.normal(size=(n_q, n)) / 8).astype(
            np.float32)).to(dev)
        sc[:, n - n // 7:] = float("-inf")
        none = torch.full((n_q,), -1, dtype=torch.int32, device=dev)
        a, w = select_topm(sc, none, m=m), select_topm_twin(sc, none, m=m)
        same = torch.equal(a[1], w[1]) and torch.equal(a[0], w[0])
        print(f"select Q={n_q} L={n} m={m} equal {same} ms "
              f"{time_ms(lambda: select_topm(sc, none, m=m))!r} topk "
              f"{time_ms(lambda: torch.topk(sc, m))!r} plain "
              f"{time_ms(lambda: select_topm_twin(sc, none, m=m), 5)!r}")
        if not same:
            return 1
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
