"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the repository root; it puts ``src`` on ``sys.path`` itself,
imports nothing of ``jax`` or the reference package ``repro``, and builds
the CUDA kernels from ``src/repro_torch/csrc`` at first use (one ``nvcc``
per source, in parallel).  Phases, each ended by a device synchronize:

1. environment — card name and power limit, torch/CUDA versions, build;
2. each kernel against its plain PyTorch version on the card, at ragged
   shapes and at the main path's shapes (max abs diff ≤ 1e-6 required);
3. the main path at the paper's size (ML-1M surrogate, 6040 × 3952,
   pcc, k = 40): ``CFEngine(backend="kernel")`` fit → predict / MAE →
   ``recommend`` → ``update_ratings`` (oracle-checked) → a
   ``BatchingServer`` answering 512 requests; the kernels' launch counts
   are zeroed just before and read just after, and must be > 0.  Then the
   sequential backend (plain torch) must give the same neighbor and item
   ids, and a small input must agree between the CPU path and the card;
4. each kernel's time against its plain version, a library yardstick
   and its bound, at the main path's shapes (CUDA events);
5. ``torch.profiler``: where the device time of a steady fit and of
   recommend(all users) goes, and the device's busy share.

Then one ``{"kernels": [...]}`` line with times, bounds and launch counts.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero with no ``ok`` line; without a CUDA
card it exits 2 before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (dense): HBM bandwidth and f32 on the CUDA
# cores — both kernels run f32 arithmetic outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
TOL = 1e-6
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip smoke check failed: {what}")


def max_diff(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def int_ratings(rng, u, d, density=0.05):
    return torch.from_numpy((rng.integers(1, 6, (u, d))
                             * (rng.random((u, d)) < density))
                            .astype(np.float32))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(dev, rng, train_dev):
    """Phase 2: each kernel against its plain version on the card."""
    from repro_torch.core import predict as pr
    from repro_torch.kernels.predict import (fused_tile_predict,
                                             tile_predict_plain)
    from repro_torch.kernels.similarity import (fused_similarity,
                                                similarity_plain)
    err = {"similarity": 0.0, "predict": 0.0}
    shapes = [((257, 3952), (131, 3952)), ((1, 17), (33, 17))]
    for (m, d), (n, _) in shapes:
        ra = int_ratings(rng, m, d, 0.3).to(dev)
        rb = int_ratings(rng, n, d, 0.3).to(dev)
        for measure in ("jaccard", "cosine", "pcc", "pcc_sig", "all"):
            e = max_diff(fused_similarity(ra, rb, measure=measure),
                         similarity_plain(ra, rb, measure=measure))
            err["similarity"] = max(err["similarity"], e)
            log(f"  similarity {measure:8s} ({m},{d})x({n},{d}) "
                f"max_abs_diff={e!r}")
            check(e <= TOL, f"similarity {measure} ({m},{n},{d}) diff {e}")
    block = train_dev[:1024].contiguous()
    for measure in ("jaccard", "cosine", "pcc", "pcc_sig", "all"):
        e = max_diff(fused_similarity(train_dev, block, measure=measure),
                     similarity_plain(train_dev, block, measure=measure))
        err["similarity"] = max(err["similarity"], e)
        log(f"  similarity {measure:8s} {tuple(train_dev.shape)}x"
            f"{tuple(block.shape)} max_abs_diff={e!r}")
        check(e <= TOL, f"similarity {measure} full-size diff {e}")
        torch.cuda.synchronize()

    src = pr.make_gather_source(train_dev)
    means = pr.user_means(train_dev)
    n_users, n_items = train_dev.shape
    for k in (1, 7, 40):
        m = 300
        ids = torch.from_numpy(rng.integers(0, n_users, (m, k))
                               .astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.random((m, k)).astype(np.float32)).to(dev)
        w[::3, -1] = 0.0               # empty (-1) slots: id 0, weight 0
        ids[::3, -1] = 0
        nbm = means[ids.long()].contiguous()
        qm = means[:m].contiguous()
        for s in (src, train_dev):
            # a full tile, the ragged last tile, an unaligned range
            for lo, hi in ((0, min(512, n_items)),
                           (n_items - n_items % 512 or n_items - 368,
                            n_items),
                           (min(100, n_items - 1), min(1333, n_items))):
                e = max_diff(fused_tile_predict(s, ids, w, nbm, qm, lo, hi),
                             tile_predict_plain(s, ids, w, nbm, qm, lo, hi))
                err["predict"] = max(err["predict"], e)
                check(e <= TOL, f"tile predict k={k} [{lo},{hi}) diff {e}")
        log(f"  tile_predict k={k:2d} int8+f32 sources, 3 item ranges "
            f"max_abs_diff={err['predict']!r}")
    torch.cuda.synchronize()
    return err


def phase_main_path(dev, train, test):
    """Phase 3: the port's main path through its public entry points."""
    from repro_torch.core import metrics
    from repro_torch.core.facade import CFEngine
    from repro_torch.kernels.predict import fused_tile_predict
    from repro_torch.kernels.similarity import fused_similarity
    from repro_torch.serving.engine import BatchingServer

    out = {}
    fused_similarity.launches = 0
    fused_tile_predict.launches = 0
    t0 = time.perf_counter()
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   device=dev).fit()
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    fit_idx, fit_scores = eng.idx.clone(), eng.scores.clone()

    t0 = time.perf_counter()
    pred = eng.predict()
    mae = float(metrics.mae(pred, torch.from_numpy(test).to(dev)))
    out["predict_s"] = time.perf_counter() - t0
    out["mae"] = mae
    check(tuple(pred.shape) == tuple(train.shape), "predict shape")
    check(bool(torch.isfinite(pred).all()), "finite predictions")
    check(0.3 < mae < 1.5, f"held-out MAE {mae} out of range")
    del pred

    t0 = time.perf_counter()
    rec_s, rec_i = eng.recommend(n=10)
    torch.cuda.synchronize()
    out["recommend_s"] = time.perf_counter() - t0
    check(tuple(rec_i.shape) == (train.shape[0], 10), "recommend shape")
    seen = eng.ratings > 0
    rows = torch.arange(train.shape[0], device=dev)[:, None]
    valid = rec_i >= 0
    check(not bool((seen[rows, rec_i.long().clamp_min(0)] & valid).any()),
          "recommend returned an already-rated item")

    rng = np.random.default_rng(5)
    users = rng.choice(train.shape[0], 16, replace=False)
    uids = np.repeat(users, 4).astype(np.int32)
    iids = rng.integers(0, train.shape[1], uids.size).astype(np.int32)
    vals = rng.integers(0, 6, uids.size).astype(np.float32)
    t0 = time.perf_counter()
    st = eng.update_ratings(uids, iids, vals, oracle_check=True)
    out["update_s"] = time.perf_counter() - t0
    check(st.oracle_ok is True, "update_ratings oracle")

    server = BatchingServer(eng, max_batch=32, topn=10, device=dev)
    server.start()
    req = np.random.default_rng(0).integers(0, train.shape[0], 512)
    t0 = time.perf_counter()
    futs = [server.submit(int(u)) for u in req]
    res = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    server.stop()
    check(all(f.done() for f in futs) and len(res) == 512,
          "every served future resolves")
    _, want = eng.recommend(req, n=10)
    want = want.cpu().numpy()
    for r, u, w in zip(res, req, want):
        check(r.user == int(u) and np.array_equal(r.items, w),
              f"served answer for user {u} equals engine.recommend")
    stats = server.stats()
    out.update(serve_req_per_s=512 / wall, p50_ms=stats["latency_p50_ms"],
               p99_ms=stats["latency_p99_ms"], batches=stats["n_batches"])
    torch.cuda.synchronize()
    out["launches"] = {"similarity": fused_similarity.launches,
                       "predict": fused_tile_predict.launches}
    check(out["launches"]["similarity"] > 0, "similarity kernel launched")
    check(out["launches"]["predict"] > 0, "tile predict kernel launched")

    # the sequential backend (plain torch.matmul path) on the same input
    seq = CFEngine(train, measure="pcc", k=40, backend="sequential",
                   device=dev).fit()
    check(torch.equal(seq.idx, fit_idx), "kernel vs sequential neighbor ids")
    check(torch.equal(seq.scores, fit_scores),
          "kernel vs sequential neighbor scores")
    check(torch.equal(seq.recommend(n=10)[1], rec_i),
          "kernel vs sequential top-n item ids")
    torch.cuda.synchronize()
    return out, eng


def phase_small_cross_check(dev):
    """A small input through the CPU plain path and the card's kernels."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    small, _, _ = load_ml1m_synthetic(n_users=384, n_items=300, seed=0)
    cpu = CFEngine(small, k=10, block_size=128, device="cpu").fit()
    gpu = CFEngine(small, k=10, block_size=128, device=dev).fit()
    check(torch.equal(cpu.idx, gpu.idx.cpu()), "CPU vs card neighbor ids")
    e = max_diff(cpu.scores, gpu.scores.cpu())
    check(e <= TOL, f"CPU vs card neighbor scores diff {e}")
    check(torch.equal(cpu.recommend(n=10)[1], gpu.recommend(n=10)[1].cpu()),
          "CPU vs card top-n ids")
    return e


def phase_timings(dev, eng, err, launches):
    """Phase 4: kernel vs plain vs library at the main path's shapes."""
    from repro_torch.core import predict as pr
    from repro_torch.kernels.predict import (fused_tile_predict,
                                             tile_predict_plain)
    from repro_torch.kernels.similarity import (fused_similarity,
                                                similarity_plain)
    ratings, scores, idx, means = eng.snapshot()
    u, d = ratings.shape
    block = ratings[:1024].contiguous()
    n = block.shape[0]
    sim_ms = time_ms(lambda: fused_similarity(ratings, block,
                                              measure="pcc"))
    sim_plain = time_ms(lambda: similarity_plain(ratings, block,
                                                 measure="pcc"))
    ma, mb = (ratings > 0).float(), (block > 0).float()
    ops = [(ma, mb.T), (ratings, block.T), (ratings, mb.T), (ma, block.T),
           (ratings * ratings, mb.T), (ma, (block * block).T)]
    ops = [(a.contiguous(), b.contiguous()) for a, b in ops]
    sim_lib = time_ms(lambda: [torch.matmul(a, b) for a, b in ops])
    e = max_diff(fused_similarity(ratings, block, measure="pcc"),
                 similarity_plain(ratings, block, measure="pcc"))
    check(e <= TOL, f"similarity at timing shape diff {e}")
    sim_bound, sim_by = bound_ms((u * d + n * d + u * n) * 4.0,
                                 12.0 * u * n * d)

    # the recommend tile: 1024 users × k=40 neighbors × 512 items, int8
    m, lo, hi = 1024, 0, 512
    src = pr.make_gather_source(ratings)
    ids = torch.where(idx[:m] >= 0, idx[:m], 0).to(torch.int32).contiguous()
    w = torch.where((scores[:m] > 0) & (idx[:m] >= 0), scores[:m],
                    torch.zeros_like(scores[:m])).contiguous()
    nbm = means[ids.long()].contiguous()
    qm = means[:m].contiguous()
    k = ids.shape[1]
    pred_ms = time_ms(lambda: fused_tile_predict(src, ids, w, nbm, qm, lo,
                                                 hi), reps=50)
    pred_plain = time_ms(lambda: tile_predict_plain(src, ids, w, nbm, qm,
                                                    lo, hi), reps=10)
    e2 = max_diff(fused_tile_predict(src, ids, w, nbm, qm, lo, hi),
                  tile_predict_plain(src, ids, w, nbm, qm, lo, hi))
    check(e2 <= TOL, f"tile predict at timing shape diff {e2}")
    rows_read = int(torch.unique(ids).numel())
    pred_bytes = rows_read * (hi - lo) * 1 + m * k * 4 * 3 + m * 4 \
        + m * (hi - lo) * 4
    pred_bound, pred_by = bound_ms(pred_bytes, 6.0 * m * k * (hi - lo))
    torch.cuda.synchronize()
    return [
        {"name": "fused_similarity", "route": "cuda",
         "source": "src/repro_torch/csrc/similarity.cu",
         "replaces": "src/repro/kernels/similarity.py:110",
         "launches": launches["similarity"],
         "max_abs_err": max(err["similarity"], e), "ms": sim_ms,
         "plain_ms": sim_plain, "bound_ms": sim_bound, "bound_by": sim_by,
         "library_ms": sim_lib,
         "shape": f"({u},{d})x({n},{d}) pcc"},
        {"name": "fused_tile_predict", "route": "cuda",
         "source": "src/repro_torch/csrc/predict.cu",
         "replaces": "src/repro/kernels/predict.py:55",
         "launches": launches["predict"],
         "max_abs_err": max(err["predict"], e2), "ms": pred_ms,
         "plain_ms": pred_plain, "bound_ms": pred_bound,
         "bound_by": pred_by, "library_ms": None,
         "shape": f"m={m} k={k} items[{lo},{hi}) int8 src {u}x{d}, "
                  f"{rows_read} distinct neighbor rows"},
    ]


def phase_profile(eng) -> None:
    """Phase 5: where the device time of a steady fit and of
    recommend(all users) goes (device-side events only: kernels and
    copies, so no operator's time is counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, fn in (("fit", eng.fit),
                     ("recommend", lambda: eng.recommend(n=10))):
        fn()                                       # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy_ms = sum(r[0] for r in rows)
        check(busy_ms > 0, f"profiler saw device work in {name}")
        log(f"    {name}: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
        for ms, n, key in rows[:6]:
            log(f"      {ms:9.3f} ms  x{n:<4d} {key[:72]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels import _build

    dev = torch.device(DEVICE)
    card = nvidia_smi()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_kernel = _build.build()
    build_s = time.perf_counter() - t0
    log(f"    kernel build {build_s:.2f}s (parallel nvcc: "
        f"{ {k: round(v, 2) for k, v in per_kernel.items()} })")
    for name in _build.KERNELS:
        report = _build.library_path(name).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    train, test, spec = load_ml1m_synthetic()
    log(f"    data: ML-1M surrogate {train.shape}, "
        f"{int((train > 0).sum())} training ratings, "
        f"{int((test > 0).sum())} held out ({time.perf_counter() - t0:.1f}s)")
    train_dev = torch.from_numpy(train).to(dev)

    log("[2] kernels vs plain versions on the card")
    err = phase_kernels(dev, np.random.default_rng(0), train_dev)
    log(f"    ok: max_abs_diff similarity={err['similarity']!r} "
        f"predict={err['predict']!r} (tolerance {TOL})")

    log("[3] main path: CFEngine(kernel) fit -> recommend -> update -> serve")
    torch.cuda.reset_peak_memory_stats()
    main_out, eng = phase_main_path(dev, train, test)
    log(f"    fit {main_out['fit_s']:.3f}s, predict+MAE "
        f"{main_out['predict_s']:.3f}s, recommend(all, n=10) "
        f"{main_out['recommend_s']:.3f}s, update(16 users, oracle) "
        f"{main_out['update_s']:.3f}s")
    log(f"    serving: 512 requests, {main_out['serve_req_per_s']:.1f} req/s, "
        f"p50 {main_out['p50_ms']:.2f} ms, p99 {main_out['p99_ms']:.2f} ms, "
        f"{main_out['batches']} batches")
    log(f"    launches on the main path: {main_out['launches']}")
    log(f"    held-out MAE {main_out['mae']!r}; kernel backend == "
        f"sequential backend (ids, scores, top-n) at "
        f"{train.shape[0]}x{train.shape[1]}")
    log(f"    peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    small_e = phase_small_cross_check(dev)
    log(f"    small input (384x300): CPU plain path == card kernels "
        f"(ids equal, score diff {small_e!r})")

    log("[4] kernel timings at the main path's shapes (CUDA events)")
    kernels = phase_timings(dev, eng, err, main_out["launches"])
    for k in kernels:
        log(f"    {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}) at {k['shape']}")
    log("[5] torch.profiler: device time of a steady fit / recommend")
    phase_profile(eng)
    check(all(math.isfinite(k["ms"]) for k in kernels), "finite timings")
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
