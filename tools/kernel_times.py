"""Time kernels 8, 5, 4, 6, 1, 7, 2, 3 and 9 of the PyTorch/CUDA port at
their path shapes on seeded inputs, beside their library yardsticks.

    python3 tools/kernel_times.py [--src DIR]
        [--only index|exact|support|predict|cluster|bag|flash_bwd]...

Run from the repository root on a machine with a CUDA card.  Prints one
line each: the flash-attention prefill launch (Llama-3.2-1B's layer
shape: B 4, Hq 32, Hkv 8, S 2048, d 64, bf16, causal) against
``scaled_dot_product_attention``; its decode launch (Sq 1 against 2049
of 2080 cached keys); each launch's max abs diff from the plain version;
``select_topm`` at the cluster query's shape (Q 256, L 8192, m 906) and
the item index's (Q 6040, L 3952, m 512) against ``torch.topk``, with its
plain version (ids and values must be equal); then the index kernels
(``--only index`` runs these alone): ``fused_scan_topm`` at the approx
path's block (Q 2048, N 6040, P 256, m 906) and at the U = 32768 index's
(Q 2048, N 32768, P 512, m 655) against ``matmul`` + ``topk`` and, where
the tree has the score launch alone, against its two launches run in
L2-sized row slabs, and ``fused_rerank_scores`` (pcc) on one 2048-query block of the
ML-1M surrogate as the path calls it — int8 queries over the 6040 real
union columns and the sentinel where the tree takes int8 queries, f32
queries over the union padded to 8192 columns as the previous design
did — each held to its plain version bit for bit.  ``--only exact``
times ``fused_similarity`` at one exact-fit launch ((6040, 3952) ×
(1024, 3952) of the ML-1M surrogate, pcc) on f32 rows and, where the
tree has the int8 route, on the int8 rows with max_value 5, beside six
f32 ``torch.matmul`` and six ``torch._int_mm`` calls; ``--only support``
times ``fused_support_scores`` at the approx recommend's 6040-user chunk
(k 40 exact pcc neighbors, I' 4096) on the f32 tables and, where the
tree has it, on the int8 route, beside ``torch.sparse.mm``; both hold
every route to its plain version bit for bit.  ``--only predict`` times
``fused_tile_predict`` on the int8 source of the ML-1M surrogate (k 40
exact pcc neighbors, the first 1024 users) at one recommend tile (items
[0, 512)) and at one whole-range launch ([0, 3952)), each on the device
alone (queued behind a spin kernel) and as a call with its host work,
then ``predict_from_neighbors_blocked(use_kernel=True)`` for that user
block as the exact recommend calls it (every launch of the call), beside
``torch.sparse.mm`` of the (m, U) CSR weights against the stacked (U, 2T)
[dev | mask] tile, its bound and its no-FMA floor (4 operations for
each rated element of a weighted neighbor row, the terms the data needs,
at half the f32 peak; an unrated element adds ±0).  ``--only cluster`` times
``fused_centroid_distances`` on seeded unit rows at (6040, 256) × (78,
256), one k-means block (2048, 256) × (78, 256) and the U = 32768
index's (2048, 512) × (182, 512), the same two ways, beside
``torch.cdist(x, c).square()``; both hold the kernel to its plain
version bit for bit (kernel 3 also on a row subset).  ``--only bag`` times
the embedding bag (kernel 9) at the recsys paths' shapes, each held to its
plain version bit for bit: (a) 2048 multi-hot bags × L 100 over
DLRM-MLPerf's fused f32 D = 128 table (fields capped at 20 M rows, as
``chip_smoke.py`` phase 15), (b) serve_p99's 6656 sharded-field lookups
as L = 1 bags over it, beside the serve step's own gather
(``models/embedding.py::_take``), and the multi-hot bags over FM's (c)
f32 D = 10 factor table and (d) D = 1 linear table; the launch with the
L2 flushed before each call (``chip_smoke.py``'s cold timer: a spin
between the flush and the start event, the median of the calls) and warm
on the device alone, three rounds in turns (median [min, max]), the
wrapper with its id check back to back and as one call's host wall
(``chip_smoke.py``'s timer; its id check runs before the launch, and it
waits for the count alone) in five rounds in turns beside the same
wrapper with the check after the launch, waiting for it,
``F.embedding_bag`` (the validity
mask as ``per_sample_weights``) and the plain version.  On a tree with a
launch plan it also times the design's variants on the same inputs: the
plan's alternatives (ring depth 4 or 8; for narrow rows the warp kernel
in place of the slot kernel), patched copies of ``csrc/embedding_bag.cu``
(register ring depths 16 and 32, a ring of 1-D bulk copies —
``cp.async.bulk`` into shared memory, completing on an ``mbarrier``, at
D = 128 — in place of the registers, the L1 preferred over shared
memory, and the diagnostic that reads the rows through the L2 alone).
``--only flash_bwd`` times kernel 8's backward alone at ``chip_smoke.py``
phase 22's shape (B 4, Hq 32, Hkv 8, S 2048, d 64, causal; seeded
contiguous q / k / v / dO) in bf16 and f32, each held to the plain
backward on f32 copies (1e-2 / 2e-5 of the largest |gradient|) and to a
second call bit for bit, beside autograd of
``scaled_dot_product_attention``'s backward; then kernel 8's prefill
(Llama-3.2-1B's layer shape in the model's (B, S, H, d) storage) and
decode (Sq 1 against 2049 of 2080 cached keys) launches with the
log-sum-exp off and, where the tree has ``return_lse``, on (decode on the
device alone).  On a tree
whose backward takes no lse it is called as that tree defines it.
``--only exact`` also
times the exact fit's candidate loop on the host's clock, as shipped
and, where the tree has the fit's shared ``n_bad`` counter, with a wait
after every launch instead.  ``--only`` may repeat.
``--src DIR`` imports ``repro_torch`` from DIR (an unpacked parent tree,
to time two designs in one call).  Times are CUDA events over
back-to-back calls, the host's enqueue included, except where a line says
"device" (the calls queued behind a spin kernel, so a launch shorter than
its host work is timed on the device alone).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import inspect
import os
import sys

_ARGS = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ARGS.add_argument("--src", default=os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", "src"))
_ARGS.add_argument("--only", choices=("index", "exact", "support",
                                      "predict", "cluster", "bag",
                                      "flash_bwd"),
                   action="append", default=None)
ARGS = _ARGS.parse_args()
sys.path.insert(0, os.path.abspath(ARGS.src))

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


def time_ms_queued(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls
    enqueued behind a ~20 ms spin kernel (CUDA events), so the host's
    enqueue is not counted."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bitwise(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def scan_in_slabs(sel, q, pool, ids, m, slab_bytes):
    """The scan's two launches row slab by row slab, each slab's scores
    small enough to stay in the 50 MB L2 until its select reads them: the
    alternative to the one workspace the scan ships with."""
    rows = max(1, slab_bytes // (4 * pool.shape[0]))
    for r0 in range(0, q.shape[0], rows):
        scores = sel.proxy_scores_cuda(q[r0:r0 + rows], pool)
        sel.select_topm(scores, ids[r0:r0 + rows], m=m)


def index_kernels(dev) -> bool:
    """Kernels 4 and 6 at their path shapes; False on any mismatch."""
    import repro_torch.kernels.select as sel
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels.rerank import (fused_rerank_scores,
                                            rerank_scores_plain)
    ok = True
    rng = np.random.default_rng(0)
    for n, p, m in ((6040, 256, 906), (32768, 512, 655)):
        x = rng.normal(size=(n, p)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        pool = torch.from_numpy(x).to(dev)
        q = pool[:2048].contiguous()
        ids = torch.arange(2048, dtype=torch.int32, device=dev)
        got = sel.fused_scan_topm(q, pool, ids, m=m)
        want = sel.scan_topm_plain(q, pool, ids, m)
        same = torch.equal(got[1], want[1]) and bitwise(got[0], want[0])
        ok &= same
        line = (f"scan Q=2048 N={n} P={p} m={m} bitwise {same} ms "
                f"{time_ms(lambda: sel.fused_scan_topm(q, pool, ids, m=m))!r}"
                f" matmul+topk {time_ms(lambda: torch.topk(q @ pool.T, m))!r}")
        if hasattr(sel, "proxy_scores_cuda"):
            for mb in (16, 32):
                line += f" slabs{mb}MB " + repr(time_ms(
                    lambda: scan_in_slabs(sel, q, pool, ids, m, mb << 20)))
        print(line, flush=True)
    train, _, _ = load_ml1m_synthetic()
    r = torch.from_numpy(train).to(dev)
    n = r.shape[0]
    r8 = r.to(torch.int8)
    norms = torch.sqrt((r.double() ** 2).sum(1)).float()
    counts = (r > 0).sum(1).float()
    u = torch.arange(n + 1, device=dev).clamp_max(n - 1)   # + the sentinel
    ku = torch.cat([u, u.new_full((8192 - u.numel(),), n - 1)])
    forms = [("previous form: f32 queries, union padded to 8192", r[:2048],
              ku, {})]
    if "max_value" in inspect.signature(fused_rerank_scores).parameters:
        forms.append(("int8 queries, 6040 real columns + sentinel",
                      r8[:2048], u, {"max_value": 5}))
    for name, q, cols, kw in forms:
        q = q.contiguous()
        c, cn, cc = (t[cols].contiguous() for t in (r8, norms, counts))
        got = fused_rerank_scores(q, c, cn, cc, measure="pcc", **kw)
        same = bitwise(got, rerank_scores_plain(q, c, cn, cc, measure="pcc"))
        ok &= same
        print(f"rerank pcc G=2048 Kc={c.shape[0]} J={c.shape[1]} ({name}) "
              f"bitwise {same} ms "
              f"{time_ms(lambda: fused_rerank_scores(q, c, cn, cc, measure='pcc', **kw), 5)!r}",
              flush=True)
    return ok


def exact_kernels(dev) -> bool:
    """Kernel 1 at one exact-fit launch; False on any mismatch."""
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels.similarity import (fused_similarity,
                                                similarity_plain)
    train, _, _ = load_ml1m_synthetic()
    r = torch.from_numpy(train).to(dev)
    r8 = r.to(torch.int8)
    forms = [("f32", r, {})]
    params = inspect.signature(fused_similarity).parameters
    if "max_value" in params:
        kw = {"max_value": 5}
        if "n_bad" in params:   # the fit's counter: no wait per launch
            kw["n_bad"] = torch.zeros(1, dtype=torch.int32, device=dev)
        forms.append(("int8", r8, kw))
    ok = True
    for name, a, kw in forms:
        b = a[:1024].contiguous()
        want = similarity_plain(a, b, measure="pcc")
        got = fused_similarity(a, b, measure="pcc", **kw)
        same = bitwise(got, want)
        ok &= same
        routes = getattr(fused_similarity, "routes", None)
        print(f"similarity pcc {tuple(a.shape)}x{tuple(b.shape)} {name} "
              f"bitwise {same} ms "
              f"{time_ms(lambda: fused_similarity(a, b, measure='pcc', **kw))!r}"
              f" routes {routes}", flush=True)
    b = r[:1024]
    ma, mb = (r > 0).float(), (b > 0).float()
    ops = [(ma, mb.T), (r, b.T), (r, mb.T), (ma, b.T), (r * r, mb.T),
           (ma, (b * b).T)]
    ops = [(x.contiguous(), y.contiguous()) for x, y in ops]
    b8 = r8[:1024]
    m8a, m8b = (r8 > 0).to(torch.int8), (b8 > 0).to(torch.int8)
    planes = [(m8a, m8b), (r8, b8), (r8, m8b), (m8a, b8), (r8 * r8, m8b),
              (m8a, b8 * b8)]
    print(f"six torch.matmul ms "
          f"{time_ms(lambda: [torch.matmul(x, y) for x, y in ops])!r} "
          f"six torch._int_mm ms "
          f"{time_ms(lambda: [torch._int_mm(x, y.T) for x, y in planes])!r}",
          flush=True)
    fit_loop(train, dev)
    return ok


def fit_loop(train, dev):
    """Wall time of the exact fit's candidate loop
    (``CFEngine._topk`` on the kernel backend, six launches at ML-1M),
    median of 11 after a warm-up; where the tree counts rows past
    ``max_value`` into the fit's one counter, also with the wrapper's own
    counter (a wait after every launch), the two forms in alternating
    order."""
    import statistics
    import time
    from repro_torch.core.facade import CFEngine
    from repro_torch.kernels import similarity as ksim
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   device=dev).fit()
    shipped = ksim.fused_similarity

    def own(*a, n_bad=None, **kw):
        return shipped(*a, **kw)

    own.launches, own.routes = 0, getattr(shipped, "routes", None)
    forms = {"as shipped": shipped}
    if "n_bad" in inspect.signature(shipped).parameters:
        forms["a wait after every launch"] = own
    times = {name: [] for name in forms}
    for rep in range(12):
        for name, fn in (forms.items() if rep % 2 else
                         reversed(forms.items())):
            ksim.fused_similarity = fn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._topk(eng.ratings)
            torch.cuda.synchronize()
            if rep:
                times[name].append((time.perf_counter() - t0) * 1e3)
    ksim.fused_similarity = shipped
    for name, ms in times.items():
        print(f"exact fit candidate loop, {name}: wall ms median "
              f"{statistics.median(ms)!r} min {min(ms)!r}", flush=True)


def support_kernels(dev) -> bool:
    """Kernel 7 at the approx recommend's 6040-user chunk; False on any
    mismatch."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.index import item_index
    from repro_torch.kernels import support as ks
    train, _, _ = load_ml1m_synthetic()
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   device=dev).fit()
    ratings, scores, idx, means = eng.snapshot()
    n_items = ratings.shape[1]
    width = n_items + (-n_items) % ks.BT
    # the function that makes the tables (the item index's own in a tree
    # without the int8 route)
    tables = getattr(ks, "support_tables", None) \
        or item_index._dense_tables
    dev_t, msk_t = tables(ratings, means, width)
    safe = torch.where(idx >= 0, idx, 0).to(torch.int32).contiguous()
    w = torch.where((scores > 0) & (idx >= 0), scores,
                    torch.zeros_like(scores)).contiguous()
    means = means.contiguous()
    want = ks.support_scores_plain(dev_t, msk_t, safe, w, means)
    forms = [("table", (dev_t, msk_t, safe, w, means))]
    if hasattr(ks, "support_route"):
        forms.append(("int8", (ratings.to(torch.int8), means, safe, w,
                               means)))
    ok = True
    for name, args in forms:
        same = bitwise(ks.fused_support_scores(*args), want)
        ok &= same
        print(f"support b={safe.shape[0]} k={safe.shape[1]} I'={width} "
              f"{name} bitwise {same} ms "
              f"{time_ms(lambda: ks.fused_support_scores(*args))!r} routes "
              f"{getattr(ks.fused_support_scores, 'routes', None)}",
              flush=True)
    b, k = safe.shape
    crow = torch.arange(0, b * k + 1, k, dtype=torch.int64, device=dev)
    wmat = torch.sparse_csr_tensor(crow, safe.reshape(-1).long(),
                                   w.reshape(-1), size=(b, ratings.shape[0]))
    stacked = torch.cat([dev_t, msk_t], dim=1).contiguous()
    print(f"torch.sparse.mm ms "
          f"{time_ms(lambda: torch.sparse.mm(wmat, stacked))!r}", flush=True)
    return ok


def predict_kernels(dev) -> bool:
    """Kernel 2 at the exact recommend's shapes; False on any
    mismatch."""
    from repro_torch.core import predict as pr
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels.predict import (fused_tile_predict,
                                             tile_predict_plain)
    train, _, _ = load_ml1m_synthetic()
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   device=dev).fit()
    ratings, scores, idx, means = eng.snapshot()
    u, n_items = ratings.shape
    m = 1024
    src = pr.make_gather_source(ratings)
    ids = torch.where(idx[:m] >= 0, idx[:m], 0).to(torch.int32).contiguous()
    w = torch.where((scores[:m] > 0) & (idx[:m] >= 0), scores[:m],
                    torch.zeros_like(scores[:m])).contiguous()
    nbm = means[ids.long()].contiguous()
    qm = means[:m].contiguous()
    k = ids.shape[1]
    rows_read = int(torch.unique(ids).numel())
    crow = torch.arange(0, m * k + 1, k, dtype=torch.int64, device=dev)
    wmat = torch.sparse_csr_tensor(crow, ids.reshape(-1).long(),
                                   w.reshape(-1), size=(m, u))
    ok = True
    for lo, hi in ((0, 512), (0, n_items)):
        t = hi - lo

        def call():
            return fused_tile_predict(src, ids, w, nbm, qm, lo, hi)

        same = bitwise(call(), tile_predict_plain(src, ids, w, nbm, qm, lo,
                                                  hi))
        ok &= same
        r = ratings[:, lo:hi]
        stacked = torch.cat([torch.where(r > 0, r - means[:, None], 0.0),
                             (r > 0).float()], dim=1).contiguous()
        n_bytes = rows_read * t + m * k * 12.0 + m * 4.0 + m * t * 4.0
        terms = int(((src[:, lo:hi] > 0).sum(1)[ids.long()] * (w != 0))
                    .sum())
        bound = max(n_bytes / 3.35e12,
                    (4.0 * terms + 5.0 * m * t) / 67e12) * 1e3
        print(f"tile_predict m={m} k={k} items[{lo},{hi}) int8 bitwise "
              f"{same} device ms {time_ms_queued(call)!r} call ms "
              f"{time_ms(call, 50)!r} sparse.mm device ms "
              f"{time_ms_queued(lambda: torch.sparse.mm(wmat, stacked), 20)!r}"
              f" bound ms {bound!r} nofma floor ms "
              f"{4.0 * terms / (67e12 / 2) * 1e3!r} rated terms {terms} "
              f"of {m * k * t} routes "
              f"{getattr(fused_tile_predict, 'routes', None)}", flush=True)

    def path():
        return pr.predict_from_neighbors_blocked(
            ratings, scores[:m], idx[:m], means=means, query_means=qm,
            item_block=512, gather_src=src, use_kernel=True)

    before = fused_tile_predict.launches
    got = path()
    launches = fused_tile_predict.launches - before
    same = bitwise(got, tile_predict_plain(src, ids, w, nbm, qm, 0, n_items))
    ok &= same
    print(f"predict_from_neighbors_blocked m={m} item_block 512 "
          f"({launches} launches a call) bitwise {same} device ms "
          f"{time_ms_queued(path, 20)!r} call ms {time_ms(path, 20)!r}",
          flush=True)
    return ok


def cluster_kernels(dev) -> bool:
    """Kernel 3 at the index's shapes; False on any mismatch."""
    from repro_torch.kernels.cluster import (centroid_distances_plain,
                                             fused_centroid_distances)
    rng = np.random.default_rng(0)
    ok = True
    for m, n, d in ((6040, 78, 256), (2048, 78, 256), (2048, 182, 512)):
        xs = []
        for rows in (m, n):
            a = rng.normal(size=(rows, d)).astype(np.float32)
            xs.append(torch.from_numpy(
                a / np.linalg.norm(a, axis=1, keepdims=True)).to(dev))
        x, c = xs

        def call():
            return fused_centroid_distances(x, c)

        got = call()
        sub = torch.arange(0, m, 7, device=dev)
        same = bitwise(got, centroid_distances_plain(x, c)) and bitwise(
            fused_centroid_distances(x[sub].contiguous(), c), got[sub])
        ok &= same
        n_bytes = ((m + n) * d + m * n) * 4.0
        n_ops = 2.0 * m * n * d + 2.0 * (m + n) * d + 3.0 * m * n
        bound = max(n_bytes / 3.35e12, n_ops / 67e12) * 1e3
        print(f"centroid_distances ({m},{d})x({n},{d}) bitwise {same} "
              f"device ms {time_ms_queued(call)!r} call ms "
              f"{time_ms(call, 50)!r} cdist^2 device ms "
              f"{time_ms_queued(lambda: torch.cdist(x, c).square())!r} "
              f"bound ms {bound!r} nofma floor ms "
              f"{2.0 * m * n * d / (67e12 / 2) * 1e3!r}", flush=True)
    return ok


# patched copies of csrc/embedding_bag.cu: the register ring's depth for
# long bags, and a ring of 1-D bulk copies into shared memory in place of
# the registers (one copy a row by lane 0, completing on an mbarrier;
# right for rows of 16-byte words that fit one column chunk); each with
# the depth its plan passes
BAG_DEPTH = "constexpr int DEPTH = 8;"
BAG_RING = [
    ("    Word v[P];\n", """\
    __shared__ alignas(128) Word ring[MAX_WARPS][P][32];
    __shared__ alignas(8) unsigned long long bar[MAX_WARPS][P];
    const int wib = threadIdx.x >> 5;
    const unsigned gmask = stride < 32 ? (1u << stride) - 1u : FULL;
    unsigned phase = 0, live = 0;
    if (lane == 0) {
      for (int j = 0; j < P; ++j)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(
            static_cast<unsigned>(__cvta_generic_to_shared(&bar[wib][j]))));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncwarp(gmask);
"""),
    ("""\
      v[j] = Word{};
      if (static_cast<unsigned long long>(i) < limit) {
        v[j] = col[i * stride];
""", """\
      live &= ~(1u << j);
      if (static_cast<unsigned long long>(i) < limit) {
        live |= 1u << j;
        if (lane == 0) {
          const unsigned b = static_cast<unsigned>(
              __cvta_generic_to_shared(&bar[wib][j]));
          const unsigned dst = static_cast<unsigned>(
              __cvta_generic_to_shared(&ring[wib][j][0]));
          const unsigned bytes = static_cast<unsigned>(stride * sizeof(Word));
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                       :: "r"(b), "r"(bytes) : "memory");
          asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                       "complete_tx::bytes [%0], [%1], %2, [%3];"
                       :: "r"(dst), "l"(reinterpret_cast<const Word*>(table)
                                        + i * stride),
                          "r"(bytes), "r"(b) : "memory");
        }
"""),
    ("        add_word<T>(acc, v[j]);\n", """\
        if ((live >> j) & 1u) {
          const unsigned b = static_cast<unsigned>(
              __cvta_generic_to_shared(&bar[wib][j]));
          unsigned done;
          do {
            asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta"
                         ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                         : "=r"(done) : "r"(b), "r"((phase >> j) & 1u)
                         : "memory");
          } while (!done);
          phase ^= 1u << j;
          add_word<T>(acc, ring[wib][j][lane]);
        }
"""),
    ("        issue(j, next[j]);                  // slot l0 + P + j\n",
     "        __syncwarp(gmask);                  // stage j read\n"
     "        issue(j, next[j]);                  // slot l0 + P + j\n"),
]
BAG_VARIANTS = {   # name: (patches, depth its plan passes for long bags)
    "register ring depth 16": ([(BAG_DEPTH, BAG_DEPTH.replace("8", "16"))],
                               16),
    "register ring depth 32": ([(BAG_DEPTH, BAG_DEPTH.replace("8", "32"))],
                               32),
    "bulk-copy ring, depth 8": (BAG_RING, 8),
    "L1 preferred over shared memory (carveout 0)": ([(
        "  switch (depth) {\n    case 1: BAG_LAUNCH(1); break;",
        "  cudaFuncSetAttribute(bag_kernel<T, I, Word, DEPTH>,\n"
        "                       cudaFuncAttributePreferredSharedMemoryCarveout,"
        " 0);\n  switch (depth) {\n    case 1: BAG_LAUNCH(1); break;")], 8),
    "diagnostic: rows read through the L2 alone (__ldcg)": ([(
        "        v[j] = col[i * stride];\n",
        "        v[j] = __ldcg(col + i * stride);\n")], 8),
}
def bag_checks(kb, table, ids):
    """The checks ``embedding_bag`` makes before it launches, which
    :func:`bag_check_after` makes too, so that the two differ only in the
    id check."""
    kb._check(table, ids, "sum")
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in kb._DTYPES:
        raise TypeError(f"table must be f32 or bf16, got {table.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")


def bag_check_after(kb):
    """The wrapper with its id check after the launch (the previous
    design's): a torch counter zeroed, the launch, and the bag kernel's
    own count of ids ≥ V read back, which waits for the launch."""
    def call(table, ids):
        bag_checks(kb, table, ids)
        n_bad = torch.zeros((1,), dtype=torch.int32, device=table.device)
        out = kb.launch(table, ids, n_bad)
        if int(n_bad.item()):
            raise ValueError("id(s) past the table")
        return out
    return call


def bag_shapes(dev):
    """(name, table, ids) of shapes (a)-(d): the DLRM fused table and the
    FM tables made on the card from seeded generators, the multi-hot ids
    as ``chip_smoke.py`` makes them (seed 4) and serve_p99's sharded-field
    lookups (batch seed 0) as L = 1 bags."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import recsys_batch
    from chip_smoke import BAG_SHAPE, DLRM_ROW_CAP, multi_hot_ids
    cfg = get_arch("dlrm_mlperf").config
    cfg = dataclasses.replace(cfg, field_sizes=tuple(
        min(s, DLRM_ROW_CAP) for s in cfg.field_sizes))
    layout = cfg.layout()
    g = torch.Generator(device=dev).manual_seed(0)
    dlrm = torch.empty((layout.sharded_rows, cfg.embed_dim),
                       device=dev).normal_(generator=g)
    sf = list(layout.sharded_fields)
    sparse = torch.from_numpy(recsys_batch(512, cfg.field_sizes,
                                           cfg.n_dense, seed=0)["sparse"])
    l1 = layout.global_ids(sparse[:, sf].to(dev), sf).reshape(-1, 1)
    fm = get_arch("fm").config
    fm_ids = torch.from_numpy(multi_hot_ids(fm.layout(), BAG_SHAPE, 4)).to(dev)
    out = [("(a) multi-hot DLRM", dlrm, torch.from_numpy(
               multi_hot_ids(layout, BAG_SHAPE, 4)).to(dev)),
           ("(b) L = 1 DLRM", dlrm, l1.contiguous())]
    for name, lay in (("(c) multi-hot FM factors", fm.layout()),
                      ("(d) multi-hot FM linear", fm.linear_layout())):
        table = torch.empty((lay.sharded_rows, lay.embed_dim), device=dev)
        out.append((name, table.normal_(generator=g), fm_ids))
    return out


def in_rounds(forms: dict, measures: dict, rounds: int = 3) -> dict:
    """Each measure of each form, the forms taken in turns (forward,
    backward, forward, ...): form → measure → the rounds' readings."""
    out = {f: {m: [] for m in measures} for f in forms}
    for r in range(rounds):
        for f in (forms if r % 2 == 0 else reversed(list(forms))):
            for m, timer in measures.items():
                out[f][m].append(timer(forms[f]))
    return out


def spread(xs) -> str:
    """'median [min, max]' of readings."""
    return f"{sorted(xs)[len(xs) // 2]!r} [{min(xs)!r}, {max(xs)!r}]"


def bag_kernels(dev) -> bool:
    """Kernel 9 at shapes (a)-(d), and on a tree with a launch plan its
    variants, each held to the plain version bit for bit; False on any
    mismatch.  Launches: cold (L2 flushed before each; ``chip_smoke.py``'s
    timer) and warm on the device alone (queued behind a spin kernel),
    three rounds in turns; the wrapper and the same with its id check
    after the launch: back to back (CUDA events) and one call's host
    wall, five rounds in turns."""
    from repro_torch.models.embedding import _take
    kb = importlib.import_module("repro_torch.kernels.embedding_bag")
    # chip_smoke.py (the repository root) puts its own src first on
    # sys.path; repro_torch is imported by now, from --src
    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), ".."))
    from chip_smoke import host_wall_ms, time_ms_cold
    planned = hasattr(kb, "plan")
    ok = True
    variants = {}
    if planned:
        from index_variants import build
        patches = {k: v[0] for k, v in BAG_VARIANTS.items()}
        built = build("embedding_bag", patches)
        variants = {k: (built[k][0], BAG_VARIANTS[k][1])
                    for k in BAG_VARIANTS}
        for k, (_, regs) in built.items():
            print(f"bag variant {k} ptxas: " + "; ".join(regs), flush=True)
    launch_measures = {"cold": time_ms_cold,
                       "warm device": lambda fn: time_ms_queued(fn, 30)}
    shipped_lib = kb._lib

    def with_lib(lib, fn, *args, **kw):
        kb._lib = shipped_lib if lib is None else (lambda: lib)
        try:
            return fn(*args, **kw)
        finally:
            kb._lib = shipped_lib

    for name, table, ids in bag_shapes(dev):
        b, l = ids.shape
        d = table.shape[1]
        valid = ids >= 0
        distinct = int(torch.unique(ids[valid]).numel())
        n_bytes = (distinct * d + b * d) * 4.0 + b * l * 4.0
        want = kb.embedding_bag_plain(table, ids)
        n_bad = torch.zeros(1, dtype=torch.int32, device=dev)

        def run(how=None, lib=None):
            kw = {"how": how} if how is not None else {}
            return with_lib(lib, kb.launch, table, ids, n_bad, **kw)

        forms = {"shipped": run}
        if planned:
            shipped = kb.plan(d, table.element_size(), l, kb._align(table))
            print(f"bag {name} shipped plan {shipped}", flush=True)
            if shipped.slots:   # the warp kernel on the same rows
                alts = [("the warp kernel", dataclasses.replace(
                    shipped, slots=False))]
            else:
                alts = [(f"depth {p}", dataclasses.replace(shipped, depth=p))
                        for p in (4, kb.DEPTH)]
            for label, how in alts:
                if how != shipped:
                    forms[f"{label} {how}"] = functools.partial(run, how)
            for label, (lib, depth) in variants.items():
                if shipped.slots or ("bulk" in label and d != 128):
                    continue
                forms[label] = functools.partial(
                    run, dataclasses.replace(
                        shipped, depth=depth if l > 1 else shipped.depth),
                    kb.bind(lib))
        for label, fn in forms.items():
            same = bitwise(fn(), want)
            ok &= same
            if not same:
                print(f"bag {name} {label} NOT bitwise equal", flush=True)
        for label, got in in_rounds(forms, launch_measures).items():
            print(f"bag {name} B={b} L={l} D={d} ({distinct} distinct "
                  f"rows) {label}: " + "; ".join(
                      f"{m} ms {spread(xs)}" for m, xs in got.items()),
                  flush=True)

        walls = {"wrapper": lambda: kb.embedding_bag(table, ids)}
        if planned:
            walls["check after the launch"] = functools.partial(
                bag_check_after(kb), table, ids)
        for label, fn in walls.items():
            same = bitwise(fn(), want)
            ok &= same
            if not same:
                print(f"bag {name} {label} NOT bitwise equal", flush=True)
        for label, got in in_rounds(walls, {
                "back to back": lambda fn: time_ms(fn, 50),
                "one call's host wall": host_wall_ms}, rounds=5).items():
            print(f"bag {name} {label}: " + "; ".join(
                f"{m} ms {spread(xs)}" for m, xs in got.items()), flush=True)
        safe, weights = ids.clamp_min(0), valid.to(table.dtype)
        yard = {"F.embedding_bag": lambda: F.embedding_bag(
            safe, table, mode="sum", per_sample_weights=weights)}
        if l == 1:
            yard["the serve step's gather _take"] = functools.partial(
                _take, table, ids[:, 0])
            ok &= bitwise(yard["the serve step's gather _take"](), want)
        for label, got in in_rounds(yard, launch_measures).items():
            print(f"bag {name} {label}: " + "; ".join(
                f"{m} ms {spread(xs)}" for m, xs in got.items()), flush=True)
        print(f"bag {name} plain cold ms "
              f"{time_ms_cold(lambda: kb.embedding_bag_plain(table, ids), 3)!r}"
              f" bound ms {n_bytes / 3.35e12 * 1e3!r} routes "
              f"{getattr(kb.embedding_bag, 'routes', None)}", flush=True)
    return ok


def flash_bwd_kernels(dev) -> bool:
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    has_lse = "return_lse" in inspect.signature(
        fa.flash_attention).parameters
    b, hq, hkv, s, d = 4, 32, 8, 2048, 64
    g = torch.Generator(device=dev).manual_seed(22)
    ok = True
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        q = torch.randn((b, hq, s, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=g, device=dev)
                .to(dtype) for _ in range(2))
        if has_lse:
            o, lse = fa.flash_attention(q, k, v, return_lse=True)
        else:
            o = fa.flash_attention(q, k, v)
        do = torch.randn(o.shape, generator=g, device=dev).to(dtype)
        args = (q, k, v, o, do) + ((lse,) if has_lse else ())
        got = fa.flash_attention_bwd(*args)
        again = fa.flash_attention_bwd(*args)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        want = fa.flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, o, do)))
        rel = max(float((x.float() - w).abs().max())
                  / max(1.0, float(w.abs().max()))
                  for x, w in zip(got, want))
        ok = ok and same and rel <= tol
        del got, again, want
        ms = time_ms(lambda: fa.flash_attention_bwd(*args), 10)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 enable_gqa=True)
        lib = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), 10)
        print(f"flash_bwd {str(dtype)[6:]} ms {ms!r} sdpa_bwd {lib!r} "
              f"rel {rel!r} (limit {tol}) deterministic {same} routes "
              f"{getattr(fa.flash_attention_bwd, 'routes', None)}")
        del q, k, v, o, do, args, leaves, lib_out

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    q = rnd(b, s, hq, d).transpose(1, 2)
    k = rnd(b, s, hkv, d).transpose(1, 2)
    v = rnd(b, s, hkv, d).transpose(1, 2)
    kc, vc = rnd(b, hkv, 2080, d), rnd(b, hkv, 2080, d)
    qd = rnd(b, hq, 1, d)
    kv_len = torch.full((b,), 2049, dtype=torch.int32, device=dev)
    line = (f"prefill ms lse off "
            f"{time_ms(lambda: fa.flash_attention(q, k, v))!r} decode ms "
            f"(device) lse off {time_ms_queued(lambda: fa.flash_attention(qd, kc, vc, kv_len=kv_len))!r}")
    if has_lse:
        line += (f"; lse on: prefill "
                 f"{time_ms(lambda: fa.flash_attention(q, k, v, return_lse=True))!r} decode "
                 f"{time_ms_queued(lambda: fa.flash_attention(qd, kc, vc, kv_len=kv_len, return_lse=True))!r}")
    print(line + f" routes {fa.flash_attention.routes}")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    dev = "cuda"
    print(f"repro_torch from {os.path.abspath(ARGS.src)}")
    if ARGS.only:
        runs = {"index": index_kernels, "exact": exact_kernels,
                "support": support_kernels, "predict": predict_kernels,
                "cluster": cluster_kernels, "bag": bag_kernels,
                "flash_bwd": flash_bwd_kernels}
        ok = all([runs[name](dev) for name in ARGS.only])
        print(torch.cuda.get_device_name(0))
        return 0 if ok else 1
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels.select import select_topm, select_topm_twin
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
    ok = index_kernels(dev)
    print(torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
