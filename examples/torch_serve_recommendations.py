"""Batched recommendation serving on the PyTorch/CUDA port: request queue
→ padded batch → predict (the port of ``examples/serve_recommendations.py``,
the same printed lines).

``CFEngine`` behind the supervised ``BatchingServer`` on the 1024 × 512
surrogate: requests arrive one by one, the batcher groups them up to
``--max-batch`` or ``--max-wait-ms``, and each user's full item row is
scored before the top-n extraction.  Halfway through the stream a burst
of 32 fresh ratings is absorbed with ``CFEngine.update_ratings`` and the
next batch serves from the updated cache.

``--backend`` takes the port's names: ``kernel`` (the CUDA similarity and
tile-predict kernels; the reference's ``pallas``), ``sequential`` (plain
PyTorch), ``sharded`` / ``ring`` (the mesh engines on the default
one-axis mesh: a one-rank NCCL group on the card, gloo on the CPU).
``--neighbor-mode approx`` fits the clustered user index instead (on the
card its centroid-distance, scan / select and rerank kernels).

    PYTHONPATH=src python examples/torch_serve_recommendations.py --backend kernel
    PYTHONPATH=src python examples/torch_serve_recommendations.py \\
        --neighbor-mode approx --n-clusters 32 --n-probe 16
    PYTHONPATH=src python examples/torch_serve_recommendations.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.core import BACKENDS, CFEngine
from repro_torch.data import load_ml1m_synthetic
from repro_torch.serving.engine import BatchingServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--backend", default="sequential", choices=BACKENDS)
    ap.add_argument("--neighbor-mode", default="exact",
                    choices=("exact", "approx"))
    ap.add_argument("--measure", default="cosine",
                    choices=("jaccard", "cosine", "pcc"))
    ap.add_argument("--n-clusters", type=int, default=0,
                    help="approx mode: clusters (0 = auto ~sqrt(U))")
    ap.add_argument("--n-probe", type=int, default=0,
                    help="approx mode: probed clusters (0 = auto)")
    ap.add_argument("--query-mode", default="auto",
                    choices=("auto", "staged", "fused"),
                    help="approx mode: index query pipeline (auto picks "
                         "fused where the CUDA kernels run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train, _, _ = load_ml1m_synthetic(n_users=1024, n_items=512)
    index_cfg = None
    if args.neighbor_mode == "approx":
        from repro_torch.index import IndexConfig
        index_cfg = IndexConfig(
            n_clusters=args.n_clusters, n_probe=args.n_probe,
            query_mode=args.query_mode,
            features="centered" if args.measure == "pcc" else "raw")
    engine = CFEngine(train, measure=args.measure, k=40,
                      backend=args.backend, block_size=256,
                      neighbor_mode=args.neighbor_mode,
                      index_cfg=index_cfg, device=args.device).fit()
    print(f"engine fitted ({args.backend}/{args.neighbor_mode}) "
          f"in {engine.fit_seconds:.2f}s")
    recall = None
    if args.neighbor_mode == "approx":
        qs = engine.index.last_query
        recall = engine.recall_vs_exact(sample=256)
        print(f"index: {engine.index.n_clusters} clusters, "
              f"probe {engine.index.n_probe}, "
              f"query={qs.query_mode or 'staged'}, "
              f"{qs.rerank_fraction:.1%} of rows exactly reranked, "
              f"recall@{engine.k} vs exact = {recall:.3f}")

    server = BatchingServer(engine, max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms, topn=5,
                            device=args.device)
    server.start()
    rng = np.random.default_rng(0)
    users = rng.integers(0, engine.n_users, args.requests)

    t0 = time.perf_counter()
    futures = [server.submit(int(u)) for u in users[:args.requests // 2]]

    # live traffic: a burst of new ratings lands mid-stream
    n_delta = 32
    uids = rng.integers(0, engine.n_users, n_delta)
    iids = rng.integers(0, engine.n_items, n_delta)
    vals = rng.integers(1, 6, n_delta).astype(np.float32)
    st = engine.update_ratings(uids, iids, vals)
    print(f"absorbed {st.n_deltas} ratings in {st.seconds * 1e3:.0f}ms "
          f"({st.n_affected} rows recomputed, {st.n_merged} merged)")

    futures += [server.submit(int(u)) for u in users[args.requests // 2:]]
    results = [f.result(timeout=60) for f in futures]
    dt = time.perf_counter() - t0
    server.stop()

    s = server.stats()
    print(f"{s['n_requests']} requests in {dt:.2f}s "
          f"({s['n_requests'] / dt:.1f} req/s)")
    print(f"latency p50={s['latency_p50_ms']:.1f}ms "
          f"p99={s['latency_p99_ms']:.1f}ms "
          f"(queue {s['queue_wait_mean_ms']:.1f}ms, "
          f"compute {s['compute_mean_ms']:.1f}ms)")
    print(f"batches: {s['n_batches']} "
          f"(mean fill {s['mean_batch_fill']:.2f}, "
          f"mean queue depth {s['mean_queue_depth']:.1f})")
    r0 = results[0]
    print(f"sample: user {r0.user} → items {list(map(int, r0.items))}")
    return {"update": st, "results": results, "stats": s, "recall": recall,
            "seconds": dt}


if __name__ == "__main__":
    main()
