"""Serving launcher of the port: fit the CF model and serve batched
recommendations on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 128
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --users 256 --items 128            # the plain CPU path
    PYTHONPATH=src python -m repro_torch.launch.serve --engine facade
    PYTHONPATH=src python -m repro_torch.launch.serve --engine facade \\
        --recommend-mode approx            # two-stage item-index serving
    PYTHONPATH=src python -m repro_torch.launch.serve --engine facade \\
        --backend sharded

``--engine legacy`` (default, as in the reference) fits the paper's
``UserCF(CFConfig(measure, top_k=40, block_size=256))`` (its sequential
engine: the CUDA similarity kernel) and serves it through the legacy
``BatchingServer(cf_model, ratings)`` form (the CUDA tile-predict kernel).
``--engine facade`` fits a ``CFEngine`` and takes ``--backend`` and
``--recommend-mode``, which apply to it only: ``--backend kernel``
(default) fits with the CUDA similarity kernel and
serves through the CUDA tile-predict kernel; ``--backend sharded`` /
``ring`` fit through the mesh engines (``repro_torch.core.engine``) on the
default mesh — a one-rank NCCL group on the card (gloo with ``--device
cpu``) unless the process already joined a group; ``--recommend-mode approx``
serves through the two-stage item index (the CUDA support and select
kernels, then the exact rerank).  ``--device`` defaults to ``cuda`` and a
missing card is an error.  ``--stats-interval`` logs a
periodic ``stats()`` line, ``--metrics-dump PATH`` writes the final
registry snapshot.  ``--deadline-ms`` / ``--max-queue`` exercise the
request lifecycle, ``--ladder`` the degradation state machine, and
``--chaos-at-batch N`` injects a transient fault at batch N so the
supervised retry shows in the stats line.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cf_model import CFConfig, UserCF
from repro_torch.core.facade import BACKENDS, CFEngine
from repro_torch.core.similarity import SIMILARITY_MEASURES
from repro_torch.data import load_ml1m_synthetic
from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                     RecoveryPolicy)
from repro_torch.serving.engine import (BatchingServer, DeadlineExceeded,
                                        DegradationLadder, Overloaded)


def _stats_line(server: BatchingServer) -> str:
    s = server.stats()
    line = (f"requests={s['n_requests']} batches={s['n_batches']} "
            f"p50={s['latency_p50_ms']:.1f}ms p99={s['latency_p99_ms']:.1f}ms "
            f"queue={s['queue_wait_mean_ms']:.1f}ms "
            f"compute={s['compute_mean_ms']:.1f}ms "
            f"fill={s['mean_batch_fill']:.2f} "
            f"depth={s['mean_queue_depth']:.1f} "
            f"health={s['health']}")
    if s["n_failures"] or s["n_shed"] or s["n_deadline_exceeded"]:
        line += (f" failures={s['n_failures']} retries={s['n_retries']} "
                 f"recoveries={s['n_recoveries']} shed={s['n_shed']} "
                 f"deadline={s['n_deadline_exceeded']}")
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--users", type=int, default=1024)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--topn", type=int, default=10)
    ap.add_argument("--engine", choices=("legacy", "facade"),
                    default="legacy",
                    help="legacy: UserCF + BatchingServer(cf_model, "
                         "ratings); facade: CFEngine")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="facade engine only (default kernel)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--measure", default="pcc", choices=SIMILARITY_MEASURES)
    ap.add_argument("--recommend-mode", choices=("exact", "approx"),
                    default=None,
                    help="facade engine only (default exact): approx "
                         "serves through the two-stage item index")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="seconds between periodic stats() log lines "
                         "(0 disables)")
    ap.add_argument("--metrics-dump", default=None,
                    help="write the final metrics-registry snapshot "
                         "(fit + serving) to this JSON path")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline (0 disables)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission bound (0 = unbounded)")
    ap.add_argument("--ladder", action="store_true",
                    help="enable the HEALTHY/DEGRADED/SHEDDING ladder")
    ap.add_argument("--degrade-p99-ms", type=float, default=50.0)
    ap.add_argument("--shed-p99-ms", type=float, default=200.0)
    ap.add_argument("--chaos-at-batch", type=int, default=0,
                    help="inject a transient fault at this batch number "
                         "(0 disables)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="retry budget per faulted batch")
    args = ap.parse_args(argv)
    if args.engine == "legacy" and (args.backend or args.recommend_mode):
        ap.error("--backend and --recommend-mode apply to --engine facade "
                 "only")

    ft_kw = dict(
        max_batch=args.max_batch, topn=args.topn, registry=obs.registry(),
        max_queue=args.max_queue,
        recovery=RecoveryPolicy(max_restarts=args.max_restarts),
        fault_injector=(FaultInjector(fail_at_steps=(args.chaos_at_batch,))
                        if args.chaos_at_batch > 0 else None),
        ladder=(DegradationLadder(degrade_p99_ms=args.degrade_p99_ms,
                                  shed_p99_ms=args.shed_p99_ms)
                if args.ladder else None),
        device=args.device)
    train, _, _ = load_ml1m_synthetic(n_users=args.users,
                                      n_items=args.items)
    if args.engine == "facade":
        backend = args.backend or "kernel"
        mode = args.recommend_mode or "exact"
        engine = CFEngine(train, measure=args.measure, k=40, block_size=256,
                          backend=backend, recommend_mode=mode,
                          device=args.device).fit()
        print(f"fit {engine.n_users}x{engine.n_items} engine=facade "
              f"backend={backend} recommend_mode={mode} "
              f"device={engine.device} in {engine.fit_seconds:.3f}s")
        server = BatchingServer(engine, **ft_kw)
    else:
        cf = UserCF(CFConfig(measure=args.measure, top_k=40,
                             block_size=256), device=args.device)
        ratings = torch.from_numpy(train).to(cf.device)
        st = cf.fit(ratings)
        print(f"fit {train.shape[0]}x{train.shape[1]} engine=legacy "
              f"device={cf.device} in {st.fit_seconds:.3f}s")
        server = BatchingServer(cf, ratings, **ft_kw)
    server.start()

    stop_log = threading.Event()
    if args.stats_interval > 0:
        def logger():
            while not stop_log.wait(args.stats_interval):
                print(f"[stats] {_stats_line(server)}", flush=True)
        threading.Thread(target=logger, daemon=True).start()

    t0 = time.perf_counter()
    deadline = args.deadline_ms if args.deadline_ms > 0 else None
    futs, shed = [], 0
    for u in np.random.default_rng(0).integers(0, train.shape[0],
                                               args.requests):
        try:
            futs.append(server.submit(int(u), deadline_ms=deadline))
        except Overloaded:
            shed += 1
    res, expired = [], 0
    for f in futs:
        try:
            res.append(f.result(timeout=120))
        except DeadlineExceeded:
            expired += 1
    dt = time.perf_counter() - t0
    stop_log.set()
    server.stop()
    extra = (f", {shed} shed, {expired} expired"
             if shed or expired else "")
    print(f"{len(res)} requests{extra}, {len(res) / dt:.0f} req/s, "
          f"{_stats_line(server)}")
    if res:
        r = res[0]
        print(f"sample: user {r.user} → items {list(map(int, r.items))}")
    if args.metrics_dump:
        obs.export_metrics(args.metrics_dump)
        print(f"wrote {args.metrics_dump}")


if __name__ == "__main__":
    main()
