"""Batched serving tier for recommendation requests, supervised (port of
``repro.serving.engine``).

Requests enqueue individually; a background batcher drains up to
``max_batch`` (or waits ``max_wait_ms``), pads user indices into a fixed
batch, runs the predictor once, and resolves per-request futures with
top-n items.  The server fronts a :class:`repro_torch.core.facade.CFEngine`
(``BatchingServer(engine)``): each batch reads the engine's atomically
published snapshot, so an ``update_ratings`` between batches is picked up
by the very next batch.  An engine built with ``backend="kernel"`` serves
every item tile through the CUDA tile-predict kernel, exactly as its
``recommend`` does, so a served answer equals ``engine.recommend`` for
that user.  An engine built with ``recommend_mode="approx"`` is served
through ``engine.recommend`` itself: the item index's two-stage path
(support kernel → select kernel → exact rerank), updates landing between
batches.  The legacy form ``BatchingServer(cf_model, ratings)`` fronts a
fitted :class:`repro_torch.core.cf_model.UserCF` and its rating matrix
as a static model: one snapshot, one gather source built at
construction, every batch through the CUDA tile-predict kernel on the
card (the plain item tiles on the CPU).

**Failure model.**  Every batch runs isolated: an exception resolves that
batch's futures with the error (``serve.failures``) and the batcher
survives — a future handed out by ``submit()`` ALWAYS resolves (result or
typed error), across faults, stop, and crash paths alike.  Transient
failures (:class:`~repro_torch.distributed.fault_tolerance.
TransientServeError`, which ``InjectedFault`` subclasses) are retried with
the bounded exponential backoff of a ``RecoveryPolicy``.

**Request lifecycle.**  ``submit(user, deadline_ms=...)`` attaches a
deadline: a request still queued when it passes resolves with
:class:`DeadlineExceeded` before compute is spent on it.  With
``max_queue > 0`` the queue is bounded and ``submit`` raises
:class:`Overloaded` at the high-water mark.  ``stop()`` drains (default) or
cancels the queue — either way nothing is stranded — and later
``submit()`` calls raise :class:`ServerStopped`.

**Degradation ladder.**  With a :class:`DegradationLadder` the server runs
the HEALTHY → DEGRADED → SHEDDING state machine on its windowed p99 /
queue depth and on ``StragglerWatchdog`` escalation; in SHEDDING, bulk
traffic is refused at admission.  Under degradation an approx-recommend
engine runs each request class at its own candidate budget
(``DegradationLadder.budget``: ``n_probe`` and ``shortlist`` shrink
multiplicatively per level, bulk one level worse than interactive), and
with ``staged_when_degraded`` every move above HEALTHY switches the
engine's user index to its staged query pipeline
(``index.query_mode_override = "staged"``); recovery to HEALTHY hands the
choice back to the index's config.

Telemetry goes through a :class:`repro_torch.obs.MetricsRegistry`:
per-request latency splits into queue wait and compute wait, each a
fixed-bucket histogram, so ``stats()`` reads one lock-consistent snapshot.
Percentiles are histogram bucket *upper bounds*.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cf_model import as_model_tensor
from repro_torch.core.predict import make_gather_source, recommend_block
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (RecoveryPolicy,
                                                     StragglerWatchdog,
                                                     TransientServeError)

_ITEM_BLOCK = 512      # plain-route predict tile: batch·k·tile intermediates

# health levels, in escalation order (gauge value = list index)
HEALTHY, DEGRADED, SHEDDING = 0, 1, 2
HEALTH_STATES = ("HEALTHY", "DEGRADED", "SHEDDING")

REQUEST_CLASSES = ("interactive", "bulk")


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed while it was still queued; resolved
    before compute was spent on it."""


class Overloaded(RuntimeError):
    """Admission refused: bounded queue at its high-water mark, or bulk
    traffic while the server is SHEDDING.  Retry with client backoff."""


class ServerStopped(RuntimeError):
    """The server was stopped: a post-stop ``submit()``, or a queued
    request the shutdown resolved instead of serving."""


@dataclasses.dataclass
class Recommendation:
    user: int
    items: np.ndarray
    scores: np.ndarray
    latency_ms: float


@dataclasses.dataclass
class DegradationLadder:
    """Config + transition logic for the serving health state machine.

    Escalation is immediate — one bad window (or watchdog escalation)
    steps up, a window past ``shed_p99_ms`` or ``max_queue_depth`` jumps
    straight to SHEDDING — while recovery is hysteretic: ``hold_windows``
    consecutive windows under ``recover_p99_ms`` step down one level.

    Quality budgets are multiplicative per level: at level ``L`` an
    approx-recommend engine runs ``n_probe ≈ base·n_probe_frac**L`` and
    ``shortlist ≈ base·shortlist_frac**L`` (floored at 1 / top-n), and
    ``bulk`` requests are served one level worse than ``interactive``.
    ``staged_when_degraded`` forces the approx engine's user index onto
    its staged query pipeline while degraded.  The instance is owned by
    one server and mutated only on its batcher thread.
    """
    degrade_p99_ms: float = 50.0
    shed_p99_ms: float = 200.0
    recover_p99_ms: float = 25.0
    max_queue_depth: float = 64.0
    window: int = 8                 # batches per health evaluation
    hold_windows: int = 2           # calm windows per step *down*
    n_probe_frac: float = 0.5
    shortlist_frac: float = 0.5
    staged_when_degraded: bool = True
    calm_windows: int = 0

    def budget(self, level: int, base_n_probe: int, base_shortlist: int,
               n_min: int) -> Optional[dict]:
        """Per-call candidate budgets for a request served at ``level``
        (None = config defaults, i.e. HEALTHY)."""
        if level <= HEALTHY:
            return None
        return {
            "n_probe": max(1, int(base_n_probe * self.n_probe_frac ** level)),
            "shortlist": max(n_min, int(base_shortlist
                                        * self.shortlist_frac ** level)),
        }

    def next_level(self, level: int, *, p99_ms: float, queue_depth: float,
                   straggler: bool) -> Tuple[int, str]:
        """One evaluation step: ``(new_level, reason)`` (reason empty when
        the level holds)."""
        if p99_ms >= self.shed_p99_ms or queue_depth >= self.max_queue_depth:
            self.calm_windows = 0
            return SHEDDING, (f"window p99 {p99_ms:.1f} ms / depth "
                              f"{queue_depth:.0f} over shed thresholds")
        if p99_ms >= self.degrade_p99_ms or straggler:
            self.calm_windows = 0
            reason = (f"window p99 {p99_ms:.1f} ms ≥ "
                      f"{self.degrade_p99_ms:.1f} ms"
                      if p99_ms >= self.degrade_p99_ms
                      else "straggler watchdog escalation")
            return max(level, DEGRADED), reason
        if level == HEALTHY:
            return HEALTHY, ""
        if p99_ms <= self.recover_p99_ms:
            self.calm_windows += 1
            if self.calm_windows >= self.hold_windows:
                self.calm_windows = 0
                return level - 1, (f"recovered: p99 {p99_ms:.1f} ms ≤ "
                                   f"{self.recover_p99_ms:.1f} ms for "
                                   f"{self.hold_windows} windows")
        else:
            self.calm_windows = 0
        return level, ""


class BatchingServer:
    def __init__(self, cf_model, ratings=None, *, max_batch: int = 16,
                 max_wait_ms: float = 20.0, topn: int = 10,
                 registry: Optional[obs.MetricsRegistry] = None,
                 max_queue: int = 0,
                 recovery: Optional[RecoveryPolicy] = None,
                 fault_injector=None,
                 ladder: Optional[DegradationLadder] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self._approx_engine = None
        self._base_n_probe = 0
        self._base_shortlist = 0
        if ratings is not None:
            self._init_legacy(cf_model, ratings)
        else:
            self._init_facade(cf_model)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.topn = topn
        self.max_queue = int(max_queue)
        # maxsize 0 = unbounded, matching queue.Queue — admission control
        # activates with the bound
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # supervision: retry budget + backoff for transient batch failures,
        # optional deterministic fault injection (drills), optional
        # degradation ladder + straggler watchdog
        self._recovery = recovery if recovery is not None else \
            RecoveryPolicy(max_restarts=3)
        self._injector = fault_injector
        self._ladder = ladder
        self._watchdog = watchdog if watchdog is not None else \
            (StragglerWatchdog() if ladder is not None else None)
        # cross-thread control state: submit()/stats() read while stop()
        # and the batcher write — every access goes through _state_lock
        self._state_lock = threading.Lock()
        self._stopped = False
        self._drain = True
        self._health = HEALTHY
        # batcher-thread-only bookkeeping (never touched by callers)
        self._batch_seq = 0
        self._window_n = 0
        self._prev_lat = None
        self._prev_depth = None
        # telemetry: histograms in a registry (per-server by default so
        # tests stay isolated); the batcher observes, stats() snapshots —
        # both under the registry lock
        self.registry = registry if registry is not None \
            else obs.MetricsRegistry()
        self._h_latency = self.registry.histogram("serve.latency_seconds")
        self._h_queue = self.registry.histogram("serve.queue_seconds")
        self._h_compute = self.registry.histogram("serve.compute_seconds")
        self._h_fill = self.registry.histogram("serve.batch_fill")
        self._h_depth = self.registry.histogram("serve.queue_depth")
        self._c_requests = self.registry.counter("serve.requests")
        self._c_batches = self.registry.counter("serve.batches")
        self._c_failures = self.registry.counter("serve.failures")
        self._c_retries = self.registry.counter("serve.retries")
        self._c_recoveries = self.registry.counter("serve.recoveries")
        self._c_shed = self.registry.counter("serve.shed")
        self._c_deadline = self.registry.counter("serve.deadline_exceeded")
        self._c_transitions = self.registry.counter(
            "serve.health.transitions")
        self._g_health = self.registry.gauge("serve.health")
        self._g_health.set(HEALTHY)
        # warm the predictor (and build/load the kernels) at the batch shape
        self._run_padded(np.zeros((self.max_batch,), np.int64))

    def _init_facade(self, engine) -> None:
        """A ``CFEngine``: snapshot() hands a consistent model view even
        while update_ratings runs on another thread."""
        if getattr(engine, "scores", None) is None:
            raise ValueError("fit the engine first")
        if engine.device.type != self.device.type:
            raise ValueError(f"engine lives on {engine.device} but the "
                             f"server was asked for {self.device}")
        self._snapshot = engine.snapshot
        self._n_users = int(engine.n_users)
        self._gather = engine._gather_source
        self._use_kernel = bool(engine.use_kernel)
        # two-stage serving: candidate items from the item index, exact
        # rerank, through engine.recommend (the batcher is the only
        # recommend caller, so it sees each update whole)
        if getattr(engine, "recommend_mode", "exact") == "approx":
            self._approx_engine = engine
            self._base_n_probe = int(engine.item_index.n_probe)
            self._base_shortlist = int(engine.item_index.cfg.shortlist)

    def _init_legacy(self, cf_model, ratings) -> None:
        """A fitted ``UserCF`` and its (U, I) ratings: a static model, so
        one snapshot and one gather source serve every batch."""
        if cf_model.state is None:
            raise ValueError("fit the model first")
        st = cf_model.state
        if st.scores.device.type != self.device.type:
            raise ValueError(f"model on {st.scores.device} but the server "
                             f"was asked for {self.device}")
        ratings = as_model_tensor(ratings, self.device)
        snap = (ratings, st.scores, st.idx, st.means)
        src = make_gather_source(ratings)
        self._snapshot = lambda: snap
        self._n_users = int(ratings.shape[0])
        self._gather = lambda _ratings: src
        self._use_kernel = True

    def _run_padded(self, users: np.ndarray, budget: Optional[dict] = None):
        if self._approx_engine is not None:
            return self._approx_engine.recommend(users, n=self.topn,
                                                 **(budget or {}))
        ratings, scores, idx, means = self._snapshot()
        u = torch.as_tensor(users, device=ratings.device)
        return recommend_block(ratings, self._gather(ratings), scores[u],
                               idx[u], means, means[u], u, n=self.topn,
                               item_block=_ITEM_BLOCK,
                               use_kernel=self._use_kernel)

    # -- public API --------------------------------------------------------
    @property
    def n_batches(self) -> int:
        """Batches served so far (lock-consistent registry read)."""
        return int(self.registry.snapshot()["counters"]
                   .get("serve.batches", 0))

    @property
    def health(self) -> str:
        with self._state_lock:
            return HEALTH_STATES[self._health]

    def submit(self, user: int, *, deadline_ms: Optional[float] = None,
               request_class: str = "interactive") -> Future:
        """Enqueue one request; the returned future ALWAYS resolves.

        ``deadline_ms``: budget from now — still queued past it, the
        future resolves with :class:`DeadlineExceeded` before compute.
        ``request_class``: ``"interactive"`` (default) or ``"bulk"`` (shed
        first).  Raises ``ValueError`` for an unknown user,
        :class:`Overloaded` at the admission bound and
        :class:`ServerStopped` once stopped — all *before* a future
        exists, so a raised submit never strands anything.
        """
        if request_class not in REQUEST_CLASSES:
            raise ValueError(f"unknown request_class {request_class!r}; "
                             f"want one of {REQUEST_CLASSES}")
        # checked here, not on the device: an out-of-range gather on a
        # CUDA tensor is a device-side assert that poisons the context
        if not 0 <= user < self._n_users:
            raise ValueError(f"user {user} out of range [0, {self._n_users})")
        fut: Future = Future()
        t0 = time.perf_counter()
        dl = None if deadline_ms is None else t0 + deadline_ms / 1e3
        # enqueue under the state lock: stop() flips _stopped under the
        # same lock *before* its final flush, so a request admitted here
        # is either served, drained, or flushed — never stranded.  The
        # shed counter is recorded *after* the lock is released (every
        # registry instrument shares the registry's lock, and nesting it
        # under _state_lock would add a lock-order edge)
        shed: Optional[Overloaded] = None
        with self._state_lock:
            if self._stopped:
                raise ServerStopped(
                    "submit() after stop(): the queue is no longer drained")
            if request_class == "bulk" and self._health >= SHEDDING:
                shed = Overloaded("shedding bulk traffic (health=SHEDDING)")
            else:
                try:
                    self._q.put_nowait((user, t0, dl, request_class, fut))
                except queue.Full:
                    shed = Overloaded(
                        f"admission queue at high-water mark "
                        f"({self.max_queue}); retry with backoff")
        if shed is not None:
            self._c_shed.inc()
            raise shed
        self._c_requests.inc()
        return fut

    def start(self):
        with self._state_lock:
            if self._stopped:
                raise ServerStopped("server already stopped")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, *, drain: bool = True, timeout: float = 30.0):
        """Stop the batcher; idempotent.  ``drain=True`` (default) serves
        everything already queued first; ``drain=False`` resolves queued
        futures with :class:`ServerStopped`.  Either way, when this
        returns no submitted future is unresolved."""
        with self._state_lock:
            self._stopped = True
            self._drain = drain
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        # whatever is still queued (drain=False, a submit that raced the
        # flag, or a batcher that died) resolves here — never strands
        self._flush_queue(ServerStopped(
            "server stopped before serving this request"))

    # -- batcher -----------------------------------------------------------
    def _flush_queue(self, exc: BaseException) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if not item[4].done():
                item[4].set_exception(exc)

    def _loop(self):
        try:
            while not self._stop.is_set():
                batch = self._gather_batch()
                if batch:
                    self._run_batch(batch)
            with self._state_lock:
                drain = self._drain
            if drain:
                while True:
                    batch = self._gather_batch(drain=True)
                    if not batch:
                        break
                    self._run_batch(batch)
        finally:
            # if the batcher exits for ANY reason with requests still
            # queued, mark the server stopped (so submit raises instead of
            # feeding a dead queue) and resolve the leftovers
            with self._state_lock:
                self._stopped = True
            self._flush_queue(ServerStopped(
                "batcher exited before serving this request"))

    def _gather_batch(self, drain: bool = False) -> list:
        batch: list = []
        if drain:
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            return batch
        deadline = None
        while len(batch) < self.max_batch:
            timeout = self.max_wait if deadline is None else \
                max(deadline - time.perf_counter(), 0)
            try:
                batch.append(self._q.get(timeout=max(timeout, 1e-3)))
            except queue.Empty:
                break
            if deadline is None:
                deadline = time.perf_counter() + self.max_wait
            if time.perf_counter() >= deadline or self._stop.is_set():
                break
        return batch

    def _run_batch(self, batch: list) -> None:
        """Supervised batch execution: deadline triage, bounded retry on
        transient failures, resolve-with-error on everything else.  The
        batcher thread survives every path."""
        now = time.perf_counter()
        live = []
        for req in batch:
            dl = req[2]
            if dl is not None and now >= dl:
                # expired in queue: resolve before compute is wasted
                self._c_deadline.inc()
                req[4].set_exception(DeadlineExceeded(
                    f"deadline passed {(now - dl) * 1e3:.1f} ms ago while "
                    f"queued"))
            else:
                live.append(req)
        if not live:
            return
        self._batch_seq += 1
        seq = self._batch_seq
        attempt = 0
        while True:
            try:
                if self._injector is not None:
                    self._injector.check(seq)
                self._execute(live, seq)
                if attempt:
                    self._c_recoveries.inc()
                return
            except TransientServeError as e:
                # recorded BEFORE the retry decision: a recovery can never
                # look like healthy batches in the metrics
                self._c_failures.inc()
                self._recovery.record_failure()
                live = [r for r in live if not r[4].done()]
                if attempt >= self._recovery.max_restarts or not live:
                    for r in live:
                        r[4].set_exception(e)
                    return
                attempt += 1
                self._c_retries.inc()
                self._recovery.record_restart()
                with obs.span("serve.recover", batch_seq=seq,
                              attempt=attempt, error=type(e).__name__):
                    time.sleep(self._recovery.backoff_s(attempt - 1))
            except Exception as e:
                # non-transient: fail the batch loudly — every pending
                # future gets the exception — and keep the batcher alive
                self._c_failures.inc()
                for r in live:
                    if not r[4].done():
                        r[4].set_exception(e)
                return

    def _execute(self, live: list, seq: int) -> None:
        self._c_batches.inc()
        # depth at launch: what this batch drained plus what is still queued
        self._h_depth.observe(len(live) + self._q.qsize())
        self._h_fill.observe(len(live) / self.max_batch)
        with obs.span("serve.batch", batch_size=len(live), batch_seq=seq):
            t_launch = time.perf_counter()
            for budget, cls, sub in self._plan(live):
                users = np.zeros((self.max_batch,), np.int64)
                for j, r in enumerate(sub):
                    users[j] = r[0]
                with obs.span("serve.predict", batch_size=len(sub),
                              request_class=cls, degraded=bool(budget)):
                    scores, items = self._run_padded(users, budget)
                    scores = scores.cpu().numpy()  # host copy = device fence
                    items = items.cpu().numpy()
                now = time.perf_counter()
                for j, (u, t0, _dl, _cls, fut) in enumerate(sub):
                    # per-request latency split: queue wait (enqueue →
                    # batch launch) + compute wait (launch → resolved)
                    self._h_queue.observe(max(t_launch - t0, 0.0))
                    self._h_compute.observe(now - t_launch)
                    lat = (now - t0) * 1e3
                    self._h_latency.observe(lat / 1e3)
                    fut.set_result(Recommendation(
                        user=u, items=items[j], scores=scores[j],
                        latency_ms=lat))
            compute_s = time.perf_counter() - t_launch
        self._after_batch(seq, compute_s)

    def _plan(self, live: list) -> List[tuple]:
        """Split the batch into (budget, class, requests) groups: one
        full-batch group while HEALTHY (or without a ladder or an
        approx-recommend engine); under degradation each request class
        runs at its own candidate budget — bulk one level worse than
        interactive."""
        if self._ladder is None or self._approx_engine is None:
            return [(None, "interactive", live)]
        with self._state_lock:
            level = self._health
        if level == HEALTHY:
            return [(None, "interactive", live)]
        groups: dict = {}
        for r in live:
            groups.setdefault(r[3], []).append(r)
        out = []
        for cls in sorted(groups):
            eff = level if cls == "interactive" else min(level + 1, SHEDDING)
            out.append((self._ladder.budget(eff, self._base_n_probe,
                                            self._base_shortlist, self.topn),
                        cls, groups[cls]))
        return out

    def _after_batch(self, seq: int, compute_s: float) -> None:
        """Feed the watchdog and, every ``ladder.window`` batches (or
        immediately on straggler escalation), evaluate the health level
        from windowed metrics."""
        straggler = False
        if self._watchdog is not None:
            self._watchdog.observe(seq, compute_s)
            straggler = self._watchdog.needs_escalation
        if self._ladder is None:
            return
        self._window_n += 1
        if self._window_n < self._ladder.window and not straggler:
            return
        self._window_n = 0
        snap = self.registry.snapshot()
        hl = snap["histograms"].get("serve.latency_seconds")
        hd = snap["histograms"].get("serve.queue_depth")
        p99_ms = (obs.delta_quantile(self._prev_lat, hl, 0.99) * 1e3
                  if hl else 0.0)
        depth = obs.delta_mean(self._prev_depth, hd) if hd else 0.0
        self._prev_lat, self._prev_depth = hl, hd
        with self._state_lock:
            level = self._health
        new, reason = self._ladder.next_level(level, p99_ms=p99_ms,
                                              queue_depth=depth,
                                              straggler=straggler)
        if new != level:
            self._transition(level, new, reason, p99_ms, depth)

    def _transition(self, old: int, new: int, reason: str, p99_ms: float,
                    depth: float) -> None:
        with self._state_lock:
            self._health = new
        self._g_health.set(new)
        self._c_transitions.inc()
        with obs.span("serve.health.transition",
                      from_state=HEALTH_STATES[old],
                      to_state=HEALTH_STATES[new], reason=reason,
                      p99_ms=round(p99_ms, 3), queue_depth=round(depth, 2)):
            # engine-side knob: the cheaper staged user-index pipeline
            # while degraded, the index's own resolution on recovery (the
            # per-class candidate budgets ride on each recommend call —
            # see _plan)
            eng = self._approx_engine
            if eng is not None and getattr(eng, "index", None) is not None \
                    and self._ladder.staged_when_degraded:
                eng.index.query_mode_override = \
                    "staged" if new > HEALTHY else None

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> dict:
        """Serving-tier health from one lock-consistent registry snapshot:
        latency percentiles (histogram bucket upper bounds), the
        queue-wait vs compute-wait split, batching efficiency, queue
        pressure, and the fault-tolerance counters (server lifetime)."""
        snap = self.registry.snapshot()
        hists = snap["histograms"]

        def mean(name):
            h = hists.get(name)
            return h["sum"] / h["count"] if h and h["count"] else 0.0

        def count(name):
            return int(snap["counters"].get(name, 0))

        lat = hists.get("serve.latency_seconds")
        n = lat["count"] if lat else 0
        return {
            "n_requests": count("serve.requests"),
            "n_batches": count("serve.batches"),
            "latency_p50_ms": (lat["p50"] * 1e3 if n else 0.0),
            "latency_p99_ms": (lat["p99"] * 1e3 if n else 0.0),
            "queue_wait_mean_ms": mean("serve.queue_seconds") * 1e3,
            "compute_mean_ms": mean("serve.compute_seconds") * 1e3,
            "mean_batch_fill": mean("serve.batch_fill"),
            "mean_queue_depth": mean("serve.queue_depth"),
            "n_failures": count("serve.failures"),
            "n_retries": count("serve.retries"),
            "n_recoveries": count("serve.recoveries"),
            "n_shed": count("serve.shed"),
            "n_deadline_exceeded": count("serve.deadline_exceeded"),
            "health": HEALTH_STATES[int(snap["gauges"]
                                        .get("serve.health", 0))],
        }
