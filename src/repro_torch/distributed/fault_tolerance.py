"""Fault-tolerance substrate: failure detection, straggler watchdog.

Failures surface as raised exceptions from the runtime (a device fault,
a lost host) or as missing heartbeats.  The serving batcher
(``repro_torch.serving.engine``) retries transient failures under a
``RecoveryPolicy``, and the recovery logic is exercised in tests via
deterministic fault injection, and the training loop
(``repro_torch.training.train_loop``) restores from its latest committed
checkpoint under the same policy.  A copy of
``repro.distributed.fault_tolerance`` (standard library only).

Straggler policy: synchronous SPMD can't skip a slow worker, so mitigation
is detection + escalation: an EWMA watchdog flags steps slower than
``threshold×`` the running mean; persistent stragglers get reported to the
launcher for (simulated) hot-swap — at 1000+ nodes this is the difference
between a 2% and a 40% throughput loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


class TransientServeError(RuntimeError):
    """A failure the caller may retry: the operation left no partial
    state behind (or the state is repaired by re-running), so a bounded
    retry with backoff is safe.  The serving batcher retries these;
    anything else fails the batch immediately."""


class InjectedFault(TransientServeError):
    """Deterministic stand-in for a device/host failure.

    Transient by construction: :class:`FaultInjector` fires each
    configured step exactly once, so the retry after the fault passes —
    which is what makes recovery drills deterministic."""


@dataclasses.dataclass
class FaultInjector:
    """Raise ``InjectedFault`` at the configured steps (tests/drills)."""
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFault(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor; flags outliers and repeat offenders."""
    alpha: float = 0.1
    threshold: float = 2.0
    grace_steps: int = 5
    ewma: Optional[float] = None
    flagged_steps: List[int] = dataclasses.field(default_factory=list)
    consecutive: int = 0

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True when this step is a straggler."""
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_slow = step >= self.grace_steps and \
            seconds > self.threshold * self.ewma
        if is_slow:
            self.flagged_steps.append(step)
            self.consecutive += 1
        else:
            self.consecutive = 0
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_slow

    @property
    def needs_escalation(self) -> bool:
        """Persistent straggler → report to launcher for hot-swap."""
        return self.consecutive >= 3


@dataclasses.dataclass
class RecoveryPolicy:
    """How a supervised loop responds to failures.

    Counting is split from querying: ``record_failure()`` tallies every
    failure, ``can_restart`` is a pure probe of the remaining restart
    budget, and ``record_restart()`` consumes one unit when the caller
    actually restarts.

    ``backoff_s(attempt)`` is the bounded exponential retry delay the
    serving tier sleeps between attempts — attempt 0 waits
    ``backoff_base_s``, each further attempt multiplies by
    ``backoff_factor``, capped at ``backoff_max_s``.

    ``on_restore`` (the reference's training hook) is a callable of the
    step restored to; nothing in either package calls it, and it is kept
    so that a policy built for the reference builds here.
    """
    max_restarts: int = 3
    on_restore: Optional[Callable[[int], None]] = None
    restarts: int = 0
    failures: int = 0
    backoff_base_s: float = 0.005
    backoff_factor: float = 2.0
    backoff_max_s: float = 0.5

    def record_failure(self) -> None:
        """Tally a failure (every failure, restartable or not)."""
        self.failures += 1

    @property
    def can_restart(self) -> bool:
        """Pure probe: restart budget remains.  Mutates nothing."""
        return self.restarts < self.max_restarts

    def record_restart(self) -> None:
        """Consume one restart from the budget (call when restarting)."""
        self.restarts += 1

    def backoff_s(self, attempt: int = 0) -> float:
        """Retry delay before attempt ``attempt + 1`` (0-indexed)."""
        return min(self.backoff_base_s * self.backoff_factor ** max(attempt, 0),
                   self.backoff_max_s)

    def should_restart(self) -> bool:
        """Deprecated fused probe-and-consume (legacy callers only):
        records the failure and, if budget remains, consumes a restart.
        Return values match the old per-call increment semantics."""
        self.record_failure()
        if not self.can_restart:
            return False
        self.record_restart()
        return True
