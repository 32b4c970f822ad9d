"""Retrace sentinel: count the port's run-time compile events per
measurement window (the counterpart of ``repro.analysis.retrace``).

The port compiles at run time too: ``kernels/_build.build`` runs ``nvcc``
for a kernel source whose library is missing, and ``kernels/_build.load``
opens a library on its first use in the process.  Either inside what a
benchmark believes is a warm window costs seconds to minutes of wall clock
that no kernel time shows.  The sentinel makes the invariant explicit:

    run_queries()                      # warm-up: first builds and loads
    with RetraceSentinel("bench.steady") as s:
        run_queries()                  # same shapes: no compile event
    assert s.count == 0

The events are read through ``kernels/_build.COMPILE_LISTENERS``.  There
is no ``watch(jit_fn)`` counterpart: the port has no per-function compile
cache (:class:`RetraceSentinel` says what else it keeps and leaves out).
On exit the sentinel sets the gauge ``analysis.retrace.count`` on
``repro_torch.obs.metrics.registry()``; :func:`steady_state_findings`
runs the check over the registered hot paths.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.analysis.findings import Finding
from repro_torch.kernels import _build

GAUGE = "analysis.retrace.count"

_mu = threading.Lock()
_active: List["RetraceSentinel"] = []


def _on_compile(event: str, name: str) -> None:
    with _mu:
        for s in _active:
            s.events.append((event, name))


class RetraceSentinel:
    """Context manager counting the kernels' build and load events in its
    window: ``count`` (set on exit), ``events`` as ``(event, kernel)``,
    and the gauge ``analysis.retrace.count`` with ``publish``.

    It keeps the reference sentinel's window, count and gauge, and leaves
    out ``watch(name, jit_fn)`` and ``per_site``: the port has no
    per-function compile cache to probe, since a kernel's library is
    built and loaded once a process for every shape."""

    def __init__(self, name: str = "retrace", *, publish: bool = True):
        self.name = name
        self.publish = publish
        self.events: List[Tuple[str, str]] = []
        self.count: Optional[int] = None

    def __enter__(self) -> "RetraceSentinel":
        self.events = []
        with _mu:
            if _on_compile not in _build.COMPILE_LISTENERS:
                _build.COMPILE_LISTENERS.append(_on_compile)
            _active.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        with _mu:
            if self in _active:
                _active.remove(self)
            self.count = len(self.events)
        if self.publish:
            obs.registry().gauge(GAUGE).set(float(self.count))
        return False


def steady_state_findings(hot_paths=None, device="cpu") -> List[Finding]:
    """Warm every registered hot path on ``device`` with its kernels on,
    then call it again with *fresh tensors of the same shapes* inside a
    sentinel: any build or load there is a finding.  The gauge
    ``analysis.retrace.count`` is set to the events of all the warm
    windows together."""
    from repro_torch.analysis import precision as P
    hps = P.HOT_PATHS if hot_paths is None else hot_paths
    dev = torch.device(device)
    out: List[Finding] = []
    total = 0
    for hp in hps:
        _, call, make_args, _names = hp.build(dev, True)
        call(*make_args())                       # warm-up: events expected
        with RetraceSentinel(f"{hp.name}.steady", publish=False) as s:
            call(*make_args())                   # same shapes, fresh tensors
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        total += s.count
        if s.count:
            out.append(Finding(
                check="retrace", path=hp.path, line=0, col=0,
                symbol=f"{hp.name}:steady-state",
                message=f"{hp.name} built or loaded a kernel library "
                        f"{s.count}× on a same-shape second call "
                        f"({s.events}) — a run-time compile inside a warm "
                        f"window burns wall clock silently"))
    obs.registry().gauge(GAUGE).set(float(total))
    return out
