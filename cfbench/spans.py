"""Reduction of a traced window (:class:`cfbench.trace.Trace`) over the
program's own stages: what the host did, and what the device did not,
while the host was inside one call of the program.

The port's spans (``repro_torch.obs``) open a ``record_function`` while the
profiler records, so each call of ``CFEngine.fit`` or ``CFEngine.recommend``
is a ``user_annotation`` event in ``Trace.host`` named by its root span
below, on the clock of the device activity.  A program without such spans
leaves the window with no root, and every reading here is then None.

Host calls are counted by where they start: a stream submission or a host
wait that starts inside a root span belongs to that call.
"""

from __future__ import annotations

import bisect

from cfbench.trace import _union

FIT_ROOT = "engine.fit"             # the root span of CFEngine.fit
RECOMMEND_ROOT = "engine.recommend"  # the root span of CFEngine.recommend

# stream submissions: kernel launches (runtime and driver API; the
# prefixes take the Ex forms), asynchronous copies and memsets
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCH_NAMES = ("cudaMemcpyAsync", "cudaMemsetAsync")
# host waits on the device; a plain cudaMemcpy blocks the host too
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES) or name in LAUNCH_NAMES


def is_sync(name: str) -> bool:
    return name in SYNC_NAMES


def roots(tr, root: str):
    """The ``root`` spans of the window as (start µs, end µs), in order."""
    return sorted((a, b) for name, a, b in tr.host if name == root)


def _inside(spans, t) -> bool:
    """Whether ``t`` lies in one of the merged, sorted ``spans``."""
    pos = bisect.bisect_right(spans, [t, float("inf")]) - 1
    return pos >= 0 and spans[pos][0] <= t <= spans[pos][1]


def count_per_root(tr, root: str, match):
    """Host calls whose name ``match``es and that start inside a ``root``
    span, per ``root`` span; None when the window holds none."""
    found = roots(tr, root)
    if not found:
        return None
    spans = _union(found)
    n = sum(1 for name, a, _ in tr.host if match(name) and _inside(spans, a))
    return n / len(found)


def launches(tr, root: str):
    """Stream submissions a ``root`` call issues."""
    return count_per_root(tr, root, is_launch)


def syncs(tr, root: str):
    """Host waits on the device a ``root`` call makes."""
    return count_per_root(tr, root, is_sync)


def host_idle_ms(tr, root: str):
    """Milliseconds a ``root`` call, inside the window, leaves the device
    idle; None when the window holds no ``root`` span."""
    found = roots(tr, root)
    if not found:
        return None
    lo, hi = tr.window
    busy = _union((a, b) for _, a, b in tr.device)
    idle, prev = [], lo
    for a, b in busy:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        idle.append((prev, hi))
    inside = _union((max(a, lo), min(b, hi)) for a, b in found)
    # both lists are sorted and disjoint: one sweep intersects them
    total, i, j = 0.0, 0, 0
    while i < len(inside) and j < len(idle):
        (a, b), (c, d) = inside[i], idle[j]
        total += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return 1e-3 * total / len(found)
