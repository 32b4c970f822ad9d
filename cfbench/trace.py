"""Reduction of a ``torch.profiler`` trace of the benchmark's steps to the
numbers the per-layer readers take: device time by kernel, the device's
busy time within the traced steps, and its idle gaps named by what the
host was doing.

The trace is the profiler's Chrome trace (CUPTI's device activity beside
the host's operators).  The traced window runs from the start of the first
``cfbench.step`` span to the end of the last; every step ends in a device
synchronise, so each step's device work lies inside its span.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

STEP_SPAN = "cfbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_WALK = 4096                    # host operators searched back from a gap
_ANON = re.compile(r"\(anonymous namespace\)::")


def short_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces and
    its parameter list, template arguments kept."""
    s = _ANON.sub("", name)
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for pos, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and pos > 0:
            return s[:pos].strip()
    return s.strip()


def base_name(name: str) -> str:
    """The function's own name: ``imma_kernel`` for
    ``void (anonymous namespace)::imma::imma_kernel<2, false>(...)``."""
    return short_name(name).split("<")[0].split("::")[-1].strip()


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Trace:
    """Device activity of the traced steps (times in seconds)."""

    def __init__(self, events):
        steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name") == STEP_SPAN
                 and e.get("cat") == "user_annotation"]
        self.steps = len(steps)
        if not steps:
            self.window = (0.0, 0.0)
            self.device, self.host, self._busy = [], [], []
            return
        lo, hi = min(s[0] for s in steps), max(s[1] for s in steps)
        self.window = (lo, hi)

        def clip(e):
            a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
            return (a, b) if b > a else None

        self.device = []        # (name, start µs, end µs), clipped
        self.host = []          # (name, start µs, end µs)
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            span = clip(e)
            if span is None:
                continue
            if e.get("cat") in DEVICE_CATS:
                self.device.append((e["name"], *span))
            elif e.get("cat") in HOST_CATS and e.get("name") != STEP_SPAN:
                self.host.append((e["name"], e["ts"], e["ts"] + e["dur"]))
        self._busy = _union((a, b) for _, a, b in self.device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-6

    def device_seconds(self, names=None, exclude=False) -> float:
        """Device seconds of the operations whose :func:`base_name` is in
        ``names`` (all operations when None; all but those with
        ``exclude``)."""
        tot = 0.0
        for name, a, b in self.device:
            if names is None or (base_name(name) in names) != exclude:
                tot += b - a
        return tot * 1e-6

    def device_ops(self, top: int = 10):
        """The ``top`` device operations by total seconds."""
        by = {}
        for name, a, b in self.device:
            key = short_name(name)[:120]
            by[key] = by.get(key, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle device time within the window, summed by the innermost host
        operation running at each gap's middle, the ``top`` largest."""
        lo, hi = self.window
        edges, prev = [], lo
        for a, b in self._busy:
            if a > prev:
                edges.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            edges.append((prev, hi))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = {}
        for a, b in edges:
            mid = 0.5 * (a + b)
            # host operators nest: the innermost one holding ``mid`` is the
            # latest-starting one that has not ended
            label = "host outside any operator"
            top_pos = bisect.bisect_right(starts, mid) - 1
            for pos in range(top_pos, max(-1, top_pos - _WALK), -1):
                if host[pos][2] >= mid:
                    label = host[pos][0][:120]
                    break
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def from_profiler(prof) -> Trace:
    """Export ``prof``'s Chrome trace to a temporary file, read it, and
    delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="cfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.unlink(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return Trace(events)
