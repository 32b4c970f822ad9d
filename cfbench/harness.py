"""One run of one cell: set-up, the measured window, the trace's reading,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, job or
per-layer metric is a file found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``job`` names
``jobs/<job>.py``) and ``metrics/<metric>.py``.  Adding any of them is
adding a file.

The window is closed: the step that crosses ``--seconds`` is finished, and
every end-to-end metric is taken over the span from the window's start to
that step's end.  With ``--trace 1`` the window runs two seconds (and at
least two steps) untraced, then starts the profiler, lets one step warm
it, records the next two seconds (at least two steps), and runs on
untraced to ``--seconds`` or past it; the result carries the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from cfbench import counts
from cfbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
UNTRACED_SECONDS = 2.0
TRACE_SECONDS = 2.0
TRACE_MIN_STEPS = 2


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, name: str, here: Path = HERE):
    """(workload entry, configuration, traffic) of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((here.parent / cfgs[cell["config"]]["file"])
                     .read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, cfg, traffic


def e2e_metrics(bench: dict, cell: str):
    """The end-to-end metrics the cell reports: those listing it, and those
    with no ``workloads`` list."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def layer_metrics(bench: dict, cell: str):
    """The per-layer metrics the cell reports: those listing it, and those
    with no list that move one of its end-to-end metrics."""
    moved = {m["name"] for m in e2e_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def job_for(traffic: dict, here: Path = HERE):
    path = here / "jobs" / f"{traffic['job']}.py"
    return load_module(path, f"cfbench_job_{traffic['job']}").Job


def reader_for(metric: str, here: Path = HERE):
    path = here / "metrics" / f"{metric}.py"
    return load_module(path, "cfbench_metric_" + metric.replace(".", "_"))


def forbidden_modules():
    """Top-level names of loaded modules that no run may hold."""
    roots = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(roots & set(FORBIDDEN))


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _card(device: str, chips: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float | None = None, here: Path = HERE,
        marks: dict | None = None):
    """Run the cell once; returns (the result line's object, the lines for
    standard error, each compared number beside its limit last), or
    raises.  ``t0`` is the process's start on ``time.perf_counter``'s
    clock; ``marks`` (name → seconds since ``t0``) are the caller's
    points of set-up, reported with the job's own on standard error."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = dict(marks or {})
    cell, cfg, traffic = load_cell(bench, cell_name, here)
    job = job_for(traffic, here)(cfg, traffic, seed, device)
    job.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    marks.update({name: at - t0 for name, at in
                  getattr(job, "marks", {}).items()})

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    # a traced run: untraced steps first (at least UNTRACED_SECONDS, whose
    # mean step time the mfu readers take), then the profiler's start (its
    # set-up is seconds), one step that warms it, then the traced steps
    # (at least TRACE_SECONDS and TRACE_MIN_STEPS), then the rest untraced
    phase = "untraced" if trace else "plain"
    clean = None                        # (seconds, steps) before the trace
    start = time.perf_counter()
    steps = 0
    while True:
        with (torch.profiler.record_function(trace_mod.STEP_SPAN)
              if phase == "traced" else contextlib.nullcontext()):
            job.step()
            _sync(device)
        steps += 1
        now = time.perf_counter()
        if phase == "untraced" and now - start >= UNTRACED_SECONDS \
                and steps >= TRACE_MIN_STEPS:
            clean = (now - start, steps)
            prof.start()
            phase = "warming"
        elif phase == "warming":
            phase, mark, traced_from = "traced", time.perf_counter(), steps
        elif phase == "traced" and now - mark >= TRACE_SECONDS \
                and steps - traced_from >= TRACE_MIN_STEPS:
            prof.stop()
            phase = "done"
        if now - start >= seconds and phase in ("plain", "done"):
            break
    window = now - start
    card = _card(device, cell["chips"])

    metrics = {}
    breakdown = None
    if not trace:
        units = {"seconds_per_step": window / steps,
                 "units_per_second": steps * getattr(job, "units", 1)
                 / window}
        for m in e2e_metrics(bench, cell_name):
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = units[traffic["e2e"][m["name"]]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr = trace_mod.from_profiler(prof)
        ctx = SimpleNamespace(trace=tr, step_s=clean[0] / clean[1],
                              work=job.work(),
                              peaks=counts.peaks_for(card["kind"]),
                              memory_peak_bytes=card["memory_peak_bytes"])
        for m in layer_metrics(bench, cell_name):
            value = reader_for(m["name"], here).read(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        card = dict(card, busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}

    job.release()
    checks = job.check()
    correct = all(value <= limit for value, limit in checks.values())
    out = {"correct": correct, "attempted": steps,
           "failed": getattr(job, "failed", 0), "metrics": metrics,
           "device": card}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, (value, limit) in checks.items()}
    card_line = power_limit() if device.startswith("cuda") else device
    points = ", ".join(f"{name} {at:.3f}" for name, at in
                       sorted(marks.items(), key=lambda kv: kv[1]))
    lines = [f"cell {cell_name} seed {seed}: {steps} steps in {window!r} s, "
             f"set-up {setup_s!r} s ({points}), card {card_line}"]
    lines += [f"check {name} {value!r} limit {limit!r}"
              for name, (value, limit) in checks.items()]
    return out, lines
