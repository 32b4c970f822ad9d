"""The per-stage readers (``cfbench/spans.py`` and the six metrics that
call it) on a synthetic Chrome trace, the root names against the spans the
port's facade opens, and the readers in a traced run on the CPU."""

import pytest

from cfbench.tests import tiny
from cfbench import spans, trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def rt(name, ts):
    return ev(name, "cuda_runtime", ts, 1)


# two traced steps (0-100, 110-200), a fit inside each (10-60, 120-170),
# and one before the window (the profiler's warming step)
EVENTS = [
    ev("cfbench.step", "user_annotation", 0, 100),
    ev("cfbench.step", "user_annotation", 110, 90),
    ev("engine.fit", "user_annotation", -50, 30),
    rt("cudaLaunchKernel", -40),
    ev("engine.fit", "user_annotation", 10, 50),
    ev("engine.fit", "user_annotation", 120, 50),
    ev("topk.merge", "user_annotation", 20, 20),
    ev("aten::sort", "cpu_op", 21, 5),
    # stream submissions: 5 inside the fits, 3 outside (the harness's)
    rt("cudaLaunchKernel", 12), rt("cudaLaunchKernelExC", 20),
    rt("cudaMemcpyAsync", 30), ev("cuLaunchKernel", "cuda_driver", 125, 1),
    rt("cudaMemsetAsync", 130),
    rt("cudaLaunchKernel", 5), rt("cudaLaunchKernel", 80),
    rt("cudaMemcpyAsync", 180),
    # host waits: 4 inside, 1 outside
    rt("cudaStreamSynchronize", 40), rt("cudaDeviceSynchronize", 55),
    rt("cudaMemcpy", 140), rt("cudaEventSynchronize", 150),
    rt("cudaStreamSynchronize", 90),
    # device busy 15-35, 45-50, 70-95, 125-160
    ev("imma_kernel", "kernel", 15, 20),
    ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 45, 5),
    ev("predict_int8_kernel", "kernel", 70, 25),
    ev("imma_kernel", "kernel", 125, 35),
    ev("engine.fit", "gpu_user_annotation", 10, 50),
]


def with_root(root):
    """EVENTS with the fits' root spans renamed ``root``."""
    return [dict(e, name=root) if e["name"] == spans.FIT_ROOT else e
            for e in EVENTS]


@pytest.mark.parametrize("root,other", [
    (spans.FIT_ROOT, spans.RECOMMEND_ROOT),
    (spans.RECOMMEND_ROOT, spans.FIT_ROOT)])
def test_readings_inside_the_roots(root, other):
    tr = trace.Trace(with_root(root))
    assert spans.roots(tr, root) == [(10, 60), (120, 170)]
    # 5 submissions and 4 waits start inside the two calls
    assert spans.launches(tr, root) == 2.5
    assert spans.syncs(tr, root) == 2.0
    # idle 0-15, 35-45, 50-70, 95-125, 160-200; inside the calls 10-15,
    # 35-45, 50-60 and 120-125, 160-170: 40 µs over 2 calls
    assert abs(spans.host_idle_ms(tr, root) - 0.020) < 1e-12
    assert spans.launches(tr, other) is None


def test_no_root_reads_none():
    parent = trace.Trace([e for e in EVENTS
                          if e["name"] != spans.FIT_ROOT])
    for f in (spans.launches, spans.syncs, spans.host_idle_ms):
        assert f(parent, spans.FIT_ROOT) is None
        assert f(trace.Trace([]), spans.FIT_ROOT) is None


@pytest.mark.parametrize("metric,want", [
    ("launches.fit", 2.5), ("syncs.fit", 2.0), ("host_idle_ms.fit", 0.020),
    ("launches.recommend", None), ("syncs.recommend", None),
    ("host_idle_ms.recommend", None)])
def test_metric_files_read_the_trace(metric, want):
    from types import SimpleNamespace
    from cfbench import harness
    got = harness.reader_for(metric).read(
        SimpleNamespace(trace=trace.Trace(EVENTS), work={"fit": None}))
    assert got == want if want is None else abs(got - want) < 1e-12


def test_root_names_are_the_facades():
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.facade import CFEngine
    rng = np.random.default_rng(5)
    r = ((rng.random((40, 30)) < 0.4)
         * rng.integers(1, 6, (40, 30))).astype(np.float32)
    obs.clear()
    eng = CFEngine(r, k=5, device="cpu").fit()
    eng.recommend(n=3)
    got = {s.name for s in obs.get_spans() if s.parent_id == 0}
    assert {spans.FIT_ROOT, spans.RECOMMEND_ROOT} <= got


def test_readers_in_a_traced_cpu_run(tmp_path, monkeypatch):
    """On the CPU no call reaches a device: no launch, no wait, and the
    whole of each call idle; every new metric is on the result line."""
    from cfbench import harness
    monkeypatch.setattr(harness, "UNTRACED_SECONDS", 0.05)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.05)
    here = tiny.tiny_tree(tmp_path)
    for cell, stage in (("ml1m.refit", "fit"),
                        ("netflix.recommend", "recommend")):
        out = tiny.run(here, cell, trace=True)
        got = {k: v["value"] for k, v in out["metrics"].items()}
        assert out["correct"]
        assert got[f"launches.{stage}"] == 0.0
        assert got[f"syncs.{stage}"] == 0.0
        assert got[f"host_idle_ms.{stage}"] > 0.0
