"""The trace reduction on a synthetic Chrome trace: the window, the
device's busy time, kernel time by name, and idle gaps by host operator."""

from cfbench.tests.tiny import ROOT  # noqa: F401  (puts the repo on the path)
from cfbench import trace

K1 = ("void (anonymous namespace)::imma::imma_kernel<2, false>(signed char "
      "const*, signed char const*, unsigned char const*)")
K2 = "void (anonymous namespace)::predict_int8_kernel<false>(signed char const*, int)"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("cfbench.step", "user_annotation", 100, 100),
    ev("cfbench.step", "user_annotation", 210, 90),
    ev("aten::sort", "cpu_op", 100, 40),
    ev("cudaLaunchKernel", "cuda_runtime", 102, 2),
    ev(K1, "kernel", 105, 30),
    ev(K2, "kernel", 120, 30),           # overlaps K1: union 105-150
    ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 160, 10),
    ev("cudaDeviceSynchronize", "cuda_runtime", 170, 30),
    ev(K1, "kernel", 220, 50),
    ev(K1, "kernel", 290, 40),           # clipped at the window's end, 300
    ev(K1, "kernel", 20, 10),            # before the window: left out
]


def test_window_busy_and_kernels():
    tr = trace.Trace(EVENTS)
    assert tr.steps == 2
    assert abs(tr.window_s - 200e-6) < 1e-12
    assert abs(tr.busy_s - (45 + 10 + 50 + 10) * 1e-6) < 1e-12
    assert abs(tr.device_seconds(("imma_kernel",)) - 90e-6) < 1e-12
    assert abs(tr.device_seconds(("imma_kernel",), exclude=True)
               - 40e-6) < 1e-12
    assert abs(tr.device_seconds() - 130e-6) < 1e-12
    ops = dict(tr.device_ops())
    assert abs(ops["imma::imma_kernel<2, false>"] - 90e-6) < 1e-12


def test_idle_gaps_named_by_host():
    gaps = dict(trace.Trace(EVENTS).idle_gaps())
    # 100-105 inside the launch (the innermost operator), 170-220 inside
    # the synchronise, 150-160 and 270-290 under no operator
    assert abs(gaps["cudaLaunchKernel"] - 5e-6) < 1e-12
    assert abs(gaps["cudaDeviceSynchronize"] - 50e-6) < 1e-12
    assert abs(gaps["host outside any operator"] - 30e-6) < 1e-12
    assert abs(sum(gaps.values()) - 85e-6) < 1e-12


def test_names():
    assert trace.base_name(K1) == "imma_kernel"
    assert trace.base_name(K2) == "predict_int8_kernel"
    assert trace.short_name(K2) == "predict_int8_kernel<false>"
    assert trace.base_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


def test_no_steps_no_window():
    tr = trace.Trace([ev(K1, "kernel", 0, 5)])
    assert tr.steps == 0 and tr.window_s == 0 and tr.busy_s == 0
