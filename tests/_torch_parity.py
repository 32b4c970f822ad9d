"""Shared parity helpers for the PyTorch port's tests (``test_torch_*``).

Inputs are made with numpy from a seed and handed to both packages; the
helpers compare a port result (torch tensor) with a reference result (jax
or numpy array): bitwise where the contract is exact, within a stated
absolute tolerance elsewhere.  Every comparison prints one
``PARITY <name> max_abs_diff=<x> atol=<t>`` line (``pytest -s`` shows
them), the source of the parity table in PERF.md.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def int_ratings(rng, u, d, density=0.4) -> np.ndarray:
    """Integer ratings 1..5 at ``density``, 0 = unrated, float32."""
    return (rng.integers(1, 6, (u, d))
            * (rng.random((u, d)) < density)).astype(np.float32)


def max_abs_diff(got, want) -> float:
    g = to_np(got).astype(np.float64)
    w = to_np(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.size == 0:
        return 0.0
    same_inf = np.isinf(g) & (g == w)
    with np.errstate(invalid="ignore"):
        return float(np.max(np.where(same_inf, 0.0, np.abs(g - w))))


def assert_parity(name: str, got, want, atol: float = 0.0) -> float:
    """Bitwise (``atol=0``) or ``atol``-close; prints the max diff."""
    d = max_abs_diff(got, want)
    print(f"PARITY {name} max_abs_diff={d!r} atol={atol!r}")
    if atol == 0.0:
        np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=name)
    else:
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=0,
                                   atol=atol, err_msg=name)
    return d


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """Run a test module's torch work on one intra-op thread.  The suite
    runs several pytest workers at once, and torch's default of one
    thread per core then oversubscribes the CPU: six concurrent runs of
    ``test_torch_item_index.py`` took 3.6× longer with the default.
    Import it into a module to turn it on there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_example_pair(name: str, args=(), port_extras=((),),
                     timeout: float = 300.0):
    """Stdouts of ``examples/<name>.py`` and of ``examples/torch_<name>.py``
    run as subprocesses, all started together: the reference's first, then
    one port run for each entry of ``port_extras`` (arguments added to
    ``args`` and ``--device cpu``); each must exit 0."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    runs = [(f"{name}.py", ())] + [
        (f"torch_{name}.py", (*extra, "--device", "cpu"))
        for extra in port_extras]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "examples" / script), *args, *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for script, extra in runs]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def load_example(name: str):
    """``examples/<name>.py`` imported as a module (not run)."""
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
