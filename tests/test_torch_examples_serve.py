"""The port's serving example (``examples/torch_serve_recommendations.py``)
on the CPU against the reference's (``examples/serve_recommendations.py``),
both run as subprocesses with the same arguments, the port's with
``--device cpu``: in exact mode the update burst recomputes and merges the
same rows (a full refit on the ``kernel`` backend, as on the reference's
``pallas``), and every request is answered; in approx mode at 32 clusters,
16 probed, every request is answered and the recall@40 against the exact
engine is within 0.02 of the reference's (the two packages' proxies differ
in their last bits, so this is not a bitwise check)."""

import re

from _torch_parity import run_example_pair


def _update(out):
    m = re.search(r"\((\d+) rows recomputed, (\d+) merged\)", out)
    return int(m.group(1)), int(m.group(2))


def _answered(out):
    return int(re.search(r"^(\d+) requests in ", out, re.M).group(1))


def _recall(out):
    return float(re.search(r"recall@40 vs exact = ([\d.]+)", out).group(1))


def test_serve_exact_matches_reference():
    """The reference and the port on their default backend; the port also
    on ``kernel`` (the reference's ``pallas``; the plain versions here),
    whose update refits every row as the reference's ``pallas`` does."""
    ref, port, kernel = run_example_pair(
        "serve_recommendations", port_extras=((), ("--backend", "kernel")))
    print(ref, port, kernel, sep="\n")
    assert _update(ref) == (253, 771) and _answered(ref) == 64
    assert "engine fitted (sequential/exact)" in port
    assert _update(port) == _update(ref)
    assert _answered(port) == 64
    assert "engine fitted (kernel/exact)" in kernel
    assert _update(kernel) == (1024, 0)
    assert _answered(kernel) == 64


def test_serve_approx_matches_reference():
    args = ("--neighbor-mode", "approx", "--n-clusters", "32",
            "--n-probe", "16")
    ref, port = run_example_pair("serve_recommendations", args)
    print(ref, port, sep="\n")
    print(f"recall@40 vs exact: reference {_recall(ref)}, port "
          f"{_recall(port)}")
    assert _answered(port) == _answered(ref) == 64
    assert abs(_recall(port) - _recall(ref)) <= 0.02
    assert "index: 32 clusters, probe 16" in port
