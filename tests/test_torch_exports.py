"""Each ported package exports the reference package's public names: a
port's ``__all__`` equals the reference's less an explicit list of names
whose modules are not ported yet and of names whose tooling serves the
port as it is, and every exported name imports."""

import importlib

import pytest

# reference names whose code the port has not ported (yet)
NOT_PORTED = {
    "analysis": set(),
    "configs": set(),
    "core": set(),
    "data": set(),
    "index": set(),
    "kernels": set(),
    "obs": set(),
}
# names the port exports beyond the reference's
PORT_ONLY = {"configs": {"TensorSpec"}}
# reference names whose tooling already serves the port, so the port has
# no copy of its own: name -> why
_AST = "an AST check; python -m repro.analysis scans the port's sources"
SHARED = {"analysis": {
    "CHECKS": _AST,
    "analyze_paths": _AST,
    "run_local_checks": _AST,
    "load_baseline": "the AST checks' reprolint_baseline.json, which "
                     "covers the port's files too",
    "parse_suppressions": "the AST checks' inline suppressions",
    "report_json": "the AST checks' report",
    "report_sarif": "the AST checks' report",
    "CycleFinding": "the lock-order graph, which RaceTracer checks",
    "LockOrderGraph": "the lock-order graph, which RaceTracer checks",
    "METRICS_REGISTRY_LOCK": "a lock name of the lock-order graph",
    "RaceFinding": "the runtime race tracer the port's concurrency tests "
                   "use as it is (it imports no JAX)",
    "RaceTracer": "the runtime race tracer the port's concurrency tests "
                  "use as it is (it imports no JAX)",
}}


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_port_exports_the_reference_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref_all, port_all = set(ref.__all__), set(port.__all__)
    assert ref_all - port_all == NOT_PORTED[pkg] | set(SHARED.get(pkg, ())), \
        pkg
    assert port_all - ref_all == PORT_ONLY.get(pkg, set()), pkg
    for name in port_all:
        assert getattr(port, name, None) is not None, f"{pkg}.{name}"
    for name in NOT_PORTED[pkg] | set(SHARED.get(pkg, ())):
        assert not hasattr(port, name), f"{pkg}.{name} is ported now"
