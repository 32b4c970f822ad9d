"""Each ported package exports the reference package's public names: a
port's ``__all__`` equals the reference's less an explicit list of names
whose modules are not ported yet, and every exported name imports."""

import importlib

import pytest

# reference names whose code the port has not ported (yet)
NOT_PORTED = {
    "configs": set(),
    "core": set(),
    "data": set(),
    "index": set(),
    "kernels": set(),
    "obs": set(),
}
# names the port exports beyond the reference's
PORT_ONLY = {"configs": {"TensorSpec"}}


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_port_exports_the_reference_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref_all, port_all = set(ref.__all__), set(port.__all__)
    assert ref_all - port_all == NOT_PORTED[pkg], pkg
    assert port_all - ref_all == PORT_ONLY.get(pkg, set()), pkg
    for name in port_all:
        assert getattr(port, name, None) is not None, f"{pkg}.{name}"
    for name in NOT_PORTED[pkg]:
        assert not hasattr(port, name), f"{pkg}.{name} is ported now"
