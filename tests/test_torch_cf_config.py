"""Port parity: the paper's CF config (``repro_torch.configs.
cf_movielens``), its shape cells and steps against the reference's.

* ``get_arch("cf_movielens")`` field for field the reference's ``ARCH``
  (config, smoke config, shape cells, optimizer), and ``ASSIGNED``;
* ``input_specs`` of the three CF cells: the reference's shapes, f32;
* ``build_step``'s ``cf_fit`` / ``cf_predict`` on the default one-rank
  gloo mesh and on an explicit mesh: the fit bit for bit ``UserCF``'s,
  the prediction within 1e-5 of its ``predict`` (the ring predictor sums
  in another order); the step plans' example shapes;
* the reference's ``test_models_smoke.py::test_cf_smoke`` on the port.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.configs import registry as jreg
from repro_torch.configs import ASSIGNED, TensorSpec, get_arch, input_specs
from repro_torch.core import engine as E
from repro_torch.core.cf_model import CFConfig, UserCF
from repro_torch.launch.steps import build_step

REF = importlib.import_module("repro.configs.cf_movielens").ARCH


@pytest.fixture(scope="module")
def arch():
    return get_arch("cf_movielens")


def test_arch_matches_reference(arch):
    assert get_arch("cf-movielens") is arch
    for field in ("name", "kind", "optimizer", "model"):
        assert getattr(arch, field) == getattr(REF, field), field
    assert isinstance(arch.config, CFConfig)
    assert dataclasses.asdict(arch.config) == dataclasses.asdict(REF.config)
    assert dataclasses.asdict(arch.smoke_config()) == \
        dataclasses.asdict(REF.smoke_config())
    assert [dataclasses.asdict(c) for c in arch.shapes] == \
        [dataclasses.asdict(c) for c in REF.shapes]
    assert arch.config.engine == "ring" and arch.config.top_k == 40


def test_assigned_matches_reference():
    assert ASSIGNED == jreg.ASSIGNED
    assert "cf_movielens" not in ASSIGNED


@pytest.mark.parametrize("cell", ["fit_ml1m", "fit_1m_users",
                                  "predict_bulk"])
def test_input_specs_match_reference(arch, cell):
    got = input_specs(arch, arch.cell(cell))
    want = jreg.input_specs(REF, REF.cell(cell))
    assert got.keys() == want.keys() == {"ratings"}
    assert got["ratings"] == TensorSpec(tuple(want["ratings"].shape),
                                        torch.float32)
    assert str(want["ratings"].dtype) == "float32"


def test_step_plans(arch):
    fit = build_step(arch, arch.cell("fit_1m_users"))
    assert fit.name == "cf-movielens:fit_1m_users"
    assert fit.example_args == {
        "ratings": TensorSpec((1048576, 65536), torch.float32)}
    pred = build_step(arch, arch.cell("predict_bulk"))
    assert pred.example_args == {
        "ratings": TensorSpec((1048576, 65536), torch.float32),
        "scores": TensorSpec((1048576, 40), torch.float32),
        "idx": TensorSpec((1048576, 40), torch.int32)}
    with pytest.raises(ValueError):
        build_step(arch, dataclasses.replace(arch.cell("fit_ml1m"),
                                             step="cf_train"))


def _small(arch, engine):
    return dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, top_k=8, block_size=64, engine=engine))


@pytest.mark.parametrize("engine", ["ring", "sharded"])
@pytest.mark.parametrize("explicit_mesh", [False, True])
def test_cf_steps_equal_usercf(ml_small, arch, engine, explicit_mesh):
    """One rank: the fit step (by ``config.engine``) == ``UserCF``'s
    sequential fit bit for bit; the predict step within 1e-5."""
    small = _small(arch, engine)
    mesh = E.default_mesh("cpu") if explicit_mesh else None
    r = torch.from_numpy(ml_small[0])
    s, i = build_step(small, small.cell("fit_ml1m"), mesh).fn(
        {"ratings": r})
    cf = UserCF(dataclasses.replace(small.config, engine="sequential"),
                device="cpu")
    st = cf.fit(r)
    assert_parity(f"steps.cf_fit.{engine}.ids", i, st.idx)
    assert_parity(f"steps.cf_fit.{engine}.scores", s, st.scores)
    pred = build_step(small, small.cell("predict_bulk"), mesh).fn(
        {"ratings": r}, s, i)
    assert_parity(f"steps.cf_predict.{engine}", pred, cf.predict(r),
                  atol=1e-5)


def test_cf_smoke(ml_small, arch):
    """``test_models_smoke.py::test_cf_smoke`` on the port."""
    train, test, _ = ml_small
    cf = UserCF(arch.smoke_config(), device="cpu")
    cf.fit(train)
    ev = cf.evaluate(train, test)
    assert 0.5 < ev["mae"] < 1.5
    assert 0.0 <= ev["precision"] <= 1.0


def test_padded_users_fit_like_the_rest(arch):
    """``fit_ml1m`` pads the users to 6144 with all-zero rows: on the
    ring step (one rank) the padded fit equals ``UserCF``'s bit for bit,
    and every score kept is finite."""
    rng = np.random.default_rng(4)
    r = (rng.integers(1, 6, (60, 40)) * (rng.random((60, 40)) < 0.3))
    padded = torch.from_numpy(np.vstack([r, np.zeros((4, 40))])
                              .astype(np.float32))
    small = _small(arch, "ring")
    s, i = build_step(small, small.cell("fit_ml1m")).fn({"ratings": padded})
    st = UserCF(dataclasses.replace(small.config, engine="sequential"),
                device="cpu").fit(padded)
    assert torch.equal(i, st.idx) and torch.equal(s, st.scores)
    assert bool(torch.isfinite(s[s > -1e30]).all())
