"""Port parity: the numpy MovieLens surrogate is byte-identical to the
reference generator and split for the same spec and seed."""

import dataclasses

import numpy as np
import pytest

from repro.data import movielens as ref_ml
from repro_torch.data import movielens as port_ml

CASES = [(64, 48, 0), (200, 120, 3), (97, 61, 11)]


@pytest.mark.parametrize("users,items,seed", CASES)
def test_generator_and_split_byte_identical(users, items, seed):
    ref_spec = ref_ml.MovieLensSpec(seed=seed).scaled(users, items)
    port_spec = port_ml.MovieLensSpec(seed=seed).scaled(users, items)
    assert dataclasses.asdict(ref_spec) == dataclasses.asdict(port_spec)
    want = ref_ml.generate_ratings(ref_spec)
    got = port_ml.generate_ratings(port_spec)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    r_tr, r_te = ref_ml.train_test_split(want, seed=seed + 1)
    p_tr, p_te = port_ml.train_test_split(got, seed=seed + 1)
    assert p_tr.tobytes() == r_tr.tobytes()
    assert p_te.tobytes() == r_te.tobytes()


@pytest.mark.parametrize("users,items,seed", CASES)
def test_load_ml1m_synthetic_byte_identical(users, items, seed):
    want = ref_ml.load_ml1m_synthetic(n_users=users, n_items=items,
                                      seed=seed)
    got = port_ml.load_ml1m_synthetic(n_users=users, n_items=items,
                                      seed=seed)
    for g, w in zip(got[:2], want[:2]):
        assert g.tobytes() == w.tobytes()
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    # every user keeps at least one training rating (means stay defined)
    assert ((got[0] > 0).sum(axis=1) >= 1).all()
    assert np.isin(np.unique(got[0]), np.arange(6)).all()
