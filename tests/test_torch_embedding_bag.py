"""The port's embedding bag (``repro_torch.kernels.embedding_bag``: the
plain version of the CUDA kernel; ``kernels.ref.embedding_bag_ref``; the
``kernels.ops`` dispatch) against the JAX reference on the CPU.

The plain version sums the valid rows in f32 in slot order, as the Pallas
kernel does, so it equals the Pallas kernel in interpret mode bit for bit
(f32 and bf16 tables).  The oracles (the reference's ``ref.
embedding_bag_ref`` and ``models.embedding.embedding_bag_xla``, the
port's ``embedding_bag_ref``) sum in the table's dtype in XLA's / torch's
order: within 1e-5 on f32 tables, as ``tests/test_kernels.py`` holds the
Pallas kernel to the oracle.  Inputs come from seeded numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as pallas_bag
from repro.models.embedding import embedding_bag_xla as jax_bag_xla
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)

TOL = 1e-5

# (V, D, B, L, seed): V 8-200, D ∈ {1, 8, 10, 16}, B 1-8, L 1-6
SWEEP = [(8, 1, 1, 1, 0), (200, 8, 8, 6, 1), (37, 10, 3, 4, 2),
         (64, 16, 5, 2, 3), (150, 1, 8, 5, 4), (9, 10, 1, 6, 5),
         (121, 16, 2, 3, 6), (50, 8, 7, 1, 7)]


def _inputs(v, d, b, l, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l,seed", SWEEP)
def test_plain_matches_pallas_and_oracles(v, d, b, l, seed, combiner):
    table, idx = _inputs(v, d, b, l, seed)
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    jt, ji = jnp.asarray(table), jnp.asarray(idx)
    name = f"bag.{combiner}.V{v}.D{d}.B{b}.L{l}"
    got = embedding_bag_plain(tt, ti, combiner=combiner)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    assert_parity(f"{name}.vs_pallas_interpret", got,
                  pallas_bag(jt, ji, combiner=combiner, interpret=True))
    assert_parity(f"{name}.vs_ref", got,
                  jref.embedding_bag_ref(jt, ji, combiner=combiner), TOL)
    assert_parity(f"{name}.vs_xla", got,
                  jax_bag_xla(jt, ji, combiner=combiner), TOL)
    port_oracle = tref.embedding_bag_ref(tt, ti, combiner=combiner)
    assert_parity(f"{name}.port_oracle_vs_ref", port_oracle,
                  jref.embedding_bag_ref(jt, ji, combiner=combiner), TOL)
    # the wrapper on a CPU tensor is the plain version; int64 ids alike
    assert torch.equal(embedding_bag(tt, ti, combiner=combiner), got)
    assert torch.equal(embedding_bag_plain(tt, ti.long(), combiner=combiner),
                       got)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l,seed", [(200, 16, 6, 5, 11),
                                          (20, 10, 3, 3, 12)])
def test_plain_matches_pallas_bf16(v, d, b, l, seed, combiner):
    table, idx = _inputs(v, d, b, l, seed)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    got = embedding_bag_plain(tt, torch.from_numpy(idx), combiner=combiner)
    assert got.dtype == torch.bfloat16
    want = pallas_bag(jt, jnp.asarray(idx), combiner=combiner,
                      interpret=True)
    assert_parity(f"bag.bf16.{combiner}.V{v}.D{d}", got.float(),
                  np.asarray(want, np.float32))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_all_padding_bag_is_zero(combiner):
    rng = np.random.default_rng(13)
    table = rng.normal(0, 1, (10, 8)).astype(np.float32)
    idx = np.full((2, 3), -1, np.int32)
    idx[1, 1] = 4                                  # one real bag beside it
    got = embedding_bag_plain(torch.from_numpy(table), torch.from_numpy(idx),
                              combiner=combiner)
    assert bool((got[0] == 0).all())
    assert torch.equal(got[1], torch.from_numpy(table[4]))
    assert_parity(f"bag.all_padding.{combiner}", got,
                  pallas_bag(jnp.asarray(table), jnp.asarray(idx),
                             combiner=combiner, interpret=True))


def test_ids_past_the_table_raise_and_bad_args():
    table = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="≥ the table's 6 rows"):
        embedding_bag_plain(table, torch.tensor([[0, 6]], dtype=torch.int32))
    with pytest.raises(ValueError, match="combiner"):
        embedding_bag_plain(table, torch.zeros((1, 1), dtype=torch.int32),
                            combiner="max")
    with pytest.raises(TypeError):
        embedding_bag_plain(table, torch.zeros((1, 1)))
    with pytest.raises(ValueError):
        embedding_bag_plain(table[0], torch.zeros((1, 1), dtype=torch.int32))
    # negative ids of any size are padding, not wrapped
    got = embedding_bag_plain(table + 1, torch.tensor([[-7, -1, 2]]))
    assert torch.equal(got, torch.ones((1, 4)))


def _sentinel(name, calls):
    def fn(*args, **kwargs):
        calls.append(name)
        return name
    return fn


@pytest.mark.parametrize("op,args,oracle,plain", [
    ("embedding_bag", lambda: (torch.zeros((5, 3)),
                               torch.zeros((2, 2), dtype=torch.int32)),
     "embedding_bag_ref", "embedding_bag_plain"),
    ("pairwise_similarity", lambda: (torch.ones((3, 4)), torch.ones((2, 4))),
     "similarity_ref", "similarity_plain"),
    ("flash_attention", lambda: tuple(torch.ones((1, 2, 3, 4))
                                      for _ in range(3)),
     "attention_ref", "flash_attention_plain"),
])
def test_ops_dispatch(monkeypatch, op, args, oracle, plain):
    """``impl=None`` on CPU tensors runs the oracle; ``"plain"`` the plain
    version; ``"kernel"`` with CPU tensors raises; Pallas tiling keywords
    and unknown impls raise."""
    calls = []
    monkeypatch.setattr(tref, oracle, _sentinel("oracle", calls))
    monkeypatch.setattr(ops, plain, _sentinel("plain", calls))
    fn = getattr(ops, op)
    assert fn(*args()) == "oracle"
    assert fn(*args(), impl="oracle") == "oracle"
    assert fn(*args(), impl="plain") == "plain"
    assert calls == ["oracle", "oracle", "plain"]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args(), impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        fn(*args(), impl="pallas")
    for tiling in ({"interpret": True}, {"bq": 32}, {"bm": 128}):
        with pytest.raises(TypeError, match="tile"):
            fn(*args(), **tiling)
    assert calls == ["oracle", "oracle", "plain"]


def test_ops_results_on_cpu():
    table, idx = _inputs(40, 10, 4, 3, 21)
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    for combiner in ("sum", "mean"):
        assert torch.equal(ops.embedding_bag(tt, ti, combiner=combiner),
                           tref.embedding_bag_ref(tt, ti, combiner=combiner))
        assert torch.equal(
            ops.embedding_bag(tt, ti, combiner=combiner, impl="plain"),
            embedding_bag_plain(tt, ti, combiner=combiner))
    import repro_torch.kernels as k
    assert k.embedding_bag is ops.embedding_bag
    assert k.flash_attention is ops.flash_attention
    assert k.pairwise_similarity is ops.pairwise_similarity
