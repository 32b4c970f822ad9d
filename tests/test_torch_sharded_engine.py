"""Port parity: the mesh engines (``repro_torch.core.engine``) and the
facade's ``sharded`` / ``ring`` backends on 1, 2 and 4 gloo ranks (over a
file store, no network), against the reference's single-device functions
computed in this process — the reference's own tests hold its sharded
forms to those bit for bit (``tests/test_distributed_engine.py``).

* top-k: ids and scores bit for bit under jaccard, cosine and pcc; ids
  bit for bit and scores within 2e-5 under pcc_sig (the one-ulp
  difference every port backend has from the reference's jitted
  epilogue); every rank returns the same global result;
* ``sharded_predict`` / ``ring_sharded_predict`` within 1e-5 of the
  reference's ``predict_from_neighbors``;
* ``CFEngine(backend="sharded" | "ring")`` recommend ids equal the
  reference's sequential engine's (ties at the cut within 1e-5 may go
  either way, as in ``test_torch_facade.py``), and an oracle-checked
  update through the mesh;
* U not divisible by P raises ``ValueError``;
* in this process: the default one-rank mesh, the mesh helpers and the
  partition-spec placements.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_dist as td
from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core.facade import CFEngine as RefEngine
from repro.core.neighbors import topk_neighbors as ref_topk
from repro.core.predict import predict_from_neighbors as ref_predict
from repro.data import load_ml1m_synthetic
from repro_torch.core import engine as E
from repro_torch.core.facade import CFEngine
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh

K = 12
BLOCK = 64
WORLDS = (1, 2, 4)
DELTA = (np.array([3, 3, 200], np.int32), np.array([7, 8, 9], np.int32),
         np.array([4.0, 0.0, 1.0], np.float32))


@pytest.fixture(scope="module")
def ratings():
    return load_ml1m_synthetic(n_users=256, n_items=200, seed=0)[0]


@pytest.fixture(scope="module")
def ranks(ratings, tmp_path_factory):
    """Rank results per world size, each launched once."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = td.launch(
                "engine", world, tmp_path_factory.mktemp(f"engine{world}"),
                {"ratings": ratings, "k": K, "block_size": BLOCK,
                 "delta": DELTA})
        return cache[world]
    return get


@pytest.fixture(scope="module")
def reference(ratings):
    r = jnp.asarray(ratings)
    out = {m: ref_topk(r, K, measure=m, block_size=BLOCK)
           for m in td.MEASURES}
    out["engine"] = RefEngine(r, measure="pcc", k=K,
                              block_size=BLOCK).fit()
    return out


@pytest.mark.parametrize("engine", ["sharded", "ring"])
@pytest.mark.parametrize("measure", td.MEASURES)
@pytest.mark.parametrize("world", WORLDS)
def test_topk_matches_reference(ranks, reference, world, measure, engine):
    want_s, want_i = reference[measure]
    for rank, out in enumerate(ranks(world)):
        s, i = out[(engine, measure)]
        name = f"engine.{engine}.P{world}.rank{rank}.{measure}"
        assert_parity(f"{name}.ids", i, want_i)
        assert_parity(f"{name}.scores", s, want_s,
                      atol=2e-5 if measure == "pcc_sig" else 0.0)


@pytest.mark.parametrize("form", ["sharded", "ring"])
@pytest.mark.parametrize("world", WORLDS)
def test_predict_matches_reference(ratings, ranks, reference, world, form):
    s, i = reference["pcc"]
    want = ref_predict(jnp.asarray(ratings), s, i)
    outs = ranks(world)
    for rank, out in enumerate(outs):
        assert_parity(f"engine.predict_{form}.P{world}.rank{rank}",
                      out[f"predict_{form}"], want, atol=1e-5)
        np.testing.assert_array_equal(out[f"predict_{form}"],
                                      outs[0][f"predict_{form}"])


@pytest.mark.parametrize("backend", ["sharded", "ring"])
@pytest.mark.parametrize("world", WORLDS)
def test_facade_backend_recommends_as_reference(ranks, reference, world,
                                                backend):
    ref = reference["engine"]
    want_i = np.asarray(ref.recommend(n=10)[1])
    pred = np.asarray(ref.predict())
    for rank, out in enumerate(ranks(world)):
        got_s, got_i = out[("recommend", backend)]
        bad = np.nonzero((got_i != want_i).any(axis=1))[0]
        for u in bad:                      # a near-tie at the cut only
            j = int(np.argmax(got_i[u] != want_i[u]))
            a, b = got_i[u, j], want_i[u, j]
            assert abs(pred[u, a] - pred[u, b]) <= 1e-5, (rank, u, a, b)
        keep = np.setdiff1d(np.arange(len(got_i)), bad)
        assert_parity(f"engine.{backend}.P{world}.rank{rank}.recommend",
                      got_i[keep], want_i[keep])
        ok, scores, idx = out[("update", backend)]
        assert ok is True
        np.testing.assert_array_equal(idx, ranks(world)[0][("update",
                                                            backend)][2])


@pytest.mark.parametrize("world", [2, 4])
def test_indivisible_users_raise(ranks, world):
    for rank, out in enumerate(ranks(world)):
        for fn in ("sharded_topk", "ring_sharded_topk"):
            assert "must divide" in out[("indivisible", fn)], (rank, fn)


def test_default_mesh_is_one_rank_over_the_default_group(ratings):
    """No mesh: a one-axis mesh over the default group (a one-rank gloo
    group on the CPU when none exists); the facade's mesh backends fit
    through it, bit for bit the sequential backend's."""
    m = E.default_mesh("cpu")
    assert m.device_type == "cpu" and m.mesh_dim_names == ("data",)
    assert m.size() == torch.distributed.get_world_size() == 1
    assert torch.distributed.get_backend() == "gloo"
    seq = CFEngine(ratings, k=K, block_size=BLOCK, backend="sequential",
                   device="cpu").fit()
    for backend in ("sharded", "ring"):
        eng = CFEngine(ratings, k=K, block_size=BLOCK, backend=backend,
                       device="cpu").fit()
        assert eng.mesh.size() == 1 and eng.use_kernel
        assert torch.equal(eng.idx, seq.idx)
        assert torch.equal(eng.scores, seq.scores)
        assert torch.equal(eng.recommend(n=10)[1], seq.recommend(n=10)[1])
    r = torch.from_numpy(ratings)
    pred = seq.predict()
    for fn in (E.sharded_predict, E.ring_sharded_predict):
        assert_parity(f"engine.{fn.__name__}.default_mesh",
                      fn(r, seq.scores, seq.idx), pred, atol=1e-5)


def test_mesh_errors(monkeypatch):
    """A CUDA mesh refuses CPU tensors; the production meshes need their
    256 / 512 ranks; a gloo group does not serve CUDA (no fallback)."""
    E.default_mesh("cpu")
    fake = types.SimpleNamespace(device_type="cuda")
    r = torch.ones((4, 3))
    with pytest.raises(ValueError, match="collectives"):
        E.sharded_topk(r, 2, fake)
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_flat_mesh(multi_pod=True, device="cpu")
    assert tmesh.init_default_group("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="'gloo'"):
        tmesh.init_default_group("cuda")
    assert tmesh.make_local_mesh(device="cpu").mesh_dim_names == ("data",)


def test_partition_specs_become_placements():
    m = tmesh.make_local_mesh((1, 1), ("data", "model"), device="cpu")
    P = sh.PartitionSpec
    assert sh.batch_axes(m) == ("data",)
    assert sh.all_axes(m) == ("data", "model")
    assert sh.placements(m, P("data", None)) == [Shard(0), Replicate()]
    assert sh.placements(m, P(None, "model")) == [Replicate(), Shard(1)]
    assert sh.placements(m, P(("data", "model"))) == [Shard(0), Shard(0)]
    assert sh.replicated(m).placements == [Replicate(), Replicate()]
    assert sh._sanitize(m, P(("pod", "data"), "expert")) == P(("data",),
                                                              None)
    tree = sh.to_shardings(m, {"w": P("model", None), "b": [P(), None]})
    assert tree["w"].placements == [Replicate(), Shard(0)]
    assert tree["b"][0].spec == P() and tree["b"][1] is None
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(m, P(("model", "data")))
    with pytest.raises(ValueError, match="twice"):
        sh.placements(m, P("data", "data"))
