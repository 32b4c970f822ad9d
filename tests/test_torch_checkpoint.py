"""The port's checkpoints (``repro_torch.distributed.checkpoint``) against
the reference's ``repro.distributed.checkpoint``, on the CPU.

* Each package restores the other's checkpoints: an engine's state goes
  out through one package's ``save`` and comes back through the other's
  ``restore`` / ``CFEngine.load_state``, then back again; the engine that
  comes home recommends bit for bit what it did before it left (ids and
  scores), for an exact engine and an engine with both approx indexes.
  Across the packages the recommended ids are equal and the scores within
  1e-5 (the two ``predict`` paths may differ by one ulp, ROADMAP
  Queue 3).
* One tree saved by both packages gives byte-identical shards; the
  manifests agree on everything but the ``treedef`` string.
* The shard codec is ``msgpack.packb`` byte for byte and round-trips; a
  raw shard and a zstd shard both restore; an uncommitted ``step_*`` is
  ignored; ``AsyncCheckpointer`` keeps 3 and surfaces a writer error.
* ``restore(shardings=)`` of a reference-written checkpoint onto a mesh:
  on a one-rank mesh here, and on 2 and 4 gloo ranks (``_torch_dist``),
  each rank holds the slice its spec names and ``full_tensor()`` equals
  the numpy restore bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import assert_parity, int_ratings
from _torch_parity import torch_single_thread  # noqa: F401
from repro.core import CFEngine as JaxEngine
from repro.distributed import checkpoint as jck
from repro.index import IndexConfig as JaxConfig
from repro.index import ItemIndexConfig as JaxItemConfig
from repro_torch.core.facade import CFEngine
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed.sharding import PartitionSpec, to_shardings
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.index import IndexConfig, ItemIndexConfig

USERS = np.arange(0, 72, 5).astype(np.int32)


def _ratings():
    return int_ratings(np.random.default_rng(0), 72, 48, 0.4)


def _engine(pkg, mode):
    """A fitted engine of ``pkg`` ("port" | "ref") on the shared ratings:
    exact, or with both approx indexes."""
    kw = dict(measure="cosine", k=6, block_size=32)
    if mode == "approx":
        cfg, icfg = ((IndexConfig, ItemIndexConfig) if pkg == "port"
                     else (JaxConfig, JaxItemConfig))
        kw.update(neighbor_mode="approx", recommend_mode="approx",
                  index_cfg=cfg(n_clusters=6, seed=0, features="raw"),
                  item_index_cfg=icfg(n_clusters=6, shortlist=16))
    if pkg == "port":
        return CFEngine(_ratings(), device="cpu", **kw).fit()
    return JaxEngine(jnp.asarray(_ratings()), **kw).fit()


def _updated(pkg, mode):
    """``_engine`` after three rating updates on the port (the reference's
    updates compile a new shape each, so its engine stays as fitted)."""
    eng = _engine(pkg, mode)
    rng = np.random.default_rng(1)
    for _ in range(3 if pkg == "port" else 0):
        eng.update_ratings([int(rng.integers(0, 72))],
                           [int(rng.integers(0, 48))],
                           [float(rng.integers(1, 6))])
    return eng


def _recs(eng):
    s, i = eng.recommend(USERS, n=5)
    return np.asarray(s), np.asarray(i)


def _payloads(step_dir):
    return [ck.read_shard(p)[1]
            for p in sorted(step_dir.glob("shard_*.msgpack.zst"))]


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("home", ["port", "ref"])
def test_checkpoint_crosses_packages_and_back(tmp_path, home, mode):
    """``home``'s engine → its save → the other package's restore and
    load_state → that package's save → ``home``'s restore into a fresh
    engine: recommends equal bit for bit, and the two checkpoints' shards
    are identical."""
    out = {"port": ck, "ref": jck}[home]
    back = {"port": jck, "ref": ck}[home]
    other = "ref" if home == "port" else "port"
    eng = _updated(home, mode)
    want_s, want_i = _recs(eng)
    out.save(tmp_path, 1, eng.state())
    away = _engine(other, mode)
    away.load_state(back.restore(tmp_path, 1, away.state_template()))
    away_s, away_i = _recs(away)
    assert_parity(f"checkpoint.{home}->{other}.{mode}.ids", away_i, want_i)
    assert_parity(f"checkpoint.{home}->{other}.{mode}.scores", away_s,
                  want_s, atol=1e-5)
    back.save(tmp_path, 2, away.state())
    came = _engine(home, mode)
    came.load_state(out.restore(tmp_path, 2, came.state_template()))
    got_s, got_i = _recs(came)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    assert _payloads(tmp_path / "step_00000001") == \
        _payloads(tmp_path / "step_00000002")


def test_shards_byte_identical_across_packages(tmp_path):
    """One tree (the reference approx engine's state, with an empty
    subtree and a ``None`` in it) saved by both packages: identical shard
    files, identical manifests but for ``treedef``, and each package's
    restore reads the other's leaves bit for bit."""
    tree = {k: np.asarray(v) if not isinstance(v, dict) else
            {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in _engine("ref", "approx").state().items()}
    tree["extra"] = [None, {}, (np.arange(3, dtype=np.int64), 2.5)]
    ck.save(tmp_path / "port", 7, tree)
    jck.save(tmp_path / "ref", 7, tree)
    dp, dr = tmp_path / "port/step_00000007", tmp_path / "ref/step_00000007"
    files = sorted(p.name for p in dp.iterdir())
    assert files == sorted(p.name for p in dr.iterdir())
    for name in files:
        if name.startswith("shard_"):
            assert (dp / name).read_bytes() == (dr / name).read_bytes()
    mp = json.loads((dp / "manifest.json").read_text())
    mr = json.loads((dr / "manifest.json").read_text())
    assert mp.pop("treedef") and mr.pop("treedef")
    assert mp == mr
    leaves = jax.tree_util.tree_leaves(tree)
    assert [x["dtype"] for x in mp["leaves"]] == \
        [str(jnp.asarray(x).dtype) for x in leaves]
    got = ck.tree_flatten(ck.restore(tmp_path / "ref", 7, tree))
    want = jax.tree_util.tree_leaves(jck.restore(tmp_path / "port", 7,
                                                 tree))
    assert len(got) == len(want) == len(leaves)
    for a, b, x in zip(got, want, leaves):
        assert a.dtype == b.dtype == np.asarray(x).dtype
        assert np.array_equal(a, b) and np.array_equal(a, x)


@pytest.mark.parametrize("arr", [
    np.float32(2.5), np.arange(5, dtype=np.int64),
    np.zeros((0, 3), np.float32), np.ones((300, 2), np.int8),
    np.arange(70000, dtype=np.uint8), np.ones((1,) * 17, bool)],
    ids=["scalar", "int64", "empty", "int8", "bin32", "dims17"])
@pytest.mark.parametrize("i", [0, 127, 128, 70000])
def test_record_codec_is_msgpack(arr, i):
    arr = np.asarray(arr)
    want = msgpack.packb({"i": i, "data": arr.tobytes(),
                          "dtype": str(arr.dtype), "shape": list(arr.shape)})
    assert ck.pack_record(i, arr) == want
    assert ck.unpack_record(want) == msgpack.unpackb(want)


def test_flatten_order_is_jax():
    tree = {"b": [1, None, {"z": 2.0, "a": np.zeros(3)}], "a": {},
            "c": (np.ones(2), 3), "d": None}
    leaves = ck.tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(want)
    assert all(x is y for x, y in zip(leaves, want))
    back = ck.tree_unflatten(tree, list(range(len(leaves))))
    assert back == {"a": {}, "b": [0, None, {"a": 1, "z": 2}],
                    "c": (3, 4), "d": None}


@pytest.mark.parametrize("compressed", [True, False])
def test_raw_and_zstd_shards_restore(tmp_path, monkeypatch, compressed):
    if not compressed:
        monkeypatch.setattr(ck, "zstandard", None)
    tree = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
            "y": torch.tensor([1, 2, 3], dtype=torch.int32)}
    ck.save(tmp_path, 3, tree)
    raw = (tmp_path / "step_00000003/shard_00000.msgpack.zst").read_bytes()
    assert raw.startswith(b"\x28\xb5\x2f\xfd") is compressed
    for restore in (ck.restore, jck.restore):
        got = restore(tmp_path, 3, {"x": 0, "y": 0})
        np.testing.assert_array_equal(got["x"], tree["x"])
        np.testing.assert_array_equal(got["y"], tree["y"].numpy())
    if compressed:
        monkeypatch.setattr(ck, "zstandard", None)
        with pytest.raises(ImportError, match="zstandard"):
            ck.restore(tmp_path, 3, {"x": 0, "y": 0})


def test_latest_step_and_async_checkpointer(tmp_path):
    tree = {"w": np.ones(4, np.float32)}
    assert ck.latest_step(tmp_path / "none") is None
    ckp = ck.AsyncCheckpointer(tmp_path, keep=3)
    for step in range(1, 6):
        t = torch.full((4,), float(step))
        ckp.save(step, {"w": t})
        t.fill_(-1.0)                  # after save: the snapshot is taken
    ckp.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        [f"step_{s:08d}" for s in (3, 4, 5)]
    np.testing.assert_array_equal(ck.restore(tmp_path, 5, tree)["w"],
                                  np.full(4, 5.0, np.float32))
    # an uncommitted step (no COMMITTED marker) is invisible
    ck.save(tmp_path, 9, tree)
    (tmp_path / "step_00000009" / "COMMITTED").unlink()
    assert ck.latest_step(tmp_path) == jck.latest_step(tmp_path) == 5
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path, 9, tree)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(tmp_path, 5, {"w": 0, "v": 0})
    # onto a one-rank mesh: DTensors whose full tensor is the restore
    placed = ck.restore(tmp_path, 5, tree, shardings=to_shardings(
        make_local_mesh(device="cpu"), {"w": PartitionSpec("data")}))
    np.testing.assert_array_equal(placed["w"].full_tensor().numpy(),
                                  np.full(4, 5.0, np.float32))
    with pytest.raises(ValueError, match="shardings"):
        ck.restore(tmp_path, 5, tree, shardings={})
    # a writer error surfaces on the next wait()
    (tmp_path / "blocked").write_text("a file, not a directory")
    bad = ck.AsyncCheckpointer(tmp_path / "blocked")
    bad.save(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                          # reported once


# -- restore onto a mesh of gloo ranks ----------------------------------------

RESTORE_TREE = {"a": np.arange(48, dtype=np.float32).reshape(8, 6),
                "b": np.arange(5, dtype=np.int32),
                "c": np.arange(14, dtype=np.float32).reshape(2, 7) / 3,
                "s": np.float32(2.5)}
# (mesh shape, axes, specs) at each world size; "pod" is not in either
# mesh, so to_shardings drops it
RESTORE_MESHES = {
    2: ((2,), ("data",), {"a": ("data", None), "b": ("data",),
                          "c": (None, "data"), "s": ()}),
    4: ((2, 2), ("data", "model"), {"a": (("data", "model"), None),
                                    "b": ("data",),
                                    "c": (("pod", "data"), "model"),
                                    "s": ()}),
}


def _chunk(n, parts, i):
    """torch.chunk's i-th piece of range(n) (ceil-sized pieces)."""
    step = -(-n // parts)
    lo = min(i * step, n)
    return slice(lo, min(lo + step, n))


def _expected_slices(world, rank):
    t = RESTORE_TREE
    if world == 2:
        return {"a": t["a"][_chunk(8, 2, rank)],
                "b": t["b"][_chunk(5, 2, rank)],
                "c": t["c"][:, _chunk(7, 2, rank)], "s": t["s"]}
    d, m = divmod(rank, 2)
    return {"a": t["a"][_chunk(8, 4, rank)], "b": t["b"][_chunk(5, 2, d)],
            "c": t["c"][_chunk(2, 2, d), _chunk(7, 2, m)], "s": t["s"]}


@pytest.mark.parametrize("world", [2, 4])
def test_restore_onto_gloo_mesh(tmp_path, world):
    jck.save(tmp_path / "ckpt", 3, {k: jnp.asarray(v)
                                     for k, v in RESTORE_TREE.items()})
    want = ck.restore(tmp_path / "ckpt", 3, {k: 0 for k in RESTORE_TREE})
    shape, axes, specs = RESTORE_MESHES[world]
    outs = td.launch("restore", world, tmp_path,
                     {"dir": str(tmp_path / "ckpt"), "step": 3,
                      "shape": shape, "axes": axes, "specs": specs})
    for rank, out in enumerate(outs):
        exp = _expected_slices(world, rank)
        for key, (local, full, placements) in out.items():
            np.testing.assert_array_equal(local, exp[key],
                                          err_msg=f"{rank} {key}")
            assert local.dtype == want[key].dtype
            assert_parity(f"checkpoint.restore.P{world}.rank{rank}.{key}",
                          full, want[key])
        assert out["s"][2] == ["Replicate()"] * len(shape)
