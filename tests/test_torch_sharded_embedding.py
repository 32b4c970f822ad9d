"""Port parity: the sharded all-to-all embedding lookup
(``sharded_lookup(mesh=)``) on 4 gloo ranks in a (2, 2) mesh, each rank
holding only its (sharded_rows / 4, D) block of the sharded table and its
batch shard of the ids.

* A uniform batch: the gathered lookups equal the reference's ``mesh=None``
  lookup bit for bit.
* A skewed batch (every rank's first field in rank 0's rows, bucket slack
  1.0) overflows a bucket: the gathered lookups equal the reference's
  ``sharded_lookup`` on 4 fake XLA devices bit for bit, the dropped
  lookups' zeros included (run in one subprocess, as the reference's
  ``tests/test_distributed_engine.py`` runs its mesh).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from _torch_parity import assert_parity
from repro.models.embedding import TableLayout as RefLayout
from repro.models.embedding import sharded_lookup as ref_lookup

REPO = Path(__file__).resolve().parents[1]
LAYOUT = dict(field_sizes=(20000, 50, 9000, 3), embed_dim=16, n_shards=4,
              bucket_slack=1.0)
WORLD = 4


def _batches(rng):
    sizes = LAYOUT["field_sizes"]
    uniform = np.stack([rng.integers(0, s, 64) for s in sizes], axis=1)
    skewed = np.stack([rng.integers(0, s, 512) for s in sizes], axis=1)
    rows = RefLayout(**LAYOUT).sharded_rows // WORLD
    skewed[:, 0] = rng.integers(0, rows, 512)       # all owned by rank 0
    return {"uniform": uniform.astype(np.int32),
            "skewed": skewed.astype(np.int32)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    layout = RefLayout(**LAYOUT)
    tables = {
        "sharded": rng.normal(size=(layout.sharded_rows, 16)).astype(
            np.float32),
        "replicated": rng.normal(size=(layout.replicated_rows, 16)).astype(
            np.float32)}
    batches = _batches(rng)
    out = td.launch("embedding", WORLD, tmp_path_factory.mktemp("emb"),
                    {"layout": LAYOUT, **tables, "batches": batches})
    gathered = {name: np.concatenate([o[name] for o in out])
                for name in batches}
    return tables, batches, gathered, tmp_path_factory.mktemp("emb_ref")


def test_uniform_batch_equals_single_device_lookup(data):
    tables, batches, gathered, _ = data
    want = ref_lookup(RefLayout(**LAYOUT),
                      {k: jnp.asarray(v) for k, v in tables.items()},
                      jnp.asarray(batches["uniform"]), None)
    assert_parity("embedding.sharded_lookup.P4.uniform",
                  gathered["uniform"], want)


def test_overflowing_batch_equals_reference_mesh(data):
    tables, batches, gathered, tmp = data
    np.savez(tmp / "in.npz", ids=batches["skewed"], **tables)
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
           "PYTHONPATH": str(REPO / "src")}
    code = textwrap.dedent(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.models.embedding import TableLayout, sharded_lookup
        assert len(jax.devices()) == {WORLD}
        d = np.load({str(tmp / "in.npz")!r})
        layout = TableLayout(**{LAYOUT!r})
        mesh = make_mesh((2, 2), ("data", "model"))
        got = sharded_lookup(layout, {{"sharded": jnp.asarray(d["sharded"]),
                                      "replicated": jnp.asarray(
                                          d["replicated"])}},
                             jnp.asarray(d["ids"]), mesh)
        np.save({str(tmp / "out.npy")!r}, np.asarray(got))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    want = np.load(tmp / "out.npy")
    assert_parity("embedding.sharded_lookup.P4.skewed", gathered["skewed"],
                  want)
    # the overflow really dropped lookups: their rows are zeros
    dropped = ~gathered["skewed"][:, 0].any(axis=1)
    assert 0 < dropped.sum() < len(dropped)
