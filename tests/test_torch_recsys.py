"""The port's recsys CTR serving path (``repro_torch.models.{embedding,
dlrm,fm,xdeepfm}``, ``configs``, ``launch.steps``, ``data.batches``)
against the JAX reference on the CPU.

The reference's ``init_params(PRNGKey(0))`` tree (zero biases moved off 0
by seeded numpy noise, so that every parameter matters) is carried into
the port by ``repro_torch.state.recsys_from_reference``; then ``forward``
on ``recsys_batch(16)`` and ``retrieval_score`` run in both packages on
the same ids.  Smoke configs in f32; tolerance 1e-5 (the two packages'
matmuls and sums round differently in the last bits).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.data import batches as jbatches
from repro.models import embedding as jemb
from repro_torch.configs import get_arch
from repro_torch.configs.registry import RECSYS_SHAPES, input_specs
from repro_torch.data import batches as tbatches
from repro_torch.launch.steps import build_step
from repro_torch.models import common as tcm
from repro_torch.models import embedding as temb
from repro_torch.state import recsys_from_reference

TOL = 1e-5
ARCHS = ["dlrm_mlperf", "fm", "xdeepfm"]


def _reference(name):
    arch = importlib.import_module(f"repro.configs.{name}").ARCH
    model = importlib.import_module(f"repro.models.{arch.model}")
    return arch, model


def _perturbed_params(model, cfg, seed=0):
    """Reference params with every bias (zeros at init) moved off 0."""
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if "'b'" in str(path[-1]) or "'w0'" in str(path[-1]):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, params)


def _pair(name):
    """(reference cfg, reference model module, reference params as host
    arrays, the port's model on the CPU) for ``name``'s smoke config."""
    jarch, jmodel = _reference(name)
    jcfg = jarch.smoke_config()
    tcfg = get_arch(name).smoke_config()
    params = _perturbed_params(jmodel, jcfg)
    return jcfg, jmodel, params, recsys_from_reference(tcfg, params,
                                                       device="cpu")


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    jcfg, jmodel, params, model = _pair(name)
    batch = tbatches.recsys_batch(16, jcfg.field_sizes,
                                  getattr(jcfg, "n_dense", 0), seed=1)
    batch.pop("labels")
    want = jmodel.forward(jcfg, params, _jax_batch(batch))
    got = model(batch)
    assert got.shape == (16,) and got.dtype == torch.float32
    assert_parity(f"recsys.{name}.forward", got, want, atol=TOL)


@pytest.mark.parametrize("name,n", [("dlrm_mlperf", 32), ("fm", 32),
                                    ("xdeepfm", 32), ("xdeepfm", 192)])
def test_retrieval_matches_reference(name, n):
    jcfg, jmodel, params, model = _pair(name)
    batch = tbatches.recsys_batch(1, jcfg.field_sizes,
                                  getattr(jcfg, "n_dense", 0), seed=2)
    batch.pop("labels")
    batch["candidates"] = tbatches.candidates(
        n, jcfg.field_sizes[jcfg.candidate_field], seed=3)
    want = jmodel.retrieval_score(jcfg, params, _jax_batch(batch))
    got = model.retrieval_score(batch)
    assert got.shape == (n,)
    assert_parity(f"recsys.{name}.retrieval.n{n}", got, want, atol=TOL)


def test_xdeepfm_ragged_chunks_refused_like_reference():
    jcfg, jmodel, params, model = _pair("xdeepfm")
    batch = tbatches.recsys_batch(1, jcfg.field_sizes, seed=2)
    batch.pop("labels")
    batch["candidates"] = tbatches.candidates(100, 50, seed=3)
    with pytest.raises((TypeError, ValueError)):
        jmodel.retrieval_score(jcfg, params, _jax_batch(batch))
    with pytest.raises(ValueError):
        model.retrieval_score(batch)


@pytest.mark.parametrize("name", ["fm", "dlrm_mlperf"])
def test_retrieval_equals_forward_on_substituted_batch(name):
    """The factorised / batched retrieval score is the forward of the
    context broadcast to every candidate with the candidate field set."""
    _, _, _, model = _pair(name)
    cfg = model.cfg
    batch = tbatches.recsys_batch(1, cfg.field_sizes,
                                  getattr(cfg, "n_dense", 0), seed=4)
    batch.pop("labels")
    cand = tbatches.candidates(24, cfg.field_sizes[cfg.candidate_field],
                               seed=5)
    scores = model.retrieval_score({**batch, "candidates": cand})
    sparse = np.repeat(batch["sparse"], 24, axis=0)
    sparse[:, cfg.candidate_field] = cand
    full = {"sparse": sparse}
    if "dense" in batch:
        full["dense"] = np.repeat(batch["dense"], 24, axis=0)
    assert_parity(f"recsys.{name}.retrieval_vs_forward", scores,
                  model(full), atol=TOL)


@pytest.mark.parametrize("fields", [(3, 0), (1,), (4, 2, 0)])
def test_sharded_lookup_field_subsets(fields):
    jcfg, _, params, _ = _pair("dlrm_mlperf")
    layout = jcfg.layout()
    tlayout = temb.TableLayout(**dataclasses.asdict(layout))
    rng = np.random.default_rng(6)
    idx = np.stack([rng.integers(0, jcfg.field_sizes[f], 9)
                    for f in fields], 1).astype(np.int32)
    want = jemb.sharded_lookup(layout, params["tables"], jnp.asarray(idx),
                               None, fields=list(fields))
    tables = {k: torch.from_numpy(np.array(v))
              for k, v in params["tables"].items()}
    got = temb.sharded_lookup(tlayout, tables, torch.from_numpy(idx),
                              fields=list(fields))
    assert_parity(f"recsys.sharded_lookup.{fields}", got, want)
    assert tlayout.sharded_rows == layout.sharded_rows
    assert tlayout.sharded_fields == layout.sharded_fields


def test_lookup_keeps_take_semantics_off_contract():
    """Ids the models never produce: a negative row id wraps, one outside
    [−V, V) gives a NaN row, as ``jnp.take`` does."""
    jcfg, _, params, _ = _pair("fm")
    layout = jcfg.layout()
    tlayout = temb.TableLayout(**dataclasses.asdict(layout))
    rows = layout.sharded_rows
    # field 0 (9000 ids, sharded, offset 0): −1, −rows, −rows − 1, rows + 3
    idx = np.array([[-1, 0, 0], [-rows, 1, 1], [-rows - 1, 2, 2],
                    [rows + 3, 3, 3], [8999, 49, 119]], np.int32)
    fields = [0, 1, 4]
    want = jemb.sharded_lookup(layout, params["factors"], jnp.asarray(idx),
                               None, fields=fields)
    tables = {k: torch.from_numpy(np.array(v))
              for k, v in params["factors"].items()}
    got = temb.sharded_lookup(tlayout, tables, torch.from_numpy(idx),
                              fields=fields)
    _assert_same_nans_then_parity("recsys.take_semantics", got, want, 0.0)


def _assert_same_nans_then_parity(name, got, want, atol):
    """NaN in the same places, then the other entries compared."""
    want = np.asarray(want)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert_parity(name, torch.nan_to_num(got), np.nan_to_num(want), atol)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_xla_off_contract(combiner):
    rng = np.random.default_rng(7)
    table = rng.normal(0, 1, (12, 5)).astype(np.float32)
    idx = np.array([[3, -1, 11], [12, -1, -1], [-1, -1, -1]], np.int32)
    want = jemb.embedding_bag_xla(jnp.asarray(table), jnp.asarray(idx),
                                  combiner=combiner)
    got = temb.embedding_bag_xla(torch.from_numpy(table),
                                 torch.from_numpy(idx), combiner=combiner)
    _assert_same_nans_then_parity(
        f"recsys.embedding_bag_xla.off_contract.{combiner}", got, want, TOL)


@pytest.mark.parametrize("sizes,n_dense,batch,seed", [
    ((9000, 50, 10000, 3, 120), 13, 64, 0),
    ((39884406, 39043, 3, 7120), 0, 200, 5),
    ((64, 101, 100), 2, 7, 11)])
def test_batches_byte_identical(sizes, n_dense, batch, seed):
    want = jbatches.recsys_batch(batch, sizes, n_dense, seed=seed)
    got = tbatches.recsys_batch(batch, sizes, n_dense, seed=seed)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key
    for n, vocab in ((1000, 50), (33, 1_000_000)):
        assert tbatches.candidates(n, vocab, seed).tobytes() == \
            jbatches.candidates(n, vocab, seed).tobytes()


@pytest.mark.parametrize("name", ARCHS)
def test_configs_and_step_plans(name):
    jarch, jmodel = _reference(name)
    arch = get_arch(name)
    assert dataclasses.asdict(arch.config) == dataclasses.asdict(
        jarch.config)
    assert dataclasses.asdict(arch.smoke_config()) == dataclasses.asdict(
        jarch.smoke_config())
    assert arch.config.param_count() == jarch.config.param_count()
    assert [dataclasses.asdict(c) for c in arch.shapes] == \
        [dataclasses.asdict(c) for c in jarch.shapes]
    from repro.configs import registry as jreg
    for cell in RECSYS_SHAPES:
        want = jreg.input_specs(jarch, cell)
        got = input_specs(arch, cell)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()}
        plan = build_step(arch, cell)
        assert plan.example_args == got
        if cell.step == "train":
            assert plan.optimizer is not None


@pytest.mark.parametrize("name", ARCHS)
def test_step_runs_model_and_counts_params(name):
    """``build_step``'s serve and retrieval steps on a smoke model made by
    the port's own ``init_params`` from a seeded generator."""
    arch = get_arch(name)
    cfg = arch.smoke_config()
    model_mod = importlib.import_module(f"repro_torch.models.{arch.model}")
    gen = torch.Generator().manual_seed(0)
    params = model_mod.init_params(cfg, gen)
    assert tcm.count_params(params) == cfg.param_count()
    model = recsys_from_reference(cfg, params, device="cpu")
    serve = build_step(arch, dataclasses.replace(
        arch.cell("serve_p99"), dims={"batch": 8}))
    batch = tbatches.recsys_batch(8, cfg.field_sizes,
                                  getattr(cfg, "n_dense", 0), seed=1)
    out = serve.fn(model, batch)
    assert out.shape == (8,) and bool(torch.isfinite(out).all())
    ret = build_step(arch, dataclasses.replace(
        arch.cell("retrieval_cand"),
        dims={"batch": 1, "n_candidates": 16}))
    one = {k: v[:1] for k, v in batch.items() if k != "labels"}
    one["candidates"] = tbatches.candidates(
        16, cfg.field_sizes[cfg.candidate_field], seed=2)
    scores = ret.fn(model, one)
    assert scores.shape == (16,) and bool(torch.isfinite(scores).all())


def test_unported_paths_raise():
    arch = get_arch("dlrm_mlperf")
    cfg = arch.smoke_config()
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import dlrm
    params = dlrm.init_params(cfg, gen)
    ids = torch.zeros((2, cfg.n_sparse), dtype=torch.int32)
    # the sharded lookup is ported: on the default one-rank mesh it equals
    # the mesh=None lookup bit for bit, and it refuses a wrong-size block
    from repro_torch.core.engine import default_mesh
    mesh = default_mesh("cpu")
    layout = cfg.layout()
    ids = torch.from_numpy(np.stack(
        [np.random.default_rng(f).integers(0, s, 8)
         for f, s in enumerate(cfg.field_sizes)], axis=1))
    assert torch.equal(
        temb.sharded_lookup(layout, params["tables"], ids, mesh=mesh),
        temb.sharded_lookup(layout, params["tables"], ids))
    half = dict(params["tables"], sharded=params["tables"]["sharded"][:1])
    assert layout.sharded_fields
    with pytest.raises(ValueError, match="block"):
        temb.sharded_lookup(layout, half, ids, mesh=mesh)
    # the GNN family is ported: an unknown kind is refused as the
    # reference's build_step refuses it, and egnn resolves
    with pytest.raises(ValueError, match="unknown"):
        build_step(dataclasses.replace(arch, kind="unknown"),
                   arch.cell("train_batch"))
    assert get_arch("egnn").kind == "gnn"
