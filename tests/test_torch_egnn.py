"""Port parity: the GNN family (``repro_torch.data.graph``,
``repro_torch.models.egnn``, ``configs/egnn.py``, the registry's GNN
shapes, ``all_archs`` / ``all_cells``, ``build_step``'s GNN train step
without a mesh and ``launch.train --arch egnn``) against the JAX
reference on the CPU.

Inputs are made with numpy from a seed; the reference's ``init_params``
tree is carried into the port by ``state.egnn_from_reference``.  Every
product is f32 (TF32 off, as the port pins it).  Tolerance: 1e-5 of
max(1, |x|) for each tensor (the packages' matmuls round differently in
the last bits; the segment sums add in the same order, edge order per
node).  The graph generators and the sampler are bitwise.

The reference's own numerics are held, not repaired: every graph here
has self-loop edges, and at three or more layers their norm's gradient
(0 · ∞) makes gradient leaves NaN — the same leaves, element by element,
in both packages; a label at or above ``d_out`` makes the loss NaN in
both.
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
from repro.configs import egnn as jconf
from repro.configs import registry as jreg
from repro.data import graph as jgraph
from repro.models import egnn as jegnn
from repro.training import optimizer as jopt
from repro_torch.configs import all_archs, all_cells, get_arch, input_specs
from repro_torch.configs.registry import GNN_SHAPES, pad_edges
from repro_torch.data import graph as tgraph
from repro_torch.launch.steps import build_step
from repro_torch.models import egnn as tegnn
from repro_torch.state import egnn_from_reference, opt_state_from_reference
from repro_torch.training.train_loop import trainable

TOL = 1e-5
DEPTHS = (2, 4)        # the smoke config's, and the full config's


def _close(name, got, want, tol=TOL):
    """Within ``tol`` of max(1, |want|); NaN where and only where the
    reference has NaN."""
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), name
    scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    assert_parity(name, np.where(fin, got, 0.0), np.where(fin, want, 0.0),
                  atol=tol * scale)


# -- the graph substrate: bitwise ---------------------------------------------

SPECS = [dict(n_nodes=64, n_edges=256, d_feat=16, n_classes=4),
         dict(n_nodes=300, n_edges=2000, d_feat=7, seed=3)]


@pytest.mark.parametrize("spec", SPECS, ids=["n64", "n300_seed3"])
def test_synthetic_graph_bitwise(spec):
    want = jgraph.synthetic_graph(jgraph.GraphSpec(**spec))
    got = tgraph.synthetic_graph(tgraph.GraphSpec(**spec))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (want["edges"][0] == want["edges"][1]).any()   # has self-loops


@pytest.mark.parametrize("seed", [0, 5])
def test_molecules_batch_and_csr_bitwise(seed):
    want = jgraph.molecules_batch(4, 10, 24, 11, seed=seed)
    got = tgraph.molecules_batch(4, 10, 24, 11, seed=seed)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    g = jgraph.synthetic_graph(jgraph.GraphSpec(200, 1500, 4, seed=seed))
    for w, t in zip(jgraph._to_csr(g["edges"], 200),
                    tgraph._to_csr(g["edges"], 200)):
        assert t.dtype == w.dtype
        np.testing.assert_array_equal(t, w)


@pytest.mark.parametrize("fanouts", [(4, 3), (5,)], ids=["f4x3", "f5"])
def test_sampler_successive_samples_bitwise(fanouts):
    g = jgraph.synthetic_graph(jgraph.GraphSpec(200, 1500, 8, seed=1))
    js = jgraph.NeighborSampler(g["edges"], 200, fanouts, seed=2)
    ts = tgraph.NeighborSampler(g["edges"], 200, fanouts, seed=2)
    assert ts.node_budget(16) == js.node_budget(16)
    rng = np.random.default_rng(9)
    for _ in range(3):
        seeds = rng.choice(200, 16, replace=False)
        want = js.sample(seeds, g["feat"], g["coord"], g["labels"])
        got = ts.sample(seeds, g["feat"], g["coord"], g["labels"])
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -- the model: forward, loss and gradients against the reference -------------

def _cfgs(n_layers):
    jcfg = dataclasses.replace(jconf.smoke_config(), n_layers=n_layers)
    tcfg = dataclasses.replace(get_arch("egnn").smoke_config(),
                               n_layers=n_layers)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    """The reference's tree, its zero biases moved off 0 by seeded noise."""
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if "'b'" in str(path[-1]):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(
        jitter, jegnn.init_params(jcfg, jax.random.PRNGKey(seed)))


def _graph(kind, d_out):
    """A flat graph, a sampled subgraph or a molecule batch (labels
    clipped to ``d_out``); each holds self-loop edges."""
    if kind == "flat":
        return jgraph.synthetic_graph(jgraph.GraphSpec(
            n_nodes=64, n_edges=256, d_feat=16, n_classes=d_out))
    if kind == "sampled":
        g = jgraph.synthetic_graph(jgraph.GraphSpec(200, 1200, 16,
                                                    n_classes=d_out))
        s = jgraph.NeighborSampler(g["edges"], 200, (4, 3), seed=0)
        return s.sample(np.arange(0, 200, 25), g["feat"], g["coord"],
                        g["labels"])
    m = jgraph.molecules_batch(4, 10, 24, 16, seed=1)
    m["labels"] = np.clip(m["labels"], -1, d_out - 1)
    return m


GRAPHS = ("flat", "sampled", "molecule")


def _jax_run(jcfg, params, batch):
    """The reference's loss, gradients, logits and coordinates (jitted)."""
    fwd = jegnn.forward_batched if batch["feat"].ndim == 3 \
        else jegnn.forward

    def run(p, b):
        loss, grads = jax.value_and_grad(
            lambda q: jegnn.loss_fn(jcfg, q, b))(p)
        return (loss, grads) + fwd(jcfg, p, b)
    return jax.jit(run)(params, {k: jnp.asarray(v)
                                 for k, v in batch.items()})


@pytest.mark.parametrize("n_layers", DEPTHS)
@pytest.mark.parametrize("kind", GRAPHS)
def test_forward_loss_and_gradients_match_reference(kind, n_layers):
    """Logits, coordinates, the loss and every gradient leaf within 1e-5
    of max(1, |x|); the non-finite gradient leaves (the 4-layer flat
    and sampled graphs) the same, element by element."""
    jcfg, tcfg = _cfgs(n_layers)
    params = _params(jcfg)
    batch = _graph(kind, jcfg.d_out)
    if kind != "molecule":
        assert (batch["edges"][0] == batch["edges"][1]).any()
    jloss, jgrads, jlogits, jcoords = _jax_run(jcfg, params, batch)
    model = egnn_from_reference(tcfg, params, device="cpu")
    fwd = model.forward_batched if kind == "molecule" else model.forward
    logits, coords = fwd(batch)
    tag = f"egnn.{kind}.L{n_layers}"
    _close(f"{tag}.logits", logits, jlogits)
    _close(f"{tag}.coords", coords, jcoords)
    tree = trainable(model.tree())
    loss = model.loss(batch)
    loss.backward()
    _close(f"{tag}.loss", loss, jloss)
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_t = jax.tree_util.tree_leaves(tree)
    assert len(flat_j) == len(flat_t)
    bad_j, bad_t = [], []
    for (path, want), leaf in zip(flat_j, flat_t):
        name = jax.tree_util.keystr(path)
        got = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        bad_j += [name] if not np.isfinite(np.asarray(want)).all() else []
        bad_t += [name] if not bool(torch.isfinite(got).all()) else []
        _close(f"{tag}.grad{name}", got, want)
    assert bad_t == bad_j
    if n_layers == 4 and kind != "molecule":
        assert bad_j, "the 4-layer gradient of a self-loop graph is NaN"
    if n_layers == 2:
        assert not bad_j


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_unclipped_molecule_labels_give_nan_loss(n_layers):
    """``molecules_batch`` draws labels in [0, 16): above the smoke
    config's ``d_out`` = 4 the loss is NaN in both packages, with no
    out-of-range read in the port."""
    jcfg, tcfg = _cfgs(n_layers)
    params = _params(jcfg)
    batch = jgraph.molecules_batch(4, 10, 24, 16, seed=1)
    assert batch["labels"].max() >= jcfg.d_out
    jloss = jax.jit(lambda p, b: jegnn.loss_fn(jcfg, p, b))
    model = egnn_from_reference(tcfg, params, device="cpu")
    flat = jgraph.synthetic_graph(jgraph.GraphSpec(64, 256, 16,
                                                   n_classes=16))
    for b in (batch, flat):
        assert np.isnan(float(jloss(params, {k: jnp.asarray(v)
                                             for k, v in b.items()})))
        assert torch.isnan(model.loss(b))


def test_unlabelled_and_padded_nodes_do_not_count():
    """Labels −1 add nothing; a batch with no labelled node gives 0."""
    jcfg, tcfg = _cfgs(2)
    params = _params(jcfg)
    g = _graph("flat", jcfg.d_out)
    g["labels"][::2] = -1
    model = egnn_from_reference(tcfg, params, device="cpu")
    want = jegnn.loss_fn(jcfg, params, {k: jnp.asarray(v)
                                        for k, v in g.items()})
    _close("egnn.masked.loss", model.loss(g), want)
    g["labels"][:] = -1
    assert float(model.loss(g)) == 0.0


def test_segment_sum_order_and_gradient():
    """The segment sum adds each node's rows in edge order (bitwise a
    sequential loop); its gradient is the gather, and the gather's
    gradient is the same fixed-order segment sum."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, 50)
    data = rng.normal(size=(50, 5)).astype(np.float32) * \
        10.0 ** rng.integers(-4, 4, (50, 1)).astype(np.float32)
    want = np.zeros((9, 5), np.float32)
    for e, i in enumerate(idx):
        want[i] += data[e]
    seg = tegnn.segments(torch.from_numpy(idx), 9)
    assert seg.lengths.tolist() == np.bincount(idx, minlength=9).tolist()
    x = torch.from_numpy(data).requires_grad_()
    got = tegnn.segment_sum(x, seg)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))
    got.backward(g)
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy()[idx])
    table = torch.from_numpy(want).requires_grad_()
    tegnn.gather(table, seg).backward(x.detach())
    np.testing.assert_array_equal(table.grad.numpy(), want)


def test_equivariance_on_cpu():
    """A rotation and translation of ``coord`` leaves the logits as they
    were and moves the output coordinates the same way (1e-4 of max(1,
    |x|): the rotated inputs round differently)."""
    _, tcfg = _cfgs(4)
    gen = torch.Generator().manual_seed(0)
    model = tegnn.EGNN(tcfg, tegnn.init_params(tcfg, gen))
    g = _graph("flat", tcfg.d_out)
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    shift = np.array([0.5, -2.0, 1.5], np.float32)
    moved = dict(g, coord=(g["coord"] @ q.T + shift).astype(np.float32))
    logits, coords = model.forward(g)
    logits2, coords2 = model.forward(moved)
    _close("egnn.equivariance.logits", logits2, logits.numpy(), 1e-4)
    _close("egnn.equivariance.coords", coords2,
           coords.numpy() @ q.T + shift, 1e-4)


# -- configs and the registry -------------------------------------------------

def test_config_and_param_counts_match_reference():
    arch = get_arch("egnn")
    for cfg, jcfg in ((arch.config, jconf.CONFIG),
                      (arch.smoke_config(), jconf.smoke_config())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        params = tegnn.init_params(cfg, torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in jax.tree_util.tree_leaves(params)) \
            == cfg.param_count()
        want = jax.eval_shape(lambda c=jcfg: jegnn.init_params(
            c, jax.random.PRNGKey(0)))
        assert jax.tree_util.tree_map(lambda x: tuple(x.shape), want) == \
            jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
    assert (arch.kind, arch.optimizer) == ("gnn", "adamw")
    assert jax.tree_util.tree_structure(tegnn.param_specs(arch.config)) \
        .num_leaves == jax.tree_util.tree_structure(jegnn.param_specs(
            jconf.CONFIG)).num_leaves


@pytest.mark.parametrize("cell", [c.name for c in GNN_SHAPES])
def test_gnn_input_specs_match_reference(cell):
    jarch, arch = jconf.ARCH, get_arch("egnn")
    want = jreg.input_specs(jarch, jarch.cell(cell))
    got = input_specs(arch, arch.cell(cell))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
        == {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()}
    assert build_step(arch, arch.cell(cell)).example_args == got
    assert dataclasses.asdict(arch.cell(cell)) == \
        dataclasses.asdict(jarch.cell(cell))
    for e in (1, 1023, 1024, 10556):
        assert pad_edges(e) == jreg.pad_edges(e)


def _norm(v):
    """A config's fields with its dtypes as names (torch and jnp alike)."""
    if isinstance(v, torch.dtype):
        return str(v).split(".")[-1]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, (type, np.dtype)):
        return jnp.dtype(v).name
    return v


def _specs(tree):
    """{key: (shape, dtype name)} of a tree of input specs (TensorSpecs
    or ShapeDtypeStructs; a decode cell's cache is a subtree)."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree.shape), _norm(tree.dtype) if isinstance(
        tree.dtype, torch.dtype) else jnp.dtype(tree.dtype).name


def _cells(arch):
    return [(c.name, c.step, c.dims, c.skip) for c in arch.shapes]


def test_all_archs_match_reference():
    want, got = jreg.all_archs(), all_archs()
    assert list(got) == list(want)
    for name, jarch in want.items():
        arch = got[name]
        assert (arch.name, arch.kind, arch.optimizer, arch.model) == \
            (jarch.name, jarch.kind, jarch.optimizer, jarch.model), name
        assert _norm(dataclasses.asdict(arch.config)) == \
            _norm(dataclasses.asdict(jarch.config)), name
        assert _norm(dataclasses.asdict(arch.smoke_config())) == \
            _norm(dataclasses.asdict(jarch.smoke_config())), name
        assert _cells(arch) == _cells(jarch), name


@pytest.mark.parametrize("include_skipped", [False, True])
def test_all_cells_match_reference(include_skipped):
    want = jreg.all_cells(include_skipped)
    got = all_cells(include_skipped)
    assert [(a.name, c.name, c.dims, c.skip) for a, c in got] == \
        [(a.name, c.name, c.dims, c.skip) for a, c in want]
    assert len(got) == (40 if include_skipped else 35)
    for (arch, cell), (jarch, jcell) in zip(got, want):
        assert _specs(input_specs(arch, cell)) == \
            _specs(jreg.input_specs(jarch, jcell)), (arch.name, cell.name)


# -- build_step's GNN train step (no mesh) against the reference's ------------

def _reference_step(jarch, cell):
    """The reference's step on a one-device (pod, data, model) mesh,
    jitted under that mesh."""
    from repro.compat import make_mesh
    from repro.launch import steps as jsteps
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    fn = jax.jit(jsteps.build_step(jarch, cell, mesh).fn)

    def run(*args):
        with mesh:
            return fn(*args)
    return run


STEP_CELLS = {"full_graph_sm": "flat", "minibatch_lg": "sampled",
              "molecule": "molecule"}


@pytest.mark.parametrize("cell_name", sorted(STEP_CELLS))
def test_train_step_matches_reference(cell_name):
    """Two steps of ``build_step(cell).fn`` (AdamW) from one state at the
    smoke config: the losses and the parameters within 1e-5."""
    jcfg, tcfg = _cfgs(2)
    params = _params(jcfg, seed=4)
    jarch = dataclasses.replace(jconf.ARCH, config=jcfg)
    arch = dataclasses.replace(get_arch("egnn"), config=tcfg)
    cell = dataclasses.replace(arch.cell(cell_name), dims=dict(
        arch.cell(cell_name).dims, d_feat=16))
    jstep = _reference_step(jarch, cell)
    plan = build_step(arch, cell)
    jstate = jax.tree_util.tree_map(
        np.asarray, jopt.get_optimizer("adamw").init(params))
    state = opt_state_from_reference(jstate, device="cpu")
    model = egnn_from_reference(tcfg, params, device="cpu")
    batch = _graph(STEP_CELLS[cell_name], jcfg.d_out)
    jp = params
    for i in range(2):
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
        model, state, loss = plan.fn(model, state, batch)
        _close(f"egnn.step.{cell_name}.loss{i}", loss, jloss)
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(model.tree())
    assert len(flat_j) == len(flat_t)
    for i, (got, want) in enumerate(zip(flat_t, flat_j)):
        _close(f"egnn.step.{cell_name}.param{i}", got, want)
    assert int(state["step"]) == 2


def test_unknown_step_and_kind_raise():
    arch = get_arch("egnn")
    with pytest.raises(ValueError):
        build_step(arch, dataclasses.replace(arch.cell("molecule"),
                                             step="serve"))
    with pytest.raises(ValueError):
        input_specs(dataclasses.replace(arch, kind="unknown"),
                    arch.cell("molecule"))


def test_launch_train_runs_egnn_on_cpu(capsys):
    """``launch.train --arch egnn --smoke --steps 3 --device cpu``: finite
    losses on the reference's fixed 256-node graph."""
    train = importlib.import_module("repro_torch.launch.train")
    res, before, after = train.main(["--arch", "egnn", "--smoke",
                                     "--steps", "3", "--device", "cpu"])
    assert res.final_step == 3 and len(res.losses) == 3
    assert all(np.isfinite(res.losses)) and np.isfinite(before)
    assert np.isfinite(after)
    assert "arch=egnn kind=gnn" in capsys.readouterr().out
