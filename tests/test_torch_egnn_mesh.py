"""Port parity: EGNN's meshed train step (``build_step(egnn, cell,
mesh)``) against the JAX reference's meshed plan and the port's no-mesh
step, on the CPU.

The port's ranks run in one launch a world size (``tests/_torch_dist.py``:
``egnn_mesh``; the (data 2, model 1) mesh on 2 gloo ranks, (2, 2) and
(1, 4) on 4); the reference's plans run, jitted with their shardings
under ``with mesh:``, in one subprocess on 4 fake XLA devices.  The
smoke config (2 layers, f32, TF32 off) from the reference's
``init_params`` tree (biases moved off 0 by seeded noise), two AdamW
steps on one batch of each cell, the feature width cut to 16:

* ``full_graph_sm``: a 64-node synthetic graph, 256 edges (self-loops
  among them), the node tensors whole on every rank and the edges split
  over every mesh axis;
* ``molecule``: 4 graphs of 10 nodes and 24 edges (labels clipped to
  ``d_out``), split over ``data``; the ``model`` ranks hold the same
  graphs, which count once.

Losses and parameters within 1e-5 of max(1, |x|) of both (the edge
split changes the order of each node's sum, and the molecule split that
of the loss's).
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest

import _torch_dist as td
from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.configs import egnn as jconf
from repro.data import graph as jgraph
from repro.models import egnn as jegnn
from repro_torch.configs import get_arch
from repro_torch.launch.steps import build_step
from repro_torch.state import egnn_from_reference

TOL = 1e-5
STEPS = 2
MESHES = [((2, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model"))]
# minibatch_lg and ogb_products take full_graph_sm's layout and code path
CELLS = ("full_graph_sm", "molecule")
CASES = [(c, shape) for c in CELLS for shape, _ in MESHES]


def _batch(cell, d_out):
    if cell == "full_graph_sm":
        return jgraph.synthetic_graph(jgraph.GraphSpec(
            n_nodes=64, n_edges=256, d_feat=16, n_classes=d_out))
    m = jgraph.molecules_batch(4, 10, 24, 16, seed=1)
    m["labels"] = np.clip(m["labels"], -1, d_out - 1)
    return m


def _params(jcfg, seed=6):
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if "'b'" in str(path[-1]):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(
        jitter, jegnn.init_params(jcfg, jax.random.PRNGKey(seed)))


def _dims(cell):
    return dict(jconf.ARCH.cell(cell).dims, d_feat=16)


def _no_mesh(tcfg, params, batches):
    """The port's no-mesh step: losses and parameters after STEPS steps."""
    from repro_torch.distributed.checkpoint import tree_flatten
    arch = dataclasses.replace(get_arch("egnn"), config=tcfg)
    out = {}
    for cell in CELLS:
        plan = build_step(arch, dataclasses.replace(arch.cell(cell),
                                                    dims=_dims(cell)))
        model = egnn_from_reference(tcfg, params, device="cpu")
        state = plan.optimizer.init(model.tree())
        losses = []
        for _ in range(STEPS):
            model, state, loss = plan.fn(model, state, batches[cell])
            losses.append(float(loss))
        out[cell] = {"losses": losses, "params": [
            p.detach().numpy() for p in tree_flatten(model.tree())]}
    return out


def _start_reference(tmp, cell, params, batch):
    """The reference's meshed plans of ``cell`` on every mesh of MESHES,
    STEPS steps each, jitted with their shardings under ``with mesh:`` in
    a subprocess on 4 fake XLA devices."""
    with open(tmp / f"{cell}.in.pkl", "wb") as f:
        pickle.dump({"params": params, "batch": batch, "cell": cell,
                     "shapes": [shape for shape, _ in MESHES],
                     "dims": _dims(cell)}, f)
    return td.start_reference(f"""
        import dataclasses, pickle
        import numpy as np, jax
        from repro.compat import make_mesh
        from repro.configs import egnn as jconf
        from repro.launch import steps as jsteps
        from repro.training.optimizer import get_optimizer
        d = pickle.load(open({str(tmp / f"{cell}.in.pkl")!r}, "rb"))
        arch = dataclasses.replace(jconf.ARCH, config=jconf.smoke_config())
        out = {{}}
        cell_name = d["cell"]
        cell = dataclasses.replace(arch.cell(cell_name), dims=d["dims"])
        for shape in d["shapes"]:
            mesh = make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:int(np.prod(shape))])
            plan = jsteps.build_step(arch, cell, mesh)
            fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                         out_shardings=plan.out_shardings)
            p = d["params"]
            state = get_optimizer("adamw").init(p)
            losses = []
            with mesh:
                for _ in range({STEPS}):
                    p, state, loss = fn(p, state, d["batch"])
                    losses.append(float(loss))
            out[(cell_name, shape)] = {{
                "losses": losses,
                "params": [np.asarray(x)
                           for x in jax.tree_util.tree_leaves(p)],
                "batch_specs": {{k: tuple(v.spec) for k, v in
                                 plan.in_shardings[2].items()}}}}
        pickle.dump(out, open({str(tmp / f"{cell}.out.pkl")!r}, "wb"))
    """)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    jcfg = jconf.smoke_config()
    tcfg = get_arch("egnn").smoke_config()
    params = _params(jcfg)
    batches = {c: _batch(c, jcfg.d_out) for c in CELLS}
    tmp = tmp_path_factory.mktemp("egnn_mesh_ref")
    # one subprocess a cell, both running beside the ranks
    procs = [_start_reference(tmp, cell, params, batches[cell])
             for cell in CELLS]
    payload = {"meshes": MESHES, "cfg": tcfg, "params": params,
               "steps": STEPS,
               "cases": {(c, shape): {"dims": _dims(c), "batch": batches[c]}
                         for c, shape in CASES}}
    try:
        out = {}
        for world in (2, 4):
            ranks = td.launch("egnn_mesh", world,
                              tmp_path_factory.mktemp("egnn_mesh"), payload)
            out.update(ranks[0])
            for other in ranks[1:]:
                for key, res in other.items():
                    assert res["losses"] == ranks[0][key]["losses"], key
    finally:
        ref = {}
        for cell, proc in zip(CELLS, procs):
            ref.update(td.finish_reference(proc, tmp / f"{cell}.out.pkl"))
    return out, ref, _no_mesh(tcfg, params, batches)


def _tag(case):
    cell, (n_data, n_model) = case
    return f"{cell}-d{n_data}m{n_model}"


def _close(name, got, want):
    want = np.asarray(want, dtype=np.float32)
    assert np.isfinite(want).all() and np.isfinite(got).all(), name
    assert_parity(name, np.asarray(got), want,
                  atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_mesh_step_matches_reference_plan(stepped, case):
    """Each step's loss (the same on every rank) and the parameters after
    the two steps within 1e-5 of the reference's meshed plan."""
    out, ref, _ = stepped
    got, want = out[case], ref[case]
    assert got["step"] == STEPS
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        _close(f"egnn_mesh.{_tag(case)}.loss{i}", g, w)
    assert len(got["params"]) == len(want["params"])
    for i, (g, w) in enumerate(zip(got["params"], want["params"])):
        _close(f"egnn_mesh.{_tag(case)}.param{i}", g, w)


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_mesh_step_matches_no_mesh_step(stepped, case):
    """The meshed step computes what the no-mesh step does: losses and
    parameters within 1e-5."""
    out, _, plain = stepped
    got, want = out[case], plain[case[0]]
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        _close(f"egnn_mesh.{_tag(case)}.vs_no_mesh.loss{i}", g, w)
    for i, (g, w) in enumerate(zip(got["params"], want["params"])):
        _close(f"egnn_mesh.{_tag(case)}.vs_no_mesh.param{i}", g, w)


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_mesh_step_batch_shardings_match_reference(stepped, case):
    """``molecule``'s batch over the batch axes; the others' node tensors
    replicated and their edge list over every axis."""
    out, ref, _ = stepped
    got, want = (_axes(out[case]["batch_specs"]),
                 _axes(ref[case]["batch_specs"]))
    assert got == want
    if case[0] == "molecule":
        assert got["edges"] == (("data",), (), ())
    else:
        assert got["edges"] == ((), ("data", "model"))
        assert got["feat"] == got["coord"] == ((), ())


def _axes(specs):
    """Each spec's entries as tuples of axis names (JAX writes a single
    axis bare, the port as a 1-tuple)."""
    return {k: tuple(() if e is None else (e,) if isinstance(e, str)
                     else tuple(e) for e in spec)
            for k, spec in specs.items()}
