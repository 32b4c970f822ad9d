"""Rank launcher for the port's multi-rank parity tests.

:func:`launch` starts ``world`` processes (the ``spawn`` start method, so
the workers import this module afresh), each joins a gloo process group
over a file store in the test's temporary directory — no network — runs
one task of :data:`TASKS` and pickles its result to that directory.  The
launch has a deadline (``TIMEOUT_S``, at most 120 s): stragglers are
killed and the launch raises, so a hung collective fails one test instead
of the run.  Every group has a 60 s timeout of its own.

The tasks import only the port; the tests hold their results against the
reference, computed in the pytest process or, on a mesh, in a subprocess
on fake XLA devices (:func:`start_reference`).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import textwrap
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

TIMEOUT_S = 120


def launch(task: str, world: int, out_dir, payload=None,
           timeout: float = TIMEOUT_S) -> list:
    """Run ``TASKS[task]`` on ``world`` gloo ranks; returns the ranks'
    results in rank order."""
    out_dir = Path(out_dir)
    store = out_dir / f"store_{task}_{world}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(task, rank, world, str(store), str(out_dir),
                               payload))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
        for p in late:
            p.join(10)
    errors = [(out_dir / f"{task}_{world}_{r}.err") for r in range(world)]
    msgs = [e.read_text() for e in errors if e.exists()]
    if late:
        raise TimeoutError(f"{task} on {world} ranks: {len(late)} rank(s) "
                           f"still running after {timeout} s; killed\n"
                           + "\n".join(msgs))
    codes = [p.exitcode for p in procs]
    if any(codes) or msgs:
        raise RuntimeError(f"{task} on {world} ranks: exit codes {codes}\n"
                           + "\n".join(msgs))
    out = []
    for r in range(world):
        with open(out_dir / f"{task}_{world}_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def start_reference(code: str, devices: int = 4) -> subprocess.Popen:
    """A run of the JAX reference on ``devices`` fake XLA devices, started
    in a subprocess (it runs while the port's ranks do); ``code`` is a
    script that pickles its result."""
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def finish_reference(proc: subprocess.Popen, out_pkl, timeout: float = 600):
    """Wait for :func:`start_reference`'s run (killed at ``timeout``) and
    load what it pickled to ``out_pkl``."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    with open(out_pkl, "rb") as f:
        return pickle.load(f)


def _run_rank(task, rank, world, store, out_dir, payload):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    base = Path(out_dir) / f"{task}_{world}_{rank}"
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        try:
            result = TASKS[task](rank, world, payload)
        finally:
            dist.destroy_process_group()
        with open(base.with_suffix(".pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        base.with_suffix(".err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _np(x):
    """Tensors (also inside tuples, lists and dicts) as numpy arrays."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


# -- tasks -----------------------------------------------------------------

MEASURES = ("jaccard", "cosine", "pcc", "pcc_sig")


def engine_task(rank, world, p):
    """Both top-k engines under every measure, both predictors, the two
    facade backends (fit, recommend, an oracle-checked update) and the
    indivisible-U error, on a one-axis mesh of every rank."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core.facade import CFEngine
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device="cpu")
    r = torch.from_numpy(p["ratings"])
    k, bs = p["k"], p["block_size"]
    out = {}
    for m in MEASURES:
        out[("sharded", m)] = E.sharded_topk(r, k, mesh, measure=m,
                                             block_size=bs)
        out[("ring", m)] = E.ring_sharded_topk(r, k, mesh, measure=m,
                                               block_size=bs)
    s, i = out[("sharded", "pcc")]
    out["predict_sharded"] = E.sharded_predict(r, s, i, mesh)
    out["predict_ring"] = E.ring_sharded_predict(r, s, i, mesh)
    for backend in ("sharded", "ring"):
        eng = CFEngine(p["ratings"], measure="pcc", k=k, block_size=bs,
                       backend=backend, mesh=mesh, device="cpu").fit()
        out[("recommend", backend)] = eng.recommend(n=10)
        st = eng.update_ratings(*p["delta"], oracle_check=True)
        out[("update", backend)] = (st.oracle_ok, eng.scores, eng.idx)
    if world > 1:
        for fn in (E.sharded_topk, E.ring_sharded_topk):
            try:
                fn(r[:-1], k, mesh, block_size=bs)
            except ValueError as e:
                out[("indivisible", fn.__name__)] = str(e)
    return _np(out)


def kmeans_task(rank, world, p):
    """Two sharded k-means fits of the blobs, and an index fitted through
    the mesh and queried."""
    import torch
    from repro_torch.core import similarity as sim
    from repro_torch.index import ClusteredIndex, IndexConfig
    from repro_torch.index.kmeans import kmeans
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device="cpu")
    z = torch.from_numpy(p["z"])
    runs = []
    for _ in range(2):
        c, a, d, st = kmeans(z, 8, seed=0, iters=5, block_size=16,
                             mesh=mesh)
        runs.append((c, a, d, st.inertia))
    r = torch.from_numpy(p["ratings"])
    means = sim.user_stats(r)[2]
    ix = ClusteredIndex(IndexConfig(n_clusters=8, seed=0, features="raw"),
                        mesh=mesh).fit(r, means)
    s, i = ix.query(r, means, k=5, measure="cosine")
    return _np({"runs": runs, "query": (s, i),
                "centroids": ix.centroids, "spill_ids": ix.spill_ids})


def embedding_task(rank, world, p):
    """This rank's batch shard of ``sharded_lookup`` on a (2, 2) mesh,
    each rank holding its block of the sharded table."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.embedding import TableLayout, sharded_lookup
    mesh = make_local_mesh((2, 2), ("data", "model"), device="cpu")
    layout = TableLayout(**p["layout"])
    rows = layout.sharded_rows // world
    tables = {"sharded": torch.from_numpy(
                  p["sharded"][rank * rows:(rank + 1) * rows]),
              "replicated": torch.from_numpy(p["replicated"])}
    out = {}
    for name, ids in p["batches"].items():
        b = ids.shape[0] // world
        mine = torch.from_numpy(ids[rank * b:(rank + 1) * b])
        out[name] = sharded_lookup(layout, tables, mine, mesh)
    return _np(out)


def restore_task(rank, world, p):
    """``restore(shardings=)`` of a checkpoint onto a mesh: each leaf's
    local slice and its ``full_tensor()``."""
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.distributed.sharding import PartitionSpec, to_shardings
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(p["shape"], p["axes"], device="cpu")
    specs = {key: PartitionSpec(*spec) for key, spec in p["specs"].items()}
    tree = ck.restore(p["dir"], p["step"], {key: 0 for key in specs},
                      shardings=to_shardings(mesh, specs))
    return {key: (np.asarray(t.to_local()), np.asarray(t.full_tensor()),
                  [repr(pl) for pl in t.placements])
            for key, t in tree.items()}


def usercf_task(rank, world, p):
    """``UserCF`` on the ``sharded`` and ``ring`` engines under every
    measure: the fitted state, ``predict`` (``sharded_predict``) and
    ``evaluate``; and the ``cf_movielens`` steps through ``build_step``
    with the mesh."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.cf_model import CFConfig, UserCF
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_step
    mesh = make_local_mesh(device="cpu")
    r = torch.from_numpy(p["ratings"])
    out = {}
    for engine in ("sharded", "ring"):
        for m in MEASURES:
            cf = UserCF(CFConfig(measure=m, top_k=p["k"], engine=engine,
                                 block_size=p["block_size"]), mesh,
                        device="cpu")
            st = cf.fit(r)
            out[(engine, m)] = (st.scores, st.idx, st.means)
        out[(engine, "predict")] = cf.predict(r)
        out[(engine, "evaluate")] = cf.evaluate(r, p["test"])
    arch = get_arch("cf_movielens")
    arch = dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, top_k=p["k"], block_size=p["block_size"]))
    s, i = build_step(arch, arch.cell("fit_ml1m"), mesh).fn({"ratings": r})
    out["step_fit"] = (s, i)
    out["step_predict"] = build_step(arch, arch.cell("predict_bulk"),
                                     mesh).fn({"ratings": r}, s, i)
    return _np(out)


def slope_task(rank, world, p):
    """``sharded_deviation`` and a meshed ``SlopeOne`` fit over every
    rank; with I not divisible by the axis, the error."""
    import torch
    from repro_torch.core import slope_one as so
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device="cpu")
    r = torch.from_numpy(p["ratings"])
    out = {"dev": so.sharded_deviation(r, mesh)}
    model = so.SlopeOne(mesh, device="cpu").fit(r)
    out["fit"] = (model.dev, model.counts)
    out["predict"] = model.predict(r)
    try:
        so.sharded_deviation(r[:, :-1], mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    return _np(out)


def compressed_psum_task(rank, world, p):
    """``compressed_psum`` of this rank's row of ``p["x"]`` over the
    default group, in f32 and bf16."""
    import torch
    from repro_torch.training.compression import compressed_psum
    x = torch.from_numpy(p["x"][rank])
    return {"f32": compressed_psum(x).numpy(),
            "bf16": compressed_psum(x.bfloat16()).float().numpy()}


def _full(x):
    """A DTensor (or a tree of them) gathered whole, as numpy."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, dict):
        return {k: _full(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_full(v) for v in x)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return _np(x)


def _meshes(shapes):
    from repro_torch.launch.mesh import make_local_mesh
    return {shape: make_local_mesh(shape, axes, device="cpu")
            for shape, axes in shapes}


def lm_mesh_task(rank, world, p):
    """The LM's sharded loss and gradients (``transformer.backward`` under
    ``make_ctx``) for each case of ``p["cases"]``: the gradients gathered
    whole, and each MoE call's expert ids on this rank; then
    ``build_step``'s meshed train step (two AdamW steps), the prefill /
    decode plans on a mesh (their out-shardings, or what they raise) and
    the trained meshed model's ``prefill`` of a row of zeros a rank."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.checkpoint import tree_flatten
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tx
    from repro_torch.state import transformer_from_reference
    meshes = _meshes(p["meshes"])
    out = {}
    orig = tx.router_topk
    for key, case in p["cases"].items():
        cfg, mesh = case["cfg"], meshes[case["mesh"]]
        sc = shd.make_ctx(mesh)
        model = transformer_from_reference(cfg, p["params"][case["params"]],
                                           device="cpu")
        placed = steps.place_model(model, shd.to_shardings(
            mesh, tx.param_specs(cfg)))
        params = placed.tree()
        local = steps._local_leaves(params)
        rows = steps._lm_rows(p["batch"], mesh, shd.batch_axes(mesh),
                              cfg.microbatch, "cpu")
        loss = tx.backward(cfg, local, rows, sc=sc)
        grads = _full(steps._dtensor_grads(params, local))
        ids = []

        def router(probs, k, *, use_kernel=True):
            vals, idx = orig(probs, k, use_kernel=use_kernel)
            ids.append(idx)
            return vals, idx
        tx.router_topk = router         # each µbatch's forward, no remat
        try:
            with torch.no_grad():
                mb = cfg.microbatch
                for u in range(mb):
                    n = rows["tokens"].shape[0] // mb
                    tx.loss_fn(cfg, local, {k: v[u * n:(u + 1) * n]
                                            for k, v in rows.items()},
                               sc=sc)
        finally:
            tx.router_topk = orig
        out[key] = {"loss": float(loss), "ids": _np(ids),
                    "grads": tree_flatten(grads) if rank == 0 else None}
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.models.common import NO_SHARDING
    mesh = meshes[(2, 2)]
    sc = shd.make_ctx(mesh)
    x = torch.arange(8.0).reshape(4, 2)
    dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
    got = sc.constrain(dx, "data", None)
    out["constrain"] = ([repr(pl) for pl in got.placements],
                        torch.equal(got.full_tensor(), x),
                        NO_SHARDING.constrain(dx, "data") is dx,
                        sc.constrain(x, "data") is x)
    for shape, mesh in meshes.items():
        for dp in (False, True):
            sc = shd.make_ctx(mesh, dp_over_all=dp)
            out[("ctx", shape, dp)] = (sc.batch, sc.model, sc.fsdp,
                                       sc.enabled, sc.mesh is mesh)
    for key, case in p.get("steps", {}).items():
        mesh = meshes[case["mesh"]]
        arch = dataclasses.replace(get_arch(case["arch"]),
                                   config=case["cfg"])
        cell = dataclasses.replace(arch.cell("train_4k"),
                                   dims={"batch": 4, "seq": 16})
        plan = steps.build_step(arch, cell, mesh)
        model = steps.place_model(transformer_from_reference(
            case["cfg"], p["params"][case["params"]], device="cpu"),
            plan.in_shardings[0])
        state = plan.optimizer.init(model.tree())
        losses = []
        for batch in case["batches"]:
            model, state, loss = plan.fn(model, state, batch)
            losses.append(float(loss))
        raised, served = {}, {}
        for cell_name in ("prefill_32k", "decode_32k"):
            try:
                plan = steps.build_step(arch, arch.cell(cell_name), mesh)
                served[cell_name] = (
                    repr(plan.out_shardings[0].spec),
                    {k: repr(v.spec) for k, v in
                     plan.out_shardings[1].items()})
            except NotImplementedError as e:
                raised[cell_name] = str(e)
        try:
            logits, cache = model.prefill(torch.zeros((1, 4),
                                                      dtype=torch.int32))
            served["model.prefill"] = (_np(logits), {
                k: tuple(v.shape) for k, v in cache.items()})
        except NotImplementedError as e:
            raised["model.prefill"] = str(e)
        params = _full(model.tree())
        out[key] = {"losses": losses, "raised": raised, "served": served,
                    "step": int(state["step"]),
                    "params": tree_flatten(params) if rank == 0 else None,
                    "specs": [repr(s.spec) for s in
                              tree_flatten(plan.in_shardings[0])]}
    return out


def lm_serve_task(rank, world, p):
    """The LM's meshed prefill and decode plans (``build_step`` on a mesh)
    for each case of ``p["cases"]`` whose mesh has ``world`` ranks: the
    prompt prefilled into a cache of ``p["max_len"]`` positions, then one
    decode step a token of ``p["feed"]`` (teacher-forced); the logits of
    every call and the cache after the prefill and after the last step,
    gathered whole, and each MoE call's expert ids on this rank.  Then
    the plans' refusals (a cache length that does not split over
    ``model``) and the cache placement's round trip."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tx
    from repro_torch.state import transformer_from_reference
    meshes = _meshes([m for m in p["meshes"] if np.prod(m[0]) == world])
    out = {}
    orig = tx.router_topk
    for key, case in p["cases"].items():
        if case["mesh"] not in meshes:
            continue
        mesh, cfg = meshes[case["mesh"]], case["cfg"]
        arch = dataclasses.replace(get_arch(case["arch"]), config=cfg)
        pre = steps.build_step(arch, arch.cell("prefill_32k"), mesh)
        dec = steps.build_step(arch, arch.cell("decode_32k"), mesh)
        model = steps.place_model(transformer_from_reference(
            cfg, p["params"][case["params"]], device="cpu"),
            pre.in_shardings[0])
        ids = []

        def router(probs, k, *, use_kernel=True):
            vals, idx = orig(probs, k, use_kernel=use_kernel)
            ids.append(idx)
            return vals, idx
        tx.router_topk = router
        try:
            logits, cache = pre.fn(model, {"tokens": p["prompt"]},
                                   max_len=p["max_len"])
            got = {"logits": [_full(logits)], "prefill_cache": _full(cache)}
            first = cache
            for tok in p["feed"]:
                logits, cache = dec.fn(model, {"tokens": tok,
                                               "cache": cache})
                got["logits"].append(_full(logits))
        finally:
            tx.router_topk = orig
        got["cache"] = _full(cache)
        got["ids"] = _np(ids)
        got["placements"] = {k: [repr(pl) for pl in v.placements]
                             for k, v in cache.items()}
        got["local_shapes"] = {k: tuple(v.to_local().shape)
                               for k, v in cache.items()}
        # a whole cache into the decode plan: placed there, same step
        whole = tx.gather_cache(first)
        got["from_whole"] = _full(dec.fn(model, {
            "tokens": p["feed"][0], "cache": whole})[0])
        try:
            pre.fn(model, {"tokens": p["prompt"]})
        except ValueError as e:
            got["indivisible"] = str(e)
        out[key] = got if rank == 0 else {"ids": got["ids"]}
    for shape, mesh in meshes.items():
        cfg = p["roundtrip_cfg"]
        whole = {k: torch.from_numpy(v) for k, v in p["roundtrip"].items()}
        placed = tx.place_cache(cfg, whole, mesh)
        back = tx.gather_cache(placed)
        res = {"equal": all(torch.equal(back[k], whole[k]) for k in whole),
               "local": {k: _np(v.to_local()) for k, v in placed.items()}}
        odd = dict(whole, k=whole["k"][..., :-1, :],
                   v=whole["v"][..., :-1, :])
        try:
            tx.place_cache(cfg, odd, mesh)
        except ValueError as e:
            res["indivisible"] = str(e)
        out[("roundtrip", shape)] = res
    return out


def recsys_mesh_task(rank, world, p):
    """Each recsys model's meshed ``build_step`` plans on each mesh of
    ``p["meshes"]``: two train steps from the reference's parameters
    (the updated parameters gathered whole, the losses), serve and
    retrieval gathered whole; and the sharded lookup's gradient through
    the exchange on the (2, 2) mesh."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models.embedding import TableLayout, sharded_lookup
    from repro_torch.state import recsys_from_reference
    from repro_torch.distributed.checkpoint import tree_flatten
    meshes = _meshes(p["meshes"])
    out = {}
    for (name, shape), case in p["cases"].items():
        mesh = meshes[shape]
        arch = dataclasses.replace(get_arch(name), config=case["cfg"])
        res = {}
        for cell_name, batch in case["batches"].items():
            cell = dataclasses.replace(arch.cell(cell_name),
                                       dims=case["dims"][cell_name])
            plan = steps.build_step(arch, cell, mesh)
            model = steps.place_model(recsys_from_reference(
                case["cfg"], case["params"], device="cpu"),
                plan.in_shardings[0])
            if cell.step == "train":
                state = plan.optimizer.init(model.tree())
                losses = []
                for b in batch:
                    model, state, loss = plan.fn(model, state, b)
                    losses.append(float(loss))
                res[cell_name] = {"losses": losses, "step": int(
                    state["step"]), "params": tree_flatten(_full(
                        model.tree()))}
            else:
                res[cell_name] = _full(plan.fn(model, batch))
        out[(name, shape)] = res if rank == 0 else None
    if "exchange" in p:
        e = p["exchange"]
        mesh = meshes[e["mesh"]]
        layout = TableLayout(**e["layout"])
        rows = layout.sharded_rows // world
        block = torch.from_numpy(
            e["sharded"][rank * rows:(rank + 1) * rows]).requires_grad_()
        rep = torch.from_numpy(e["replicated"]).requires_grad_()
        b = e["ids"].shape[0] // world
        mine = torch.from_numpy(e["ids"][rank * b:(rank + 1) * b])
        got = sharded_lookup(layout, {"sharded": block, "replicated": rep},
                             mine, mesh)
        (got ** 2).sum().backward()
        out["exchange"] = {"block": _np(block.grad), "replicated":
                           _np(rep.grad), "vals": _np(got)}
    return out


def egnn_mesh_task(rank, world, p):
    """EGNN's meshed ``build_step`` train step for each case of
    ``p["cases"]`` whose mesh has ``world`` ranks: ``p["steps"]`` AdamW
    steps from the reference's parameters on one global batch (the
    losses; the updated parameters gathered whole), and the plan's batch
    shardings."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.checkpoint import tree_flatten
    from repro_torch.launch import steps
    from repro_torch.state import egnn_from_reference
    meshes = _meshes([m for m in p["meshes"] if np.prod(m[0]) == world])
    out = {}
    for (cell_name, shape), case in p["cases"].items():
        if shape not in meshes:
            continue
        arch = dataclasses.replace(get_arch("egnn"), config=p["cfg"])
        cell = dataclasses.replace(arch.cell(cell_name), dims=case["dims"])
        plan = steps.build_step(arch, cell, meshes[shape])
        model = steps.place_model(egnn_from_reference(
            p["cfg"], p["params"], device="cpu"), plan.in_shardings[0])
        state = plan.optimizer.init(model.tree())
        losses = []
        for _ in range(p["steps"]):
            model, state, loss = plan.fn(model, state, case["batch"])
            losses.append(float(loss))
        params = tree_flatten(_full(model.tree()))
        out[(cell_name, shape)] = {
            "losses": losses, "step": int(state["step"]),
            "params": params if rank == 0 else None,
            "batch_specs": {k: tuple(v.spec)
                            for k, v in plan.in_shardings[2].items()}}
    return out


TASKS = {"engine": engine_task, "kmeans": kmeans_task,
         "embedding": embedding_task, "restore": restore_task,
         "usercf": usercf_task, "slope": slope_task,
         "compressed_psum": compressed_psum_task,
         "lm_mesh": lm_mesh_task, "lm_serve": lm_serve_task,
         "recsys_mesh": recsys_mesh_task, "egnn_mesh": egnn_mesh_task}
