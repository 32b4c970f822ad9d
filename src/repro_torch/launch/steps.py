"""Step builders of the port (counterpart of ``repro.launch.steps``):
(arch × shape cell × mesh) → a ``StepPlan`` with the step function, its
example input shapes and, on a mesh, its in / out shardings.

The LM steps of the reference's ``_lm_step`` (``steps.py:59``: train at
:72, prefill at :115, decode at :128) and the recsys steps of its
``_recsys_step`` (``steps.py:199``: train at :218, serve at :236 —
BERT4Rec's through ``serve_scores`` — and retrieval at :250), and the
GNN train step of its ``_gnn_step`` (``steps.py:149``) for every cell
of EGNN (a full graph, a sampled subgraph, a batch of molecules).  The
LM steps serve and train every LM config of the registry: dense, MoE
(Qwen3-30B-A3B) and MoE + MLA (DeepSeek-V2, whose decode cache is the
latent c_kv / k_rope).  The step functions take the model
(``repro_torch.models.transformer.Transformer``, ``models.dlrm.DLRM``,
``models.fm.FM``, ``models.xdeepfm.XDeepFM``, ``models.bert4rec.
BERT4Rec``, ``models.egnn.EGNN`` built at the cell's ``d_feat``) where
the reference takes its parameter tree.  A train step
is ``fn(model, opt_state, batch) → (model, opt_state, loss)``: the
gradient of the model's parameter tree (the LM's mean over
``cfg.microbatch`` µbatches), then ``plan.optimizer``'s update written
into the model's parameters (build the state with
``plan.optimizer.init(model.tree())``).

Without a mesh (``mesh=None``) the LM, GNN and recsys steps run on one
device and ``in_shardings`` / ``out_shardings`` are None.  With a
``DeviceMesh`` (every rank calls, SPMD) they are the reference's
``NamedSharding`` trees: parameters by the model's ``param_specs``,
optimizer state by ``opt.state_specs``, the LM batch over the batch
axes, the recsys batch over every axis where its leading dimension
divides by 512 (the reference's rule) and replicated elsewhere.  The
model's parameters are DTensors placed by ``in_shardings[0]``
(:func:`place_model`); the batch is the global batch, the same on every
rank, of which each rank takes its rows.

* The LM train step (``make_ctx(mesh)``): tensor-, FSDP- and
  expert-parallel ``transformer.backward`` on each rank's shards, each
  µbatch's rows split over the batch axes as the reference's µbatch
  reshape splits them; the gradients reduced to the parameters'
  placements; AdamW on the DTensors.
* The LM prefill and decode steps (the reference's ``steps.py:115-143``):
  each rank serves its rows of the global batch (split over the batch
  axes) on the meshed model (``Transformer.prefill`` / ``decode_step``:
  tensor- and expert-parallel over ``model``, the decode cache's sequence
  over ``model``, flash-decoding's partial outputs merged by their
  log-sum-exp).  They return DTensors on ``out_shardings``: the logits
  ``P(baxes, "model")`` (each rank its rows' vocabulary slice) and the
  cache by ``transformer.cache_specs``.  Decode takes the cache as a
  prefill returned it, or whole (placed by ``transformer.place_cache``).
* The recsys steps (``make_ctx(mesh, dp_over_all=True)``): the batch's
  rows (retrieval's candidates; its one context stays whole) split over
  every rank, as the reference's lookup ``shard_map`` splits the ids;
  the sharded tables' blocks looked up through the differentiable
  exchange; the dense nets data-parallel; serve and retrieval return
  DTensors on ``out_shardings``.
* The GNN train step (the reference's ``_gnn_step``, ``steps.py:149``;
  ``make_ctx(mesh, dp_over_all=True)``): for ``molecule`` the batch's
  graphs split over the batch axes, the loss the global batch's Σ NLL
  over its labelled-node count (each graph counted once, whatever the
  ``model`` axis holds) and the gradients summed over the batch axes;
  for every other cell the node tensors whole on every rank and the edge
  list split over every mesh axis, each rank's messages summed into a
  whole node table and those tables summed over all ranks
  (``models.egnn``'s collectives), the node-side gradients whole on
  every rank and the edge-side ones summed there.

The CF steps of ``_cf_step`` (``steps.py:265``) run the mesh engines of
:mod:`repro_torch.core.engine` on ``torch.distributed`` over the mesh
given to ``build_step`` (None: the engine's ``default_mesh`` on the
batch's device), sharding over its first axis.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.registry import (ArchSpec, ShapeCell, TensorSpec,
                                          input_specs)
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpoint import tree_flatten, tree_unflatten
from repro_torch.distributed.sharding import P
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import (make_train_step, take_grads,
                                             trainable)


@dataclasses.dataclass
class StepPlan:
    name: str
    fn: Callable
    example_args: Dict[str, Any]     # input name → TensorSpec (or a tree)
    optimizer: Any = None            # a train step's optimizer
    in_shardings: Any = None         # NamedSharding trees, on a mesh
    out_shardings: Any = None


def _on(model, batch) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(val, device=model.device)
            for key, val in batch.items()}


def _ns(mesh, spec) -> shd.NamedSharding:
    return shd.NamedSharding(mesh, shd._sanitize(mesh, spec))


def build_step(arch: ArchSpec, cell: ShapeCell, mesh=None) -> StepPlan:
    """``mesh``: a ``DeviceMesh`` (the LM, GNN and recsys steps on it, SPMD),
    or None (one device; the CF steps then take the engine's default
    mesh)."""
    if arch.kind == "lm":
        return _lm_step(arch, cell, mesh)
    if arch.kind == "gnn":
        return _gnn_step(arch, cell, mesh)
    if arch.kind == "recsys":
        return _recsys_step(arch, cell, mesh)
    if arch.kind == "cf":
        return _cf_step(arch, cell, mesh)
    raise ValueError(arch.kind)


def place_model(model, shardings):
    """``model`` (whole parameters, the same on every rank) rebuilt with
    its parameters as DTensors placed by ``shardings`` (a mesh plan's
    ``in_shardings[0]``), each rank keeping its slices; no collective
    runs."""
    tree = shd.distribute(
        tree_unflatten(model.tree(), [p.detach() for p in
                                      tree_flatten(model.tree())]),
        shardings)
    kw = {"use_kernel": model.use_kernel} if hasattr(model, "use_kernel") \
        else {}
    return type(model)(model.cfg, tree, **kw)


def _from_local(t: torch.Tensor, sharding):
    """This rank's block ``t`` of a tensor split evenly by ``sharding``
    (a ``NamedSharding``) as the DTensor of the whole; no collective."""
    from torch.distributed.tensor import DTensor, Shard
    shape = list(t.shape)
    for md, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            shape[pl.dim] *= sharding.mesh.size(md)
    return DTensor.from_local(t, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a size-0 dimension
    counted as 1, as torch does), without making one."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def _local_leaves(params):
    """The DTensor leaves' local shards as leaves of their own that
    require a gradient (sharing the DTensors' storage)."""
    return tree_unflatten(params, [p.to_local().detach().requires_grad_()
                                   for p in tree_flatten(params)])


def _dtensor_grads(params, local):
    """The local leaves' ``.grad`` (zeros where none arrived) as DTensors
    on their parameters' placements."""
    from torch.distributed.tensor import DTensor
    out = []
    for p, leaf in zip(tree_flatten(params), tree_flatten(local)):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        out.append(DTensor.from_local(g, p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape,
                                      stride=p.stride()))
    return tree_unflatten(params, out)


def _meshed(model) -> None:
    from torch.distributed.tensor import DTensor
    if not isinstance(tree_flatten(model.tree())[0], DTensor):
        raise ValueError("a mesh step takes a model whose parameters are "
                         "DTensors: place it with place_model(model, "
                         "plan.in_shardings[0])")


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_rows(batch, mesh, axes, mb: int, device) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global (B, S) batch: each µbatch's rows
    (the reference's (mb, B / mb, S) reshape) split over ``axes``, the
    µbatches kept in order."""
    n, r = coll.axis_size(mesh, axes), coll.axis_rank(mesh, axes)
    out = {}
    for key, val in batch.items():
        x = torch.as_tensor(val, device=device)
        b, s = x.shape
        if b % (mb * n):
            raise ValueError(f"{b} rows do not split into {mb} µbatches "
                             f"over {n} ranks")
        out[key] = x.reshape(mb, b // mb, s).chunk(n, dim=1)[r] \
            .reshape(-1, s)
    return out


def _lm_step(arch: ArchSpec, cell: ShapeCell, mesh) -> StepPlan:
    name = f"{arch.name}:{cell.name}"
    inputs = input_specs(arch, cell)
    if cell.step not in ("train", "prefill", "decode"):
        raise ValueError(cell.step)
    from repro_torch.models import transformer as tx
    if mesh is not None:
        if cell.step == "train":
            return _lm_train_mesh(arch, cell, mesh, inputs)
        return _lm_serve_mesh(arch, cell, mesh, inputs)
    if cell.step == "train":
        opt = get_optimizer(arch.optimizer)

        def step(model, opt_state, batch):
            """One AdamW step on ``batch`` {tokens, labels} (B, S); the
            model's compute copy is cast again after the update."""
            params = trainable(model.tree())
            for leaf in tree_flatten(params):
                leaf.grad = None
            loss = tx.backward(model.cfg, params, _on(model, batch),
                               use_kernel=model.use_kernel)
            opt.update(params, take_grads(params), opt_state)
            model.refresh()
            return model, opt_state, loss
        return StepPlan(name=name, fn=step, example_args=inputs,
                        optimizer=opt)
    if cell.step == "prefill":
        def step(model, batch, max_len=None):
            """(logits (B, V), cache) for ``batch["tokens"]`` (B, S)."""
            return model.prefill(batch["tokens"], max_len=max_len)
        return StepPlan(name=name, fn=step, example_args=inputs)

    def step(model, batch):
        """(logits (B, V), cache) for one token per sequence."""
        return model.decode_step(batch["tokens"], batch["cache"])
    return StepPlan(name=name, fn=step, example_args=inputs)


def _lm_train_mesh(arch: ArchSpec, cell: ShapeCell, mesh,
                   inputs) -> StepPlan:
    """The reference's meshed LM train step (``steps.py:72-113``)."""
    from repro_torch.models import transformer as tx
    cfg = arch.config
    sc = shd.make_ctx(mesh)
    baxes = shd.batch_axes(mesh)
    pspecs = tx.param_specs(cfg)
    params_sh = shd.to_shardings(mesh, pspecs)
    opt = get_optimizer(arch.optimizer)
    opt_sh = shd.to_shardings(mesh, opt.state_specs(pspecs))
    batch_sh = {"tokens": _ns(mesh, P(baxes, None)),
                "labels": _ns(mesh, P(baxes, None))}

    def step(model, opt_state, batch):
        """One AdamW step of the meshed model on the global ``batch``
        {tokens, labels} (B, S); the loss is the global batch's."""
        _meshed(model)
        params = model.tree()
        local = _local_leaves(params)
        rows = _lm_rows(batch, mesh, baxes, model.cfg.microbatch,
                        tree_flatten(local)[0].device)
        loss = tx.backward(model.cfg, local, rows,
                           use_kernel=model.use_kernel, sc=sc)
        opt.update(params, _dtensor_grads(params, local), opt_state)
        model.refresh()
        return model, opt_state, loss
    return StepPlan(name=f"{arch.name}:{cell.name}", fn=step,
                    example_args=inputs, optimizer=opt,
                    in_shardings=(params_sh, opt_sh, batch_sh),
                    out_shardings=(params_sh, opt_sh, _ns(mesh, P())))


def _lm_serve_mesh(arch: ArchSpec, cell: ShapeCell, mesh,
                   inputs) -> StepPlan:
    """The reference's meshed prefill and decode plans (``steps.py:115-
    143``): tokens over the batch axes, logits ``P(baxes, "model")``, the
    cache on ``cache_specs``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as tx
    cfg = arch.config
    baxes = shd.batch_axes(mesh)
    params_sh = shd.to_shardings(mesh, tx.param_specs(cfg))
    cache_sh = shd.to_shardings(mesh, tx.cache_specs(cfg, baxes))
    tok_sh = _ns(mesh, P(baxes, None))
    logits_sh = _ns(mesh, P(baxes, "model"))
    name = f"{arch.name}:{cell.name}"

    def rows(model, batch):
        _meshed(model)
        return _lm_rows({"tokens": batch["tokens"]}, mesh, baxes, 1,
                        model.device)["tokens"]

    def placed(logits, cache):
        return (_from_local(logits, logits_sh),
                {key: _from_local(val, cache_sh[key])
                 for key, val in cache.items()})

    if cell.step == "prefill":
        @torch.inference_mode()
        def step(model, batch, max_len=None):
            """(logits (B, V), cache) as DTensors for the global
            ``batch["tokens"]`` (B, S); ``max_len`` (default S) must
            split over ``model``."""
            return placed(*model.prefill(rows(model, batch),
                                         max_len=max_len))
        return StepPlan(name=name, fn=step, example_args=inputs,
                        in_shardings=(params_sh, {"tokens": tok_sh}),
                        out_shardings=(logits_sh, cache_sh))

    @torch.inference_mode()
    def step(model, batch):
        """(logits (B, V), cache) as DTensors for one token per sequence
        of the global ``batch["tokens"]`` (B, 1), from ``batch["cache"]``
        (DTensors on ``cache_sh``, or the whole cache)."""
        cache = batch["cache"]
        if not isinstance(cache["len"], DTensor):
            cache = tx.place_cache(cfg, cache, mesh)
        return placed(*model.decode_step(rows(model, batch), {
            key: val.to_local() for key, val in cache.items()}))
    return StepPlan(name=name, fn=step, example_args=inputs,
                    in_shardings=(params_sh, {"tokens": tok_sh,
                                              "cache": cache_sh}),
                    out_shardings=(logits_sh, cache_sh))


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def _split(x: torch.Tensor, mesh, axes, dim: int, key: str) -> torch.Tensor:
    """This rank's block of ``x`` split evenly on ``dim`` over ``axes``
    (the first axis outermost, DTensor's layout)."""
    n, r = coll.axis_size(mesh, axes), coll.axis_rank(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"{key}: {x.shape[dim]} do not split over {n} "
                         f"ranks")
    return x.chunk(n, dim=dim)[r]


def _gnn_step(arch: ArchSpec, cell: ShapeCell, mesh) -> StepPlan:
    """One AdamW step of EGNN (the reference's ``_gnn_step``, ``steps.py:
    149-190``), ``fn(model, opt_state, batch) → (model, opt_state,
    loss)``; the model is built at the cell's ``d_feat``."""
    from repro_torch.models import egnn as eg
    if cell.step != "train":
        raise ValueError(cell.step)
    name = f"{arch.name}:{cell.name}"
    cfg = dataclasses.replace(arch.config, d_feat=cell.dims["d_feat"])
    inputs = input_specs(arch, cell)
    opt = get_optimizer(arch.optimizer)
    if mesh is None:
        def step(model, opt_state, batch):
            """One AdamW step on the model's loss."""
            fn = make_train_step(lambda p, b: model.loss(b), opt)
            _, opt_state, loss = fn(model.tree(), opt_state, batch)
            return model, opt_state, loss
        return StepPlan(name=name, fn=step, example_args=inputs,
                        optimizer=opt)

    sc = shd.make_ctx(mesh, dp_over_all=True)
    baxes = shd.batch_axes(mesh)
    pspecs = eg.param_specs(cfg)
    params_sh = shd.to_shardings(mesh, pspecs)
    opt_sh = shd.to_shardings(mesh, opt.state_specs(pspecs))
    molecule = cell.name == "molecule"
    if molecule:
        batch_sh = {k: _ns(mesh, P(baxes, *((None,) * (len(v.shape) - 1))))
                    for k, v in inputs.items()}

        def rows(batch, device):
            return {k: _split(torch.as_tensor(v, device=device), mesh,
                              baxes, 0, k) for k, v in batch.items()}
    else:
        # nodes replicated, edge list sharded over every rank
        eaxes = shd.all_axes(mesh)
        batch_sh = {"feat": _ns(mesh, P(None, None)),
                    "coord": _ns(mesh, P(None, None)),
                    "edges": _ns(mesh, P(None, eaxes)),
                    "labels": _ns(mesh, P(None))}
        sc = dataclasses.replace(sc, batch=eaxes)
        edge_dim = {"edges": 1, "edge_feat": 0}

        def rows(batch, device):
            out = {k: torch.as_tensor(v, device=device)
                   for k, v in batch.items()}
            for k, dim in edge_dim.items():
                if k in out:
                    out[k] = _split(out[k], mesh, eaxes, dim, k)
            return out

    def step(model, opt_state, batch):
        """One AdamW step of the meshed model on the global ``batch``;
        the loss is the global batch's, the same on every rank."""
        _meshed(model)
        params = model.tree()
        local = _local_leaves(params)
        with torch.enable_grad():
            total, count = eg.nll_terms(model.cfg, local,
                                        rows(batch, model.device), sc,
                                        shard_edges=not molecule)
            if molecule:
                total = coll.reduce_from(total, mesh, baxes)
                count = coll.all_reduce_sum(count, mesh, baxes)
            loss = total / torch.clamp_min(count, 1)
            loss.backward()
        if molecule:
            shd.reduce_gradients(local, params_sh, baxes)
        opt.update(params, _dtensor_grads(params, local), opt_state)
        return model, opt_state, loss.detach()
    return StepPlan(name=name, fn=step, example_args=inputs, optimizer=opt,
                    in_shardings=(params_sh, opt_sh, batch_sh),
                    out_shardings=(params_sh, opt_sh, _ns(mesh, P())))


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def _recsys_step(arch: ArchSpec, cell: ShapeCell, mesh) -> StepPlan:
    name = f"{arch.name}:{cell.name}"
    inputs = input_specs(arch, cell)
    if cell.step not in ("train", "serve", "retrieval"):
        raise ValueError(cell.step)
    if mesh is not None:
        return _recsys_mesh(arch, cell, mesh, inputs)
    if cell.step == "train":
        opt = get_optimizer(arch.optimizer)

        def step(model, opt_state, batch):
            """One step of the arch's optimizer on the model's loss."""
            fn = make_train_step(lambda p, b: model.loss(b), opt)
            _, opt_state, loss = fn(model.tree(), opt_state, batch)
            return model, opt_state, loss
        return StepPlan(name=name, fn=step, example_args=inputs,
                        optimizer=opt)
    if cell.step == "serve":
        def step(model, batch):
            """Logits (B,) for ``batch`` (sparse ids, DLRM's dense);
            BERT4Rec's next-item scores (B, vocab) for its items."""
            return model(batch)
        return StepPlan(name=name, fn=step, example_args=inputs)

    def step(model, batch):
        """Scores (N,) of ``batch["candidates"]`` for one context."""
        return model.retrieval_score(batch)
    return StepPlan(name=name, fn=step, example_args=inputs)


def _recsys_rows(batch, mesh, device, split=None) -> Dict[str, torch.Tensor]:
    """This rank's share of a recsys batch: the inputs named in ``split``
    (default: all) split on their leading dimension over every rank of
    the mesh (rank order), the others whole."""
    n, r = mesh.size(), coll.axis_rank(mesh, mesh.mesh_dim_names)
    out = {}
    for key, val in batch.items():
        x = torch.as_tensor(val, device=device)
        if split is None or key in split:
            if x.shape[0] % n:
                raise ValueError(f"{key}: {x.shape[0]} rows do not split "
                                 f"over {n} ranks")
            x = x.chunk(n)[r]
        out[key] = x
    return out


def _recsys_mesh(arch: ArchSpec, cell: ShapeCell, mesh, inputs) -> StepPlan:
    """The reference's meshed recsys steps (``steps.py:199-262``)."""
    mod = importlib.import_module(f"repro_torch.models.{arch.model}")
    cfg = arch.config
    sc = shd.make_ctx(mesh, dp_over_all=True)
    aaxes = shd.all_axes(mesh)
    pspecs = mod.param_specs(cfg, aaxes) if arch.model != "bert4rec" \
        else mod.param_specs(cfg)
    params_sh = shd.to_shardings(mesh, pspecs)

    def batch_shard(v):
        if v.shape and v.shape[0] > 1 and v.shape[0] % 512 == 0:
            return _ns(mesh, P(aaxes, *((None,) * (len(v.shape) - 1))))
        return _ns(mesh, P(*((None,) * len(v.shape))))

    batch_sh = {k: batch_shard(v) for k, v in inputs.items()}
    name = f"{arch.name}:{cell.name}"

    if cell.step == "train":
        opt = get_optimizer(arch.optimizer)
        opt_sh = shd.to_shardings(mesh, opt.state_specs(pspecs))

        def step(model, opt_state, batch):
            """One step of the arch's optimizer on the global batch's
            loss (each rank's rows; the mean over every rank's)."""
            _meshed(model)
            params = model.tree()
            local = _local_leaves(params)
            with torch.enable_grad():
                loss = mod.loss_fn(cfg, local, _recsys_rows(
                    batch, mesh, model.device), mesh)
                loss.backward()
            shd.reduce_gradients(local, params_sh, sc.batch)
            opt.update(params, _dtensor_grads(params, local), opt_state)
            return model, opt_state, loss.detach()
        return StepPlan(name=name, fn=step, example_args=inputs,
                        optimizer=opt,
                        in_shardings=(params_sh, opt_sh, batch_sh),
                        out_shardings=(params_sh, opt_sh, _ns(mesh, P())))

    if cell.step == "serve":
        fwd = mod.serve_scores if arch.model == "bert4rec" else mod.forward
        out_sh = _ns(mesh, P(aaxes, None) if arch.model == "bert4rec"
                     else P(aaxes))
        split = None
    else:
        fwd = mod.retrieval_score
        out_sh = _ns(mesh, P(aaxes))
        split = ("candidates",)

    @torch.inference_mode()
    def step(model, batch):
        """This rank's rows of the scores, as a DTensor on
        ``out_shardings`` (``full_tensor()`` gathers them)."""
        _meshed(model)
        local = tree_unflatten(model.tree(), [
            p.to_local() for p in tree_flatten(model.tree())])
        return _from_local(fwd(cfg, local, _recsys_rows(
            batch, mesh, model.device, split), mesh), out_sh)
    return StepPlan(name=name, fn=step, example_args=inputs,
                    in_shardings=(params_sh, batch_sh), out_shardings=out_sh)


def _cf_step(arch: ArchSpec, cell: ShapeCell, mesh) -> StepPlan:
    """The paper's own architecture on a one-axis mesh: ``cf_fit`` through
    ``sharded_topk`` or ``ring_sharded_topk`` by ``config.engine`` (any
    engine but ``"sharded"`` takes the ring, as in the reference),
    ``cf_predict`` through ``ring_sharded_predict``."""
    from repro_torch.core import engine as E
    cfg = arch.config
    inputs = input_specs(arch, cell)
    name = f"{arch.name}:{cell.name}"

    def mesh_of(ratings):
        m = mesh if mesh is not None else E.default_mesh(ratings.device)
        return m, m.mesh_dim_names[0]

    if cell.step == "cf_fit":
        fit_engine = E.sharded_topk if cfg.engine == "sharded" \
            else E.ring_sharded_topk

        def step(batch):
            """(scores, ids), each (U, k), of ``batch["ratings"]``."""
            m, axis = mesh_of(batch["ratings"])
            return fit_engine(batch["ratings"], cfg.top_k, m,
                              measure=cfg.measure, axis=axis,
                              block_size=cfg.block_size)
        return StepPlan(name=name, fn=step, example_args=inputs)
    if cell.step == "cf_predict":
        u, k = cell.dims["users"], cfg.top_k

        def step(batch, scores, idx):
            """(U, I) predictions from the fitted (U, k) neighbors."""
            m, axis = mesh_of(batch["ratings"])
            return E.ring_sharded_predict(batch["ratings"], scores, idx, m,
                                          axis=axis)
        return StepPlan(name=name, fn=step, example_args={
            **inputs, "scores": TensorSpec((u, k), torch.float32),
            "idx": TensorSpec((u, k), torch.int32)})
    raise ValueError(cell.step)
