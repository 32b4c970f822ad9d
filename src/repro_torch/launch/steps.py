"""Step builders of the port (counterpart of ``repro.launch.steps``):
(arch × shape cell [× mesh]) → a ``StepPlan`` with the step function and
its example input shapes.

The LM steps of the reference's ``_lm_step`` (``steps.py:59``: train at
:72, prefill at :115, decode at :128) and the recsys steps of its
``_recsys_step`` (``steps.py:199``: train at :218, serve at :236 —
BERT4Rec's through ``serve_scores`` — and retrieval at :250) without a
mesh: the port runs them at world size 1, so there are no shardings to
state.  The LM steps serve and train every LM config of the registry:
dense, MoE (Qwen3-30B-A3B) and MoE + MLA (DeepSeek-V2, whose decode
cache is the latent c_kv / k_rope).  The step functions take the model
(``repro_torch.models.transformer.Transformer``, ``models.dlrm.DLRM``,
``models.fm.FM``, ``models.xdeepfm.XDeepFM``, ``models.bert4rec.
BERT4Rec``) where the reference takes its parameter tree.  A train step
is ``fn(model, opt_state, batch) → (model, opt_state, loss)``: the
gradient of the model's parameter tree (the LM's mean over
``cfg.microbatch`` µbatches), then ``plan.optimizer``'s update written
into the model's parameters (build the state with
``plan.optimizer.init(model.tree())``).  The CF steps of ``_cf_step``
(``steps.py:265``) run the mesh engines of :mod:`repro_torch.core.engine`
on ``torch.distributed`` over the mesh given to ``build_step`` (None: the
engine's ``default_mesh`` on the batch's device), sharding over its
first axis.  The GNN family raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.registry import (ArchSpec, ShapeCell, TensorSpec,
                                          input_specs)
from repro_torch.distributed.checkpoint import tree_flatten
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import (make_train_step, take_grads,
                                             trainable)


@dataclasses.dataclass
class StepPlan:
    name: str
    fn: Callable
    example_args: Dict[str, Any]     # input name → TensorSpec (or a tree)
    optimizer: Any = None            # a train step's optimizer


def _on(model, batch) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(val, device=model.device)
            for key, val in batch.items()}


def build_step(arch: ArchSpec, cell: ShapeCell, mesh=None) -> StepPlan:
    """``mesh``: the ``DeviceMesh`` of the CF steps (the other families
    run at world size 1 and do not read it)."""
    if arch.kind == "lm":
        return _lm_step(arch, cell)
    if arch.kind == "recsys":
        return _recsys_step(arch, cell)
    if arch.kind == "cf":
        return _cf_step(arch, cell, mesh)
    raise NotImplementedError(
        f"{arch.kind} steps are not ported yet (ROADMAP Queue 1 item 11: "
        f"side workloads)")


def _lm_step(arch: ArchSpec, cell: ShapeCell) -> StepPlan:
    name = f"{arch.name}:{cell.name}"
    inputs = input_specs(arch, cell)
    if cell.step == "train":
        from repro_torch.models import transformer as tx
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
    if cell.step == "decode":
        def step(model, batch):
            """(logits (B, V), cache) for one token per sequence."""
            return model.decode_step(batch["tokens"], batch["cache"])
        return StepPlan(name=name, fn=step, example_args=inputs)
    raise ValueError(cell.step)


def _recsys_step(arch: ArchSpec, cell: ShapeCell) -> StepPlan:
    name = f"{arch.name}:{cell.name}"
    inputs = input_specs(arch, cell)
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
    if cell.step == "retrieval":
        def step(model, batch):
            """Scores (N,) of ``batch["candidates"]`` for one context."""
            return model.retrieval_score(batch)
        return StepPlan(name=name, fn=step, example_args=inputs)
    raise ValueError(cell.step)


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
