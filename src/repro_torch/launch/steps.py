"""Step builders of the port (counterpart of ``repro.launch.steps``):
(arch × shape cell) → a ``StepPlan`` with the step function and its
example input shapes.

The LM serving steps of the reference's ``_lm_step`` (``steps.py:59``:
prefill at :115, decode at :128) and the recsys CTR steps of its
``_recsys_step`` (``steps.py:199``: serve at :236, retrieval at :250)
without a mesh: the port runs at world size 1, so there are no shardings
to state.  The step functions take the model
(``repro_torch.models.transformer.Transformer``, ``models.dlrm.DLRM``,
``models.fm.FM``, ``models.xdeepfm.XDeepFM``) where the reference takes
its parameter tree.  Training and the other families raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.configs.registry import ArchSpec, ShapeCell, input_specs


@dataclasses.dataclass
class StepPlan:
    name: str
    fn: Callable
    example_args: Dict[str, Any]     # input name → TensorSpec (or a tree)


def build_step(arch: ArchSpec, cell: ShapeCell) -> StepPlan:
    if arch.kind == "lm":
        return _lm_step(arch, cell)
    if arch.kind == "recsys":
        return _recsys_step(arch, cell)
    raise NotImplementedError(
        f"{arch.kind} steps are not ported yet (ROADMAP Queue 1 item 11: "
        f"side workloads{'; CF: item 10' if arch.kind == 'cf' else ''})")


def _lm_step(arch: ArchSpec, cell: ShapeCell) -> StepPlan:
    name = f"{arch.name}:{cell.name}"
    if cell.step == "train":
        raise NotImplementedError(
            f"{name}: LM training (loss, backward, optimizer) is not ported "
            f"yet (ROADMAP Queue 1 item 11)")
    inputs = input_specs(arch, cell)
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
    if cell.step == "train":
        raise NotImplementedError(
            f"{name}: recsys training (loss, adagrad, train step) is not "
            f"ported yet (ROADMAP Queue 1 item 11)")
    inputs = input_specs(arch, cell)
    if cell.step == "serve":
        def step(model, batch):
            """Logits (B,) for ``batch`` (sparse ids, DLRM's dense)."""
            return model(batch)
        return StepPlan(name=name, fn=step, example_args=inputs)
    if cell.step == "retrieval":
        def step(model, batch):
            """Scores (N,) of ``batch["candidates"]`` for one context."""
            return model.retrieval_score(batch)
        return StepPlan(name=name, fn=step, example_args=inputs)
    raise ValueError(cell.step)
