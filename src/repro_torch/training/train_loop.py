"""Fault-tolerant training loop: checkpoint/restart, stragglers, recovery
(port of ``repro.training.train_loop``).

The loop is model-agnostic: it drives any ``(params, opt_state, batch) →
(params, opt_state, loss)`` step, such as :func:`make_train_step` builds.
Failures (real exceptions or injected drills) trigger a restore from the
latest committed checkpoint and the loop goes on; persistent stragglers
are flagged.  Each failure counts ``train.failures`` and sets
``train.last_failure_step``; each recovery counts ``train.recoveries``
inside a ``train.recover`` span, as in the reference.

The parameter and optimizer-state trees are nested dicts / lists of
tensors.  The steps update them in place (``repro_torch.training.
optimizer``), and a restore copies the checkpoint's values into those
same tensors, so a module whose parameters are the tree's leaves sees
every step and every restore.  Checkpoints are the reference's layout
(``repro_torch.distributed.checkpoint``): either package resumes the
other's run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                     RecoveryPolicy,
                                                     StragglerWatchdog)
from repro_torch.training.compression import compress_decompress


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    grad_compression: bool = False
    max_restarts: int = 3


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    restarts: int
    straggler_steps: List[int]
    final_step: int
    params: Any
    opt_state: Any


@torch.no_grad()
def restore_into(ckpt_dir, step: int, tree: Any) -> Any:
    """Copy the checkpoint at ``step`` into the tensors of ``tree`` in
    place (dtype and device kept); returns ``tree``."""
    restored = ckpt.restore(ckpt_dir, step, tree)
    for leaf, arr in zip(ckpt.tree_flatten(tree),
                         ckpt.tree_flatten(restored)):
        leaf.copy_(torch.from_numpy(np.array(arr)))
    return tree


def run(step_fn: Callable, params: Any, opt_state: Any,
        batches: Callable[[int], Dict], cfg: TrainLoopConfig,
        injector: Optional[FaultInjector] = None,
        on_step: Optional[Callable[[int, float], None]] = None
        ) -> TrainResult:
    """Run the loop: ``step_fn(params, opt_state, batch)``.

    With ``cfg.checkpoint_dir`` set, the loop resumes from the latest
    committed step automatically (restart semantics) and recovers from
    failures mid-run.  ``batches`` must be restartable by step index:
    it is called as ``batches(step)``.
    """
    watchdog = StragglerWatchdog()
    policy = RecoveryPolicy(max_restarts=cfg.max_restarts)
    saver = ckpt.AsyncCheckpointer(cfg.checkpoint_dir,
                                   keep=cfg.keep_checkpoints) \
        if cfg.checkpoint_dir else None

    def state():
        return {"params": params, "opt": opt_state}

    start = 0
    if cfg.checkpoint_dir:
        latest = ckpt.latest_step(cfg.checkpoint_dir)
        if latest is not None:
            restore_into(cfg.checkpoint_dir, latest, state())
            start = latest
    losses: List[float] = []

    step = start
    while step < cfg.total_steps:
        try:
            t0 = time.perf_counter()
            if injector is not None:
                injector.check(step)
            batch = batches(step)
            params, opt_state, loss = step_fn(params, opt_state, batch)
            loss = float(loss)               # waits for the device
            dt = time.perf_counter() - t0
            losses.append(loss)
            if watchdog.observe(step, dt) and watchdog.needs_escalation:
                # report persistent straggler to the launcher (simulated)
                pass
            if on_step:
                on_step(step, loss)
            step += 1
            if saver and step % cfg.checkpoint_every == 0:
                saver.save(step, state())
        except Exception as e:
            # loud degrade: every failure is recorded before the recovery
            # path decides anything, so a restart can never be mistaken
            # for healthy steps in the metrics
            reg = obs.registry()
            reg.counter("train.failures").inc()
            reg.gauge("train.last_failure_step").set(step)
            policy.record_failure()
            if saver is None or not policy.can_restart:
                raise
            saver.wait()
            latest = ckpt.latest_step(cfg.checkpoint_dir)
            if latest is None:
                raise
            with obs.span("train.recover", step=step, restore_step=latest,
                          error=type(e).__name__):
                reg.counter("train.recoveries").inc()
                policy.record_restart()
                restore_into(cfg.checkpoint_dir, latest, state())
                step = latest

    if saver:
        saver.save(cfg.total_steps, state())
        saver.wait()
    return TrainResult(losses=losses, restarts=policy.restarts,
                       straggler_steps=watchdog.flagged_steps,
                       final_step=step, params=params, opt_state=opt_state)


def trainable(params: Any) -> Any:
    """Mark every floating-point leaf of ``params`` as requiring a
    gradient (in place); returns ``params``."""
    for p in ckpt.tree_flatten(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    return params


def take_grads(params: Any) -> Any:
    """The tree of the leaves' accumulated ``.grad`` (zeros for a leaf no
    gradient reached), detached from the leaves, whose ``.grad`` is reset
    to None."""
    grads = []
    for p in ckpt.tree_flatten(params):
        g = p.grad
        p.grad = None
        grads.append(torch.zeros_like(p) if g is None else g)
    return ckpt.tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, optimizer, *,
                    compression: bool = False) -> Callable:
    """Standard step factory: ``loss_fn(params, batch)``, ``backward()``,
    (compress), ``optimizer.update`` on the tree.

    With compression the state is ``{"opt": <optimizer state>, "ef":
    <error-feedback residuals>}`` (build the ``ef`` part with
    ``init_compression(params)``)."""
    def grad(params, batch):
        for p in ckpt.tree_flatten(trainable(params)):
            p.grad = None
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            loss.backward()
        return loss.detach(), take_grads(params)

    if not compression:
        def step(params, opt_state, batch):
            loss, grads = grad(params, batch)
            params, opt_state = optimizer.update(params, grads, opt_state)
            return params, opt_state, loss
        return step

    def step(params, state, batch):
        loss, grads = grad(params, batch)
        grads, ef = compress_decompress(grads, state["ef"])
        state["ef"] = ef
        params, state["opt"] = optimizer.update(params, grads, state["opt"])
        return params, state, loss
    return step
