"""Optimizers (port of ``repro.training.optimizer``): SGD, AdamW and
Adagrad with the reference's functional shape.

``opt.init(params)`` builds the reference's state tree for a parameter
tree (nested dicts / lists of tensors): ``{"step"[, "mu"]}`` for SGD,
``{"step", "m", "v"}`` for AdamW, ``{"step", "acc"}`` for Adagrad, with
``step`` an int32 0-d tensor and the other subtrees the parameters'
shapes in f32.  So a training checkpoint of either package restores in
the other (``repro_torch.distributed.checkpoint`` numbers leaves in
JAX's order).  ``opt.update(params, grads, state)`` returns ``(params,
state)``; unlike the reference it writes the new values into the given
parameter and state tensors (under ``no_grad``) and returns those same
trees, so a step holds one copy of the parameters and of the state, and
a module whose parameters these are sees the update.  ``grads`` is read,
never written.

On a mesh the trees' leaves are DTensors, the state placed as its
parameter (``state_specs``): the updates are elementwise and run on each
rank's local shard, and AdamW's global norm sums each leaf's squares
over the mesh axes that shard it (a replicated leaf is counted once).

The formulas are the reference's, not ``torch.optim``'s: AdamW clips by
the global norm inside ``update``, adds ``eps`` to ``sqrt(v̂)`` with
``v̂ = v / bc2``, decays as ``p − lr·(m̂ / (√v̂ + ε) + wd·p)``, and takes
its bias corrections ``1 − b**step`` in f32, as ``b ** step.astype(f32)``
does in the reference (Python floats would be f64, ulps off).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.distributed.checkpoint import tree_flatten, tree_unflatten
from repro_torch.distributed.sharding import P


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    state_specs: Callable[[Any], Any]    # param spec tree → state spec tree


def _local(x):
    """A DTensor's local shard (sharing its storage); a tensor as is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _sq_sum(g) -> torch.Tensor:
    """Σ g² in f32 over the whole leaf: a DTensor's local sum, summed over
    the mesh dimensions of several ranks that shard it."""
    from torch.distributed.tensor import DTensor
    out = torch.sum(torch.square(_local(g).float()))
    if isinstance(g, DTensor):
        mesh = g.device_mesh
        for md, pl in enumerate(g.placements):
            if pl.is_shard() and mesh.size(md) > 1:
                torch.distributed.all_reduce(out, group=mesh.get_group(md))
    return out


def _zeros_like(params):
    return tree_unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                   for p in tree_flatten(params)])


def _step0(params):
    leaves = tree_flatten(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _leaves(*trees):
    """The trees' matching leaves, each a local tensor (DTensors' local
    shards, which share their storage: updating them updates the
    DTensor)."""
    flat = [[_local(x) for x in tree_flatten(t)] for t in trees]
    n = {len(f) for f in flat}
    if len(n) != 1:
        raise ValueError(f"trees of different sizes: {[len(f) for f in flat]}")
    return zip(*flat)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        st = {"step": _step0(params)}
        if momentum:
            st["mu"] = _zeros_like(params)
        return st

    @torch.no_grad()
    def update(params, grads, state):
        if momentum:
            for p, g, mu in _leaves(params, grads, state["mu"]):
                mu.copy_(momentum * mu + g)
                p.sub_(lr * mu)
        else:
            for p, g in _leaves(params, grads):
                p.sub_(lr * g)
        state["step"].add_(1)
        return params, state

    def state_specs(param_specs):
        st = {"step": P()}
        if momentum:
            st["mu"] = param_specs
        return st

    return Optimizer(init, update, state_specs)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float | None = 1.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros_like(params),
                "v": _zeros_like(params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"].add_(1)
        scale = None
        if grad_clip is not None:
            gsq = sum(_sq_sum(g) for g in tree_flatten(grads))
            gnorm = torch.sqrt(torch.as_tensor(gsq, dtype=torch.float32,
                                               device=step.device))
            scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9),
                                max=1.0)
        t = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        for p, g, m, v in _leaves(params, grads, state["m"], state["v"]):
            if scale is not None:
                g = g * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            mhat = m / bc1
            vhat = v / bc2
            p.copy_(p - lr * (mhat / (torch.sqrt(vhat) + eps)
                              + weight_decay * p))
        return params, state

    def state_specs(param_specs):
        return {"step": P(), "m": param_specs, "v": param_specs}

    return Optimizer(init, update, state_specs)


def adagrad(lr: float = 1e-2, eps: float = 1e-8) -> Optimizer:
    """MLPerf-DLRM's embedding optimizer: one accumulator per param."""
    def init(params):
        return {"step": _step0(params), "acc": _zeros_like(params)}

    @torch.no_grad()
    def update(params, grads, state):
        for p, g, a in _leaves(params, grads, state["acc"]):
            a.add_(torch.square(g))
            p.copy_(p - lr * g / (torch.sqrt(a) + eps))
        state["step"].add_(1)
        return params, state

    def state_specs(param_specs):
        return {"step": P(), "acc": param_specs}

    return Optimizer(init, update, state_specs)


def get_optimizer(name: str, lr: float | None = None) -> Optimizer:
    if name == "adamw":
        return adamw(lr or 3e-4)
    if name == "adagrad":
        return adagrad(lr or 1e-2)
    if name == "sgd":
        return sgd(lr or 1e-2)
    raise ValueError(f"unknown optimizer {name!r}")
