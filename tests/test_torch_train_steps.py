"""The port's train steps (``repro_torch.models.common.
chunked_softmax_xent``, ``models.transformer.{loss_fn,backward}``, the
recsys ``loss_fn``s and ``launch.steps.build_step``'s train steps)
against the JAX reference on the CPU.

The reference's ``init_params`` trees (biases and norm scales moved off
0 / 1 by seeded numpy noise) are carried into the port; losses and
per-leaf gradients are compared with ``jax.value_and_grad`` of the
reference's ``loss_fn``.  Tolerances: f32 compute 1e-5 relative to each
tensor's largest magnitude (the packages' matmuls, exp and rsqrt round
differently in the last bits); bf16 compute (the LM's ``dtype``) 2e-2
relative per leaf, ‖Δg‖ / ‖g‖ (every bf16 product rounds to 2⁻⁸, and
the two packages round at different places).
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
from repro.compat import make_mesh
from repro.launch import steps as jsteps
from repro.models import common as jcm
from repro.models import transformer as jtx
from repro.training import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.data import batches as tbatches
from repro_torch.launch.steps import build_step
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttx
from repro_torch.state import (opt_state_from_reference,
                               recsys_from_reference,
                               transformer_from_reference)
from repro_torch.training.train_loop import take_grads, trainable

TOL = 1e-5


def _rel_close(name, got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert_parity(name, got, want, atol=rtol * scale)


def _rel_norm(name, got, want, rtol):
    g = got.detach().double().numpy()
    w = np.asarray(want, dtype=np.float64)
    err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    print(f"PARITY {name} rel_norm={err!r} rtol={rtol!r}")
    assert err <= rtol, (name, err)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        last = str(path[-1])
        x = np.asarray(x)
        if any(k in last for k in ("'b'", "'scale'", "'bias'", "'w0'")):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, params)


def _grads_close(prefix, tree, jgrads, check):
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_t = jax.tree_util.tree_leaves(tree)
    assert len(flat_j) == len(flat_t)
    for (path, g), leaf in zip(flat_j, flat_t):
        assert leaf.grad is not None, jax.tree_util.keystr(path)
        check(f"{prefix}{jax.tree_util.keystr(path)}", leaf.grad, g)


# -- the chunked cross-entropy ------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_softmax_xent_matches_reference(chunk):
    """Labels −1 ignored (a whole row of them included); value and the
    gradients of h and w_out."""
    rng = np.random.default_rng(chunk)
    h = rng.normal(0, 1, (3, 16, 8)).astype(np.float32)
    w = rng.normal(0, 0.3, (8, 37)).astype(np.float32)
    lab = rng.integers(0, 37, (3, 16)).astype(np.int32)
    lab[rng.random((3, 16)) < 0.3] = -1
    lab[2] = -1
    want, (jh, jw) = jax.value_and_grad(
        lambda a, b: jcm.chunked_softmax_xent(a, b, jnp.asarray(lab),
                                              chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tcm.chunked_softmax_xent(th, tw, torch.from_numpy(lab),
                                   chunk=chunk)
    got.backward()
    assert_parity(f"xent.c{chunk}.loss", got.detach(), want, atol=TOL)
    assert_parity(f"xent.c{chunk}.dh", th.grad, jh, atol=TOL)
    assert_parity(f"xent.c{chunk}.dw", tw.grad, jw, atol=TOL)
    with torch.no_grad():
        assert float(tcm.chunked_softmax_xent(
            th, tw, torch.full((3, 16), -1), chunk=chunk)) == 0.0
    with pytest.raises(ValueError, match="must divide"):
        tcm.chunked_softmax_xent(th, tw, torch.from_numpy(lab), chunk=5)


# -- the LM's loss and gradients ------------------------------------------------

def _lm_pair(dtype, remat, microbatch, seed=3):
    jcfg = dataclasses.replace(
        importlib.import_module("repro.configs.llama3_2_1b").smoke_config(),
        dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16,
        remat=remat, microbatch=microbatch)
    tcfg = dataclasses.replace(get_arch("llama3_2_1b").smoke_config(),
                               dtype=dtype, remat=remat,
                               microbatch=microbatch)
    params = _perturbed(jtx.init_params(jcfg, jax.random.PRNGKey(seed)),
                        seed)
    return jcfg, tcfg, params


def _jax_lm_value_and_grad(jcfg, params, batch):
    """The reference's loss and mean gradient over ``microbatch``
    µbatches (its ``steps.py:77-101`` accumulation)."""
    mb = jcfg.microbatch
    toks = batch["tokens"].reshape(mb, -1, batch["tokens"].shape[1])
    labs = batch["labels"].reshape(mb, -1, batch["labels"].shape[1])
    vg = jax.jit(jax.value_and_grad(lambda p, t, l: jtx.loss_fn(
        jcfg, p, {"tokens": t, "labels": l})))
    gacc, ltot = None, jnp.float32(0.0)
    for t, l in zip(toks, labs):
        loss, g = vg(params, jnp.asarray(t), jnp.asarray(l))
        gacc = g if gacc is None else jax.tree_util.tree_map(jnp.add, gacc, g)
        ltot = ltot + loss
    return ltot / mb, jax.tree_util.tree_map(lambda x: x / mb, gacc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat,microbatch", [(False, 1), (True, 1),
                                              (True, 2)])
def test_lm_loss_and_gradients_match_reference(dtype, remat, microbatch):
    jcfg, tcfg, params = _lm_pair(dtype, remat, microbatch)
    batch = tbatches.lm_batch(4, 16, tcfg.vocab, seed=2)
    batch["labels"][1, ::3] = -1
    want, jgrads = _jax_lm_value_and_grad(jcfg, params, batch)
    model = transformer_from_reference(tcfg, params, device="cpu")
    tree = trainable(model.tree())
    got = ttx.backward(tcfg, tree, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    name = f"lm.{str(dtype)[6:]}.remat{int(remat)}.mb{microbatch}"
    if dtype == torch.float32:
        _rel_close(f"{name}.loss", got, want, TOL)
        _grads_close(f"{name}.grad", tree, jgrads,
                     lambda n, g, w: _rel_close(n, g, w, TOL))
    else:
        _rel_close(f"{name}.loss", got, want, 1e-2)
        _grads_close(f"{name}.grad", tree, jgrads,
                     lambda n, g, w: _rel_norm(n, g, w, 2e-2))


def test_lm_kernel_route_and_plain_route_agree_on_cpu():
    """``use_kernel=True`` (the autograd Function with the plain backward
    on the CPU) and ``use_kernel=False`` (autograd of the plain forward)
    give the same loss and gradients."""
    jcfg, tcfg, params = _lm_pair(torch.float32, True, 1)
    batch = {k: torch.from_numpy(v) for k, v in
             tbatches.lm_batch(2, 16, tcfg.vocab, seed=5).items()}
    out = []
    for use_kernel in (True, False):
        model = transformer_from_reference(tcfg, params, device="cpu",
                                           use_kernel=use_kernel)
        tree = trainable(model.tree())
        loss = ttx.backward(tcfg, tree, batch, use_kernel=use_kernel)
        out.append((loss, take_grads(tree)))
    assert_parity("lm.kernel_vs_plain.loss", out[0][0], out[1][0], atol=TOL)
    for a, b in zip(jax.tree_util.tree_leaves(out[0][1]),
                    jax.tree_util.tree_leaves(out[1][1])):
        _rel_close("lm.kernel_vs_plain.grad", a, b.numpy(), TOL)


# -- the recsys losses and gradients --------------------------------------------

RECSYS = ["dlrm_mlperf", "fm", "xdeepfm", "bert4rec"]


def _recsys_pair(name, seed=0):
    jarch = importlib.import_module(f"repro.configs.{name}").ARCH
    jmodel = importlib.import_module(f"repro.models.{jarch.model}")
    jcfg = jarch.smoke_config()
    params = _perturbed(jmodel.init_params(jcfg, jax.random.PRNGKey(seed)),
                        seed)
    model = recsys_from_reference(get_arch(name).smoke_config(), params,
                                  device="cpu")
    return jarch, jmodel, jcfg, params, model


def _recsys_batch(cfg, name, b, seed):
    if name == "bert4rec":
        return tbatches.bert4rec_batch(b, cfg.seq_len, cfg.n_items,
                                       cfg.mask_token, seed=seed)
    return tbatches.recsys_batch(b, cfg.field_sizes,
                                 getattr(cfg, "n_dense", 0), seed=seed)


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_loss_and_gradients_match_reference(name):
    _, jmodel, jcfg, params, model = _recsys_pair(name)
    batch = _recsys_batch(jcfg, name, 16, seed=4)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(jcfg, p, b)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tree = trainable(model.tree())
    loss = model.loss(batch)
    loss.backward()
    _rel_close(f"{name}.loss", loss.detach(), want, TOL)
    _grads_close(f"{name}.grad", tree, jgrads,
                 lambda n, g, w: _rel_close(n, g, w, TOL))


# -- one build_step train step against the reference's ------------------------

def _reference_step(jarch, cell):
    """The reference's step on a one-device (pod, data, model) mesh,
    jitted with that mesh set."""
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    plan = jsteps.build_step(jarch, cell, mesh)
    fn = jax.jit(plan.fn)

    def run(*args):
        with jax.set_mesh(mesh):
            return fn(*args)
    return run


def _adam_noise_leaves(jstate):
    """Leaves whose AdamW first moment is below 1e-7 everywhere: their
    gradient is zero analytically (BERT4Rec's key biases, by softmax's
    shift invariance) and holds only rounding noise, which Adam's
    normalised step turns into up to ±lr a step in either package."""
    return [float(np.abs(np.asarray(m)).max()) < 1e-7
            for m in jax.tree_util.tree_leaves(jstate["m"])]


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_train_step_matches_reference(name):
    """Two steps of ``build_step(train_batch).fn`` (Adagrad / AdamW) from
    one state: parameters and optimizer state within 1e-5."""
    jarch, _, jcfg, params, model = _recsys_pair(name)
    jarch = dataclasses.replace(jarch, config=jcfg)
    arch = dataclasses.replace(get_arch(name), config=model.cfg)
    cell = dataclasses.replace(arch.cell("train_batch"), dims={"batch": 16})
    jstep = _reference_step(jarch, cell)
    plan = build_step(arch, cell)
    jstate = jax.tree_util.tree_map(
        np.asarray, jopt.get_optimizer(jarch.optimizer).init(params))
    state = opt_state_from_reference(jstate, device="cpu")
    jp = params
    for i in range(2):
        batch = _recsys_batch(jcfg, name, 16, seed=10 + i)
        jp, jstate, _ = jstep(jp, jstate, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
        model, state, _ = plan.fn(model, state, batch)
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(model.tree())
    noise = _adam_noise_leaves(jstate) if "m" in jstate \
        else [False] * len(flat_j)
    lr = 3e-4
    for i, (g, w, z) in enumerate(zip(flat_t, flat_j, noise)):
        _rel_close(f"{name}.train_step.param{i}", g, w,
                   2 * 2 * lr if z else TOL)
    assert int(state["step"]) == 2


def test_lm_train_step_matches_reference():
    """``build_step(train_4k)`` on the smoke config (f32, remat, 2
    µbatches): one AdamW step's parameters within 1e-5, the serving copy
    refreshed (prefill after the step == prefill of a model built from
    the updated parameters)."""
    jcfg, tcfg, params = _lm_pair(torch.float32, True, 2)
    jarch = dataclasses.replace(
        importlib.import_module("repro.configs.llama3_2_1b").ARCH,
        config=jcfg)
    arch = dataclasses.replace(get_arch("llama3_2_1b"), config=tcfg)
    cell = dataclasses.replace(arch.cell("train_4k"),
                               dims={"batch": 4, "seq": 16})
    jstep = _reference_step(jarch, cell)
    plan = build_step(arch, cell)
    model = transformer_from_reference(tcfg, params, device="cpu")
    jstate = jopt.get_optimizer("adamw").init(params)
    state = plan.optimizer.init(model.tree())
    batch = tbatches.lm_batch(4, 16, tcfg.vocab, seed=8)
    jp, jstate, jloss = jstep(params, jstate, {
        k: jnp.asarray(v) for k, v in batch.items()})
    model, state, loss = plan.fn(model, state, batch)
    _rel_close("lm.train_step.loss", loss, jloss, TOL)
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(model.tree())
    assert len(flat_j) == len(flat_t)
    for i, (g, w) in enumerate(zip(flat_t, flat_j)):
        _rel_close(f"lm.train_step.param{i}", g, w, TOL)
    fresh = transformer_from_reference(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = batch["tokens"][:2]
    assert_parity("lm.train_step.refresh", model.prefill(toks)[0],
                  fresh.prefill(toks)[0], atol=TOL)
