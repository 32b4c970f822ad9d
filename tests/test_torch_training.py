"""The port's training infrastructure (``repro_torch.training.{optimizer,
compression,train_loop}``, ``distributed.fault_tolerance.RecoveryPolicy``)
against the JAX reference on the CPU.

Optimizers: the same numpy-seeded parameter tree and gradients through
three updates of each package's optimizer, the state carried across by
``repro_torch.state.opt_state_from_reference``; tolerance 1e-6 (the
updates' elementwise f32 arithmetic is the reference's; the global norm
of AdamW's clip and its f32 ``pow`` round differently in the last bits).
Compression: bitwise.  The train loop: the reference's
``tests/test_training_infra.py`` cases on the port, and a training
checkpoint written by either package and resumed by the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.distributed import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import obs
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                     RecoveryPolicy)
from repro_torch.distributed.sharding import P
from repro_torch.state import opt_state_from_reference, opt_state_to_numpy
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import (TrainLoopConfig,
                                             make_train_step, run)

TOL = 1e-6


def _tree(rng, scale=1.0):
    """A nested tree (dicts and a list) of f32 arrays."""
    return {"w": (rng.normal(0, 1, (5, 3)) * scale).astype(np.float32),
            "layers": [{"b": (rng.normal(0, 1, (3,)) * scale
                              ).astype(np.float32)},
                       {"b": (rng.normal(0, 1, (4,)) * scale
                              ).astype(np.float32)}],
            "a": {"s": (rng.normal(0, 1, ()) * scale).astype(np.float32)}}


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def _assert_trees(name, got, want, atol):
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        assert_parity(f"{name}[{i}]", g, np.asarray(w), atol=atol)


@pytest.mark.parametrize("name,make", [
    ("sgd", lambda m: m.sgd(lr=0.1)),
    ("sgd_momentum", lambda m: m.sgd(lr=0.1, momentum=0.9)),
    ("adamw_clip", lambda m: m.adamw(lr=1e-2)),
    ("adamw_noclip", lambda m: m.adamw(lr=1e-2, grad_clip=None)),
    ("adagrad", lambda m: m.adagrad(lr=0.5)),
])
def test_optimizer_updates_match_reference(name, make):
    """Three updates from one state; AdamW's gradients have a global norm
    far above its clip of 1.0, so the clip is active."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=30.0) for _ in range(3)]
    jo, to = make(jopt), make(topt)
    jp, js = params, jo.init(params)
    tp = _torch(params)
    ts = opt_state_from_reference(jax.tree_util.tree_map(np.asarray, js),
                                  device="cpu")
    assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
    for g in grads:
        jp, js = jo.update(jp, g, js)
        tp, ts = to.update(tp, _torch(g), ts)
    _assert_trees(f"opt.{name}.params", tp, jp, TOL)
    _assert_trees(f"opt.{name}.state", opt_state_to_numpy(ts), js, TOL)
    assert int(ts["step"]) == 3
    if name == "adamw_clip":
        gnorm = np.sqrt(sum(np.sum(np.square(x))
                            for x in jax.tree_util.tree_leaves(grads[0])))
        assert gnorm > 10.0


def test_optimizer_init_state_specs_and_names():
    params = _torch(_tree(np.random.default_rng(1)))
    for name in ("sgd", "adamw", "adagrad"):
        opt = topt.get_optimizer(name)
        want = jopt.get_optimizer(name).init(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params))
        got = opt.init(params)
        assert set(got) == set(want)
        _assert_trees(f"opt.{name}.init", opt_state_to_numpy(got), want, 0.0)
    pspecs = {"a": P("data", None), "b": {"c": P(None)}}
    sspecs = topt.adamw().state_specs(pspecs)
    assert sspecs["m"] == pspecs and sspecs["v"] == pspecs
    assert sspecs["step"] == P()
    assert topt.adagrad().state_specs(pspecs) == {"step": P(),
                                                  "acc": pspecs}
    assert topt.sgd(momentum=0.9).state_specs(pspecs)["mu"] == pspecs
    with pytest.raises(ValueError):
        topt.get_optimizer("lion")


@pytest.mark.parametrize("opt_name", ["sgd", "adamw", "adagrad"])
def test_optimizer_converges_quadratic(opt_name):
    """The reference's test on the port."""
    opt = topt.get_optimizer(opt_name,
                             lr=1.0 if opt_name == "adagrad" else 0.1)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(params, grads, state)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.15)


def test_compress_decompress_bitwise():
    rng = np.random.default_rng(0)
    grads = {"w": rng.normal(0, 1, (64,)).astype(np.float32),
             "z": np.zeros((3, 2), np.float32),
             "l": [rng.normal(0, 1e-3, (17,)).astype(np.float32)]}
    jr = jcomp.init_compression(grads)
    tr = tcomp.init_compression(_torch(grads))
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: x * (i + 1), grads)
        jg, jr = jcomp.compress_decompress(g, jr)
        tg, tr = tcomp.compress_decompress(_torch(g), tr)
        _assert_trees(f"compress.{i}.grads", tg, jg, 0.0)
        _assert_trees(f"compress.{i}.residual", tr, jr, 0.0)


def test_compressed_psum_on_two_gloo_ranks(tmp_path):
    """Two gloo ranks against the reference's ``compressed_psum`` under
    ``vmap`` with a named axis (its psum / pmax over two rows)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 33)).astype(np.float32)
    x[1] *= 4.0
    out = td.launch("compressed_psum", 2, tmp_path, {"x": x})
    want = jax.vmap(lambda r: jcomp.compressed_psum(r, "i"),
                    axis_name="i")(jnp.asarray(x))
    want16 = jax.vmap(lambda r: jcomp.compressed_psum(r, "i"),
                      axis_name="i")(jnp.asarray(x, jnp.bfloat16))
    for rank in range(2):
        assert_parity(f"compressed_psum.f32.r{rank}", out[rank]["f32"],
                      np.asarray(want[rank]), 0.0)
        assert_parity(f"compressed_psum.bf16.r{rank}", out[rank]["bf16"],
                      np.asarray(want16[rank].astype(jnp.float32)), 0.0)


# -- the train loop: the reference's tests/test_training_infra.py cases -----

def _toy_problem():
    target = torch.tensor([0.5, -1.5])
    opt = topt.sgd(lr=0.2)

    def loss_fn(params, batch):
        return torch.sum((params["w"] - target) ** 2) + 0.0 * batch["x"].sum()

    step = make_train_step(loss_fn, opt)
    params = {"w": torch.zeros(2)}
    return step, params, opt.init(params), (
        lambda i: {"x": torch.ones(2) * i})


def test_train_loop_runs_and_converges(tmp_path):
    step, params, state, batches = _toy_problem()
    res = run(step, params, state, batches,
              TrainLoopConfig(total_steps=50, checkpoint_every=10,
                              checkpoint_dir=str(tmp_path)))
    assert res.final_step == 50
    assert res.losses[-1] < res.losses[0] * 0.01


def test_train_loop_recovers_from_injected_fault(tmp_path):
    obs.reset_metrics()
    obs.clear()
    step, params, state, batches = _toy_problem()
    inj = FaultInjector(fail_at_steps=(17, 23))
    res = run(step, params, state, batches,
              TrainLoopConfig(total_steps=40, checkpoint_every=5,
                              checkpoint_dir=str(tmp_path)),
              injector=inj)
    assert res.final_step == 40
    assert len(inj.fired) == 2                # both faults triggered
    assert res.restarts == 2
    assert res.losses[-1] < 1e-3              # still converged
    reg = obs.registry()
    assert reg.counter("train.failures").value == 2
    assert reg.counter("train.recoveries").value == 2
    assert reg.gauge("train.last_failure_step").value == 23
    spans = [s for s in obs.get_spans() if s.name == "train.recover"]
    assert [s.attrs["restore_step"] for s in spans] == [15, 20]


def test_train_loop_resumes_from_checkpoint(tmp_path):
    step, params, state, batches = _toy_problem()
    run(step, params, state, batches,
        TrainLoopConfig(total_steps=20, checkpoint_every=5,
                        checkpoint_dir=str(tmp_path)))
    assert tckpt.latest_step(tmp_path) == 20
    seen = []
    run(step, params, state, batches,
        TrainLoopConfig(total_steps=30, checkpoint_every=5,
                        checkpoint_dir=str(tmp_path)),
        on_step=lambda s, l: seen.append(s))
    assert seen[0] == 20 and seen[-1] == 29


def test_train_loop_raises_without_a_checkpoint():
    step, params, state, batches = _toy_problem()
    with pytest.raises(Exception, match="injected"):
        run(step, params, state, batches, TrainLoopConfig(total_steps=5),
            injector=FaultInjector(fail_at_steps=(2,)))


def test_compression_error_feedback_converges():
    target = torch.from_numpy(np.linspace(-2, 2, 16).astype(np.float32))
    opt = topt.sgd(lr=0.05)

    def loss_fn(params, batch):
        return torch.sum((params["w"] - target) ** 2)

    params = {"w": torch.zeros(16)}
    state = {"opt": opt.init(params), "ef": tcomp.init_compression(params)}
    step = make_train_step(loss_fn, opt, compression=True)
    for _ in range(200):
        params, state, loss = step(params, state, {})
    np.testing.assert_allclose(params["w"].detach().numpy(),
                               target.numpy(), atol=0.05)


# -- a training checkpoint across the packages --------------------------------

def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    target = rng.normal(0, 1, (2, 3)).astype(np.float32)
    params = {"w": np.zeros((2, 3), np.float32),
              "b": [np.zeros((3,), np.float32)]}
    return target, params


def _jax_run(tmp, steps, target, params):
    opt = jopt.adamw(lr=0.05)

    def loss_fn(p, batch):
        return jnp.sum((p["w"] * batch["x"] + p["b"][0] - target) ** 2)

    step = jax.jit(jloop.make_train_step(loss_fn, opt))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jloop.run(step, params, opt.init(params),
                     lambda i: {"x": jnp.full((2, 3), 1.0 + 0.1 * i)},
                     jloop.TrainLoopConfig(total_steps=steps,
                                           checkpoint_every=5,
                                           checkpoint_dir=str(tmp)))


def _torch_run(tmp, steps, target, params):
    opt = topt.adamw(lr=0.05)
    t = torch.from_numpy(target)

    def loss_fn(p, batch):
        return torch.sum((p["w"] * batch["x"] + p["b"][0] - t) ** 2)

    params = _torch(params)
    return run(make_train_step(loss_fn, opt), params, opt.init(params),
               lambda i: {"x": torch.full((2, 3), 1.0 + 0.1 * i)},
               TrainLoopConfig(total_steps=steps, checkpoint_every=5,
                               checkpoint_dir=str(tmp)))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_training_checkpoint_crosses_packages(tmp_path, first):
    """10 steps by one package, then the other resumes from its
    checkpoint to step 20; the result equals 20 steps by the reference
    (1e-6) and the final checkpoints hold the same tree."""
    target, params = _quadratic()
    runs = {"jax": _jax_run, "torch": _torch_run}
    second = "torch" if first == "jax" else "jax"
    runs[first](tmp_path / "x", 10, target, params)
    res = runs[second](tmp_path / "x", 20, target, params)
    want = _jax_run(tmp_path / "ref", 20, target, params)
    assert res.final_step == 20 and len(res.losses) == 10
    _assert_trees(f"ckpt.{first}_then_{second}.params",
                  jax.tree_util.tree_map(
                      lambda x: np.array(x.detach() if isinstance(
                          x, torch.Tensor) else x), res.params),
                  want.params, TOL)
    like = {"params": want.params, "opt": want.opt_state}
    got = jckpt.restore(tmp_path / "x", 20, like)
    ref = jckpt.restore(tmp_path / "ref", 20, like)
    _assert_trees("ckpt.final", got, ref, TOL)


# -- RecoveryPolicy: the reference's tests/test_fault_tolerance.py cases ------

def test_policy_probe_is_pure():
    p = RecoveryPolicy(max_restarts=2)
    assert p.can_restart and p.can_restart
    assert p.restarts == 0 and p.failures == 0
    assert p.on_restore is None


def test_policy_failures_and_restarts_count_independently():
    p = RecoveryPolicy(max_restarts=1)
    p.record_failure()
    p.record_failure()
    assert p.failures == 2 and p.restarts == 0
    assert p.can_restart
    p.record_restart()
    assert p.restarts == 1 and not p.can_restart


def test_policy_backoff_is_bounded_exponential():
    p = RecoveryPolicy(backoff_base_s=0.01, backoff_factor=2.0,
                       backoff_max_s=0.05)
    assert p.backoff_s(0) == pytest.approx(0.01)
    assert p.backoff_s(1) == pytest.approx(0.02)
    assert p.backoff_s(2) == pytest.approx(0.04)
    assert p.backoff_s(3) == pytest.approx(0.05)
    assert p.backoff_s(50) == pytest.approx(0.05)
    assert p.backoff_s(-1) == pytest.approx(0.01)


def test_legacy_should_restart_keeps_old_semantics():
    from repro.distributed.fault_tolerance import RecoveryPolicy as JPolicy
    p, q = RecoveryPolicy(max_restarts=2), JPolicy(max_restarts=2)
    got = [p.should_restart() for _ in range(3)]
    assert got == [q.should_restart() for _ in range(3)] == [True, True,
                                                              False]
    assert (p.failures, p.restarts) == (q.failures, q.restarts) == (3, 2)
    def hook(step):
        return step

    assert RecoveryPolicy(3, hook).on_restore is hook
    assert JPolicy(3, hook).on_restore is hook
