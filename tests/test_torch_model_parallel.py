"""Port parity: the model-parallel train step (``make_ctx``, the models'
``param_specs``, the LM's tensor-, FSDP- and expert-parallel forward and
backward, the differentiable embedding exchange, ``build_step`` on a
mesh) on 4 gloo ranks, against the JAX reference.

The port's ranks run in one launch a family (``tests/_torch_dist.py``:
``lm_mesh``, ``recsys_mesh``); the reference's meshed runs in one
subprocess a family on 4 fake XLA devices, as
``tests/test_torch_sharded_embedding.py`` runs its mesh.  Everything is
f32 (TF32 off, as the port pins it).

* Spec trees: every ported config's ``param_specs``, ``table_specs``,
  ``cache_specs`` and ``make_ctx``'s fields on ("data", "model") and
  ("pod", "data", "model") meshes equal the reference's.
* The LM smoke configs (remat, 2 µbatches, labels with −1) at (data 2,
  model 2) and (data 1, model 4), FSDP gathered once a forward and at
  use: Llama-3.2-1B (GQA with kv heads whole: one kv head a rank at
  model 2, one shared by two ranks at model 4) and the MoE configs at
  capacity factor 100 against the reference's ``loss_fn`` under
  ``NO_SHARDING``; the MoE configs at their own capacity factor (tokens
  dropped per rank) against the reference's sharded branch.  Loss within
  1e-5 relative, each leaf's ‖Δg‖ / ‖g‖ ≤ 1e-5; every ``model`` rank of
  a ``data`` group routes its tokens to the same experts, and at factor
  100 the routing is the reference's.
* The exchange's gradient on a skewed batch (lookups dropped) against
  the reference's ``jax.grad`` at 1e-5 (the reference's own atol).
* DLRM, FM, xDeepFM, BERT4Rec: two ``build_step`` train steps on a
  one-axis and a (2, 2) mesh against the reference's plan jitted with its
  shardings; serve and retrieval on the mesh within 1e-6 of ``mesh=None``.
* One LM ``build_step`` train plan on a mesh against the reference's
  (two AdamW steps); the prefill and decode plans on that mesh build,
  and the trained meshed model prefills (``tests/test_torch_mesh_serving.
  py`` holds serving on a mesh to the reference).
"""

import dataclasses
import functools
import importlib
import pickle
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from _torch_parity import assert_parity
from repro.models import common as jcm
from repro.models import embedding as jemb
from repro.models import transformer as jtx
from repro_torch.configs import get_arch
from repro_torch.data import batches as tbatches
from repro_torch.launch.steps import build_step
from repro_torch.models import embedding as temb
from repro_torch.models import transformer as ttx
from repro_torch.state import (recsys_from_reference,
                               transformer_from_reference)

WORLD = 4
TOL = 1e-5
LM = ("llama3_2_1b", "qwen3_moe_30b_a3b", "deepseek_v2_236b")
MOE = LM[1:]
RECSYS = ("dlrm_mlperf", "fm", "xdeepfm", "bert4rec")
LM_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
             ((2, 1, 2), ("pod", "data", "model"))]
RS_MESHES = [((4,), ("data",)), ((2, 2), ("data", "model"))]


def _perturbed(params, seed):
    """The reference's init with biases, norm scales and ``w0`` moved off
    0 / 1 by seeded noise, as numpy."""
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if any(k in str(path[-1]) for k in ("'b'", "'scale'", "'bias'",
                                            "'w0'")):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(jitter, params)


def _start_reference(code: str) -> subprocess.Popen:
    """The reference's meshed run, started in a subprocess on 4 fake XLA
    devices (it runs while the port's ranks do)."""
    return td.start_reference(code, WORLD)


def _finish_reference(proc: subprocess.Popen, tmp: Path):
    return td.finish_reference(proc, tmp / "out.pkl")


def _rel_norm(name, got, want, rtol=TOL):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    print(f"PARITY {name} rel_norm={err!r} rtol={rtol!r}")
    assert err <= rtol, (name, err)


def _rel_loss(name, got, want, rtol=TOL):
    err = abs(float(got) - float(want)) / abs(float(want))
    print(f"PARITY {name} rel={err!r} rtol={rtol!r}")
    assert err <= rtol, (name, got, want)


# -- the LM -------------------------------------------------------------------

def _lm_cfgs(name, cf):
    jcfg = importlib.import_module(f"repro.configs.{name}").smoke_config()
    tcfg = get_arch(name).smoke_config()
    over = {"remat": True, "microbatch": 2}
    out = []
    for cfg in (jcfg, tcfg):
        if cfg.moe is not None and cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(dataclasses.replace(cfg, **over))
    return out


def _lm_batch():
    batch = tbatches.lm_batch(4, 16, 512, seed=2)
    batch["labels"][1, ::3] = -1
    return batch


def _jax_value_and_grad(jcfg, params, batch, sc=jcm.NO_SHARDING):
    """The reference's loss and mean gradient over ``microbatch`` µbatches
    (its ``steps.py:77-101`` accumulation)."""
    mb = jcfg.microbatch
    toks = batch["tokens"].reshape(mb, -1, batch["tokens"].shape[1])
    labs = batch["labels"].reshape(mb, -1, batch["labels"].shape[1])
    vg = jax.jit(jax.value_and_grad(lambda p, t, l: jtx.loss_fn(
        jcfg, p, {"tokens": t, "labels": l}, sc)))
    gacc, ltot = None, 0.0
    for t, lab in zip(toks, labs):
        loss, g = vg(params, jnp.asarray(t), jnp.asarray(lab))
        gacc = g if gacc is None else jax.tree_util.tree_map(jnp.add, gacc, g)
        ltot = ltot + loss
    return float(ltot / mb), [np.asarray(x) / mb for x in
                              jax.tree_util.tree_leaves(gacc)]


@functools.partial(jax.jit, static_argnums=0)
def _jax_routing(jcfg, params, tokens):
    """The reference's expert ids (T, K) of each MoE layer, unsharded:
    its layers run one by one and each MoE layer's router re-run on the
    layer's FFN input."""
    b, s = tokens.shape
    x = jnp.take(params["embed"].astype(jcfg.dtype), tokens, axis=0)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    attn = jtx._mla_attention if jcfg.mla is not None else jtx._gqa_attention
    ids = []
    for kind, field in (("dense", "dense_layers"), ("moe", "moe_layers")):
        if field not in params:
            continue
        n = params[field]["ln1"]["scale"].shape[0]
        for i in range(n):
            p = jax.tree_util.tree_map(lambda t: t[i], params[field])
            if kind == "moe":
                h, _ = attn(jcfg, p["attn"], jcm.rmsnorm(p["ln1"], x),
                            jcm.NO_SHARDING, pos)
                f_in = jcm.rmsnorm(p["ln2"], x + h).reshape(b * s, -1)
                probs = jax.nn.softmax(f_in @ p["ffn"]["router"]["w"], -1)
                ids.append(jax.lax.top_k(probs, jcfg.moe.top_k)[1])
            x, _ = jtx._layer_fwd(jcfg, kind, p, x, jcm.NO_SHARDING, pos)
    return ids


def _lm_cases():
    """(config, mesh, gather at use, capacity factor) → the rank task's
    case; the parameter trees by config name."""
    params, cases = {}, {}
    for name in LM:
        jcfg, _ = _lm_cfgs(name, None)
        params[name] = _perturbed(jtx.init_params(
            jcfg, jax.random.PRNGKey(3)), 3)
        for cf in ((None,) if name == "llama3_2_1b" else (100.0, None)):
            for shape in ((2, 2), (1, 4)):
                for gather in (False, True):
                    tcfg = dataclasses.replace(_lm_cfgs(name, cf)[1],
                                               gather_weights_at_use=gather)
                    cases[(name, cf, shape, gather)] = {
                        "cfg": tcfg, "mesh": shape, "params": name}
    for name, cf in (("llama3_2_1b", None), ("qwen3_moe_30b_a3b", 100.0)):
        cases[(name, cf, (2, 1, 2), False)] = {
            "cfg": _lm_cfgs(name, cf)[1], "mesh": (2, 1, 2), "params": name}
    return params, cases


def _lm_steps(params, batches):
    tcfg = _lm_cfgs("llama3_2_1b", None)[1]
    return {"llama_step": {"arch": "llama3_2_1b", "cfg": tcfg,
                           "mesh": (2, 2), "params": "llama3_2_1b",
                           "batches": batches}}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    params, cases = _lm_cases()
    batch = _lm_batch()
    step_batches = [tbatches.lm_batch(4, 16, 512, seed=8 + i)
                    for i in range(2)]
    tmp = tmp_path_factory.mktemp("lm_mp_ref")
    np.savez(tmp / "in.npz", **{k: v for k, v in batch.items()},
             **{f"s{i}_{k}": v for i, b in enumerate(step_batches)
                for k, v in b.items()})
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    proc = _start_reference(f"""
        import dataclasses, importlib, pickle
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.distributed.sharding import make_ctx
        from repro.launch import steps as jsteps
        from repro.models import transformer as tx
        from repro.training.optimizer import get_optimizer
        assert len(jax.devices()) == {WORLD}
        d = np.load({str(tmp / "in.npz")!r})
        params = pickle.load(open({str(tmp / "params.pkl")!r}, "rb"))
        out = {{}}
        for name in {MOE!r}:
            cfg = dataclasses.replace(importlib.import_module(
                f"repro.configs.{{name}}").smoke_config(), remat=True,
                microbatch=2)
            for shape in ((2, 2), (1, 4)):
                mesh = make_mesh(shape, ("data", "model"))
                sc = make_ctx(mesh)
                vg = jax.jit(jax.value_and_grad(lambda p, t, l: tx.loss_fn(
                    cfg, p, {{"tokens": t, "labels": l}}, sc)))
                toks = d["tokens"].reshape(2, 2, -1)
                labs = d["labels"].reshape(2, 2, -1)
                g, ltot = None, 0.0
                with mesh:
                    for t, l in zip(toks, labs):
                        loss, gi = vg(params[name], t, l)
                        g = gi if g is None else jax.tree_util.tree_map(
                            jnp.add, g, gi)
                        ltot = ltot + float(loss)
                leaves = [np.asarray(x) / 2 for x in
                          jax.tree_util.tree_leaves(g)]
                out[(name, shape)] = (ltot / 2, leaves)
        arch = importlib.import_module("repro.configs.llama3_2_1b").ARCH
        cfg = dataclasses.replace(arch.smoke_config(), remat=True,
                                  microbatch=2)
        arch = dataclasses.replace(arch, config=cfg)
        cell = dataclasses.replace(arch.cell("train_4k"),
                                   dims={{"batch": 4, "seq": 16}})
        mesh = make_mesh((2, 2), ("data", "model"))
        plan = jsteps.build_step(arch, cell, mesh)
        fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                     out_shardings=plan.out_shardings)
        p = params["llama3_2_1b"]
        st = get_optimizer("adamw").init(p)
        losses = []
        with mesh:
            for i in range(2):
                p, st, loss = fn(p, st, {{k: d[f"s{{i}}_{{k}}"]
                                         for k in ("tokens", "labels")}})
                losses.append(float(loss))
        out["llama_step"] = (losses, [np.asarray(x) for x in
                                      jax.tree_util.tree_leaves(p)])
        pickle.dump(out, open({str(tmp / "out.pkl")!r}, "wb"))
    """)
    try:
        out = td.launch("lm_mesh", WORLD, tmp_path_factory.mktemp("lm_mp"), {
            "meshes": LM_MESHES, "cases": cases, "params": params,
            "batch": batch, "steps": _lm_steps(params, step_batches)})
    finally:
        ref = _finish_reference(proc, tmp)
    return params, cases, batch, out, ref


def _reference_unsharded(name, cf, params, batch, memo={}):
    if (name, cf) not in memo:
        jcfg = _lm_cfgs(name, cf)[0]
        memo[(name, cf)] = _jax_value_and_grad(jcfg, params[name], batch)
    return memo[(name, cf)]


@pytest.mark.parametrize("gather", [False, True], ids=["stack", "at_use"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["d2m2", "d1m4"])
@pytest.mark.parametrize("name,cf", [("llama3_2_1b", None),
                                     ("qwen3_moe_30b_a3b", 100.0),
                                     ("deepseek_v2_236b", 100.0)])
def test_lm_sharded_loss_and_gradients_match_unsharded_reference(
        lm, name, cf, shape, gather):
    """Against the reference's ``loss_fn`` under ``NO_SHARDING`` (the MoE
    configs at capacity factor 100: no token dropped, so the sharded and
    unsharded branches compute the same function)."""
    params, _, batch, out, _ = lm
    want_loss, want = _reference_unsharded(name, cf, params, batch)
    got = out[0][(name, cf, shape, gather)]
    tag = f"mp.{name}.cf{cf}.{shape}.{'use' if gather else 'stack'}"
    for rank in range(WORLD):
        _rel_loss(f"{tag}.loss.r{rank}",
                  out[rank][(name, cf, shape, gather)]["loss"], want_loss)
    assert len(got["grads"]) == len(want)
    for i, (g, w) in enumerate(zip(got["grads"], want)):
        _rel_norm(f"{tag}.grad{i}", g, w)


@pytest.mark.parametrize("name,cf", [("llama3_2_1b", None),
                                     ("qwen3_moe_30b_a3b", 100.0)])
def test_lm_on_a_pod_mesh_matches_unsharded_reference(lm, name, cf):
    """(pod 2, data 1, model 2): the batch over ("pod", "data"), FSDP over
    a ``data`` of one rank, so every leaf's gradient is summed over
    ``pod`` leaf by leaf (``sharding.reduce_gradients``)."""
    params, _, batch, out, _ = lm
    want_loss, want = _reference_unsharded(name, cf, params, batch)
    got = out[0][(name, cf, (2, 1, 2), False)]
    _rel_loss(f"mp.{name}.pod.loss", got["loss"], want_loss)
    for i, (g, w) in enumerate(zip(got["grads"], want)):
        _rel_norm(f"mp.{name}.pod.grad{i}", g, w)


def _ids_by_data_rank(out, key, shape):
    """Each MoE call's expert ids by ``data`` rank, after checking that
    every ``model`` rank of the data group routed alike."""
    n_data, n_model = shape
    per = []
    for d in range(n_data):
        ranks = [out[d * n_model + m][key]["ids"] for m in range(n_model)]
        for r in ranks[1:]:
            assert len(r) == len(ranks[0])
            for a, b in zip(r, ranks[0]):
                np.testing.assert_array_equal(a, b)
        per.append(ranks[0])
    return per


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["d2m2", "d1m4"])
@pytest.mark.parametrize("name", MOE)
def test_moe_routing_is_the_references(lm, name, shape):
    """At factor 100 the ranks' expert ids, in each µbatch's rank order,
    are the reference's unsharded routing of the µbatch's tokens."""
    params, _, batch, out, _ = lm
    jcfg = _lm_cfgs(name, 100.0)[0]
    per = _ids_by_data_rank(out, (name, 100.0, shape, False), shape)
    n_moe = jcfg.layer_counts()[1]
    toks = batch["tokens"].reshape(2, 2, -1)
    for u in range(2):                                   # µbatches
        want = _jax_routing(jcfg, params[name], jnp.asarray(toks[u]))
        for layer in range(n_moe):
            got = np.concatenate([p[u * n_moe + layer] for p in per])
            np.testing.assert_array_equal(got, np.asarray(want[layer]))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["d2m2", "d1m4"])
@pytest.mark.parametrize("name", MOE)
def test_moe_capacity_limited_matches_reference_sharded_branch(lm, name,
                                                              shape):
    """At the configs' own capacity factor each rank drops tokens by its
    local count: the reference's sharded branch on 4 fake devices, the
    same mesh, is the comparison."""
    _, _, _, out, ref = lm
    want_loss, want = ref[(name, shape)]
    for gather in (False, True):
        got = out[0][(name, None, shape, gather)]
        tag = f"mp.{name}.own_cf.{shape}.{'use' if gather else 'stack'}"
        _rel_loss(f"{tag}.loss", got["loss"], want_loss)
        for i, (g, w) in enumerate(zip(got["grads"], want)):
            _rel_norm(f"{tag}.grad{i}", g, w)
        _ids_by_data_rank(out, (name, None, shape, gather), shape)


def test_lm_build_step_on_mesh_matches_reference_plan(lm):
    """Two AdamW steps of ``build_step(train_4k, mesh)`` on (2, 2) against
    the reference's plan jitted with its shardings: losses 1e-5
    relative, every parameter within 1e-5 of max(1, |p|)."""
    _, _, _, out, ref = lm
    got = out[0]["llama_step"]
    want_losses, want = ref["llama_step"]
    for i, (a, b) in enumerate(zip(got["losses"], want_losses)):
        _rel_loss(f"mp.llama.step{i}.loss", a, b)
    assert got["step"] == 2
    assert len(got["params"]) == len(want)
    for i, (g, w) in enumerate(zip(got["params"], want)):
        scale = max(1.0, float(np.abs(w).max()))
        assert_parity(f"mp.llama.step.param{i}", g, w, atol=TOL * scale)


def test_lm_prefill_and_decode_on_a_mesh_raise(lm):
    """Serving on a mesh is ported, so nothing raises any more (the name
    is kept from when these plans raised ``NotImplementedError``): on the
    (2, 2) mesh the ``prefill_32k`` and ``decode_32k`` plans build, with
    the reference's out-shardings (logits over the batch and ``model``,
    the cache's sequence over ``model``); and the meshed model, after its
    two train steps, prefills a row of zeros on each rank — its logits,
    the ranks' vocabulary slices put together, within 1e-4 of the
    no-mesh prefill of the reference's parameters after the same two
    steps (the trained parameters agree within 1e-5 of max(1, |p|))."""
    params, _, _, out, ref = lm
    want_specs = ("PartitionSpec(('data',), 'model')", {
        "k": "PartitionSpec(None, ('data',), None, 'model', None)",
        "v": "PartitionSpec(None, ('data',), None, 'model', None)",
        "len": "PartitionSpec(('data',),)"})
    cfg = _lm_cfgs("llama3_2_1b", None)[1]
    trained = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params["llama3_2_1b"]),
        ref["llama_step"][1])
    want = transformer_from_reference(cfg, trained, device="cpu").prefill(
        np.zeros((1, 4), np.int32))[0]
    for rank in range(WORLD):
        got = out[rank]["llama_step"]
        assert got["raised"] == {}, got["raised"]
        served = got["served"]
        assert served["prefill_32k"] == served["decode_32k"] == want_specs
        logits, shapes = served["model.prefill"]
        assert shapes == {"k": (2, 1, 2, 2, 16), "v": (2, 1, 2, 2, 16),
                          "len": (1,)}
        v_loc = cfg.vocab // 2
        assert_parity(f"mp.llama.mesh_prefill.r{rank}", logits,
                      want[:, (rank % 2) * v_loc:][:, :v_loc], atol=1e-4)


def _spec_tree(tree):
    """A spec tree as nested dicts / lists with each spec a tuple of its
    entries (a tuple of several axis names kept, of one axis the name,
    as JAX's ``PartitionSpec`` normalises it)."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]

    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in tree)


@pytest.mark.parametrize("name", LM + RECSYS)
def test_param_specs_equal_the_references(name):
    jarch = importlib.import_module(f"repro.configs.{name}").ARCH
    module = jarch.model or "transformer"
    jmod = importlib.import_module(f"repro.models.{module}")
    tmod = importlib.import_module(f"repro_torch.models.{module}")
    for jcfg, tcfg in ((jarch.config, get_arch(name).config),
                       (jarch.smoke_config(), get_arch(name).smoke_config())):
        if name in RECSYS and name != "bert4rec":
            for axes in (("pod", "data", "model"), ("data",)):
                assert _spec_tree(tmod.param_specs(tcfg, axes)) == \
                    _spec_tree(jmod.param_specs(jcfg, axes))
        else:
            assert _spec_tree(tmod.param_specs(tcfg)) == \
                _spec_tree(jmod.param_specs(jcfg))
        if name in LM:
            for axes in (("pod", "data"), ("data",)):
                assert _spec_tree(ttx.cache_specs(tcfg, axes)) == \
                    _spec_tree(jtx.cache_specs(jcfg, axes))
    for axes in (("pod", "data", "model"), ("data", "model")):
        assert _spec_tree(temb.table_specs(axes)) == \
            _spec_tree(jemb.table_specs(axes))


def test_make_ctx_fields_equal_the_references(lm):
    from repro.compat import make_mesh
    from repro.distributed.sharding import make_ctx
    _, _, _, out, _ = lm
    for shape, axes in LM_MESHES:
        jmesh = make_mesh((1,) * len(axes), axes)
        for dp in (False, True):
            j = make_ctx(jmesh, dp_over_all=dp)
            for rank in range(WORLD):
                assert out[rank][("ctx", shape, dp)] == (
                    j.batch, j.model, j.fsdp, True, True), (shape, dp)
    # ShardingCtx.constrain: a DTensor redistributed to the spec; off the
    # mesh (NO_SHARDING) or on a plain tensor, the input itself
    assert out[0]["constrain"] == (["Shard(dim=0)", "Replicate()"], True,
                                   True, True)


# -- the recsys models --------------------------------------------------------

def _rs_batch(cfg, name, b, seed):
    if name == "bert4rec":
        return tbatches.bert4rec_batch(b, cfg.seq_len, cfg.n_items,
                                       cfg.mask_token, seed=seed)
    return tbatches.recsys_batch(b, cfg.field_sizes,
                                 getattr(cfg, "n_dense", 0), seed=seed)


RS_DIMS = {"train_batch": {"batch": 16}, "serve_p99": {"batch": 16},
           "retrieval_cand": {"batch": 1, "n_candidates": 8}}
EX_LAYOUT = dict(field_sizes=(20000, 50, 9000, 3), embed_dim=16, n_shards=4,
                 bucket_slack=1.0)


def _exchange_payload(rng):
    layout = jemb.TableLayout(**EX_LAYOUT)
    sizes = EX_LAYOUT["field_sizes"]
    ids = np.stack([rng.integers(0, s, 512) for s in sizes], axis=1)
    ids[:, 0] = rng.integers(0, layout.sharded_rows // WORLD, 512)
    return {"mesh": (2, 2), "layout": EX_LAYOUT, "ids": ids.astype(np.int32),
            "sharded": rng.normal(size=(layout.sharded_rows, 16)).astype(
                np.float32),
            "replicated": rng.normal(size=(layout.replicated_rows,
                                           16)).astype(np.float32)}


@pytest.fixture(scope="module")
def recsys(tmp_path_factory):
    cases, batches = {}, {}
    for name in RECSYS:
        jarch = importlib.import_module(f"repro.configs.{name}").ARCH
        jmod = importlib.import_module(f"repro.models.{jarch.model}")
        params = _perturbed(jmod.init_params(jarch.smoke_config(),
                                             jax.random.PRNGKey(0)), 0)
        cfg = get_arch(name).smoke_config()
        serve = {k: v for k, v in _rs_batch(cfg, name, 16, 5).items()
                 if k != "labels"}
        ret = {k: v[:1] for k, v in serve.items()}
        n_cand = cfg.n_items if name == "bert4rec" \
            else cfg.field_sizes[cfg.candidate_field]
        ret["candidates"] = (np.arange(8) * 1237 % n_cand).astype(np.int32)
        batches[name] = {"train_batch": [_rs_batch(cfg, name, 16, 10 + i)
                                         for i in range(2)],
                         "serve_p99": serve, "retrieval_cand": ret}
        for shape, _ in RS_MESHES:
            cases[(name, shape)] = {"cfg": cfg, "params": params,
                                    "batches": batches[name],
                                    "dims": RS_DIMS}
    exchange = _exchange_payload(np.random.default_rng(0))
    tmp = tmp_path_factory.mktemp("rs_mp_ref")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"params": {n: cases[(n, (4,))]["params"]
                                for n in RECSYS},
                     "batches": {n: b["train_batch"]
                                 for n, b in batches.items()},
                     "exchange": exchange}, f)
    proc = _start_reference(f"""
        import dataclasses, importlib, pickle
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.launch import steps as jsteps
        from repro.models.embedding import TableLayout, sharded_lookup
        from repro.training.optimizer import get_optimizer
        assert len(jax.devices()) == {WORLD}
        d = pickle.load(open({str(tmp / "in.pkl")!r}, "rb"))
        out = {{}}
        for name in {RECSYS!r}:
            arch = importlib.import_module(f"repro.configs.{{name}}").ARCH
            arch = dataclasses.replace(arch, config=arch.smoke_config())
            cell = dataclasses.replace(arch.cell("train_batch"),
                                       dims={{"batch": 16}})
            for shape, axes in {RS_MESHES!r}:
                mesh = make_mesh(shape, axes)
                plan = jsteps.build_step(arch, cell, mesh)
                fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                             out_shardings=plan.out_shardings)
                p = d["params"][name]
                st = get_optimizer(arch.optimizer).init(p)
                losses = []
                with mesh:
                    for b in d["batches"][name]:
                        p, st, loss = fn(p, st, b)
                        losses.append(float(loss))
                m = [float(np.abs(np.asarray(x)).max()) < 1e-7 for x in
                     jax.tree_util.tree_leaves(st["m"])] if "m" in st \\
                    else None
                out[(name, shape)] = (losses, [np.asarray(x) for x in
                                               jax.tree_util.tree_leaves(p)],
                                      m)
        e = d["exchange"]
        layout = TableLayout(**e["layout"])
        mesh = make_mesh(e["mesh"], ("data", "model"))
        tables = {{"sharded": jnp.asarray(e["sharded"]),
                   "replicated": jnp.asarray(e["replicated"])}}
        ids = jnp.asarray(e["ids"])
        g = jax.grad(lambda t: jnp.sum(
            sharded_lookup(layout, t, ids, mesh) ** 2))(tables)
        out["exchange"] = {{k: np.asarray(v) for k, v in g.items()}}
        out["exchange_vals"] = np.asarray(sharded_lookup(layout, tables, ids,
                                                         mesh))
        pickle.dump(out, open({str(tmp / "out.pkl")!r}, "wb"))
    """)
    try:
        out = td.launch("recsys_mesh", WORLD,
                        tmp_path_factory.mktemp("rs_mp"),
                        {"meshes": RS_MESHES, "cases": cases,
                         "exchange": exchange})
    finally:
        ref = _finish_reference(proc, tmp)
    return cases, batches, out, ref


@pytest.mark.parametrize("shape", [s for s, _ in RS_MESHES],
                         ids=["p4", "d2m2"])
@pytest.mark.parametrize("name", RECSYS)
def test_recsys_train_steps_on_mesh_match_reference_plan(recsys, name,
                                                         shape):
    """Two steps: losses 1e-5 relative, each parameter leaf within 1e-5
    of max(1, |p|) (AdamW leaves whose gradient is rounding noise, as the
    single-device test finds them, within 2·2·lr), and every leaf of the
    sharded tables moved."""
    cases, _, out, ref = recsys
    got = out[0][(name, shape)]["train_batch"]
    want_losses, want, noise = ref[(name, shape)]
    for i, (a, b) in enumerate(zip(got["losses"], want_losses)):
        _rel_loss(f"mp.{name}.{shape}.step{i}.loss", a, b)
    assert got["step"] == 2
    noise = noise or [False] * len(want)
    init = jax.tree_util.tree_leaves(cases[(name, shape)]["params"])
    for i, (g, w, z, p0) in enumerate(zip(got["params"], want, noise, init)):
        scale = max(1.0, float(np.abs(w).max()))
        assert_parity(f"mp.{name}.{shape}.param{i}", g, w,
                      atol=2 * 2 * 3e-4 if z else TOL * scale)
        if g.ndim == 2 and g.shape[0] >= 8192:       # a sharded table
            assert np.abs(g - p0).max() > 0, (name, i)


@pytest.mark.parametrize("shape", [s for s, _ in RS_MESHES],
                         ids=["p4", "d2m2"])
@pytest.mark.parametrize("name", RECSYS)
def test_recsys_serve_and_retrieval_on_mesh_match_single_device(
        recsys, name, shape):
    cases, batches, out, _ = recsys
    got = out[0][(name, shape)]
    arch = dataclasses.replace(get_arch(name),
                               config=cases[(name, shape)]["cfg"])
    model = recsys_from_reference(arch.config, cases[(name, shape)]["params"],
                                  device="cpu")
    for cell_name in ("serve_p99", "retrieval_cand"):
        cell = dataclasses.replace(arch.cell(cell_name),
                                   dims=RS_DIMS[cell_name])
        want = build_step(arch, cell).fn(model, batches[name][cell_name])
        assert_parity(f"mp.{name}.{shape}.{cell_name}", got[cell_name],
                      want, atol=1e-6)


def test_exchange_gradient_matches_reference_grad(recsys):
    """The skewed batch drops lookups (bucket slack 1.0); the table
    block's gradient (every rank's block, in rank order) and the
    replicated table's (summed over the ranks) equal ``jax.grad`` of the
    reference's meshed lookup within 1e-5."""
    _, _, out, ref = recsys
    vals = np.concatenate([o["exchange"]["vals"] for o in out])
    assert_parity("mp.exchange.vals", vals, ref["exchange_vals"], atol=0.0)
    dropped = ~vals[:, 0].any(axis=1)
    assert 0 < dropped.sum() < len(dropped)
    block = np.concatenate([o["exchange"]["block"] for o in out])
    rep = sum(o["exchange"]["replicated"] for o in out)
    assert_parity("mp.exchange.grad.sharded", block,
                  ref["exchange"]["sharded"], atol=TOL)
    assert_parity("mp.exchange.grad.replicated", rep,
                  ref["exchange"]["replicated"], atol=TOL)
