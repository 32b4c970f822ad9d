"""The port's MoE and MLA LMs (``repro_torch.models.transformer``'s MoE
FFN and MLA attention, ``configs.qwen3_moe_30b_a3b`` and
``configs.deepseek_v2_236b``) against the JAX reference on the CPU.

The reference's ``init_params`` tree of each smoke config (its zero
biases and unit norm scales perturbed by seeded numpy noise, so that
every parameter matters) is carried into the port by
``repro_torch.state.transformer_from_reference``; the same numpy inputs
then go through both packages in f32.  Tolerances: 1e-5 absolute on
outputs, logits and caches (the two packages' matmul, rsqrt, exp and
sin/cos round differently in the last bits), ``len`` exact; the router's
expert ids equal (a near-tied gate could flip between the packages'
roundings: the assertion prints the gap of every token it compares);
loss and gradients within 1e-4 relative to each leaf's largest value.
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
from repro.configs import registry as jreg
from repro.models import common as jcm
from repro.models import transformer as jtx
from repro_torch.configs import get_arch
from repro_torch.configs.registry import input_specs
from repro_torch.data.batches import lm_batch
from repro_torch.kernels.select import router_topk, select_topm
from repro_torch.launch.steps import build_step
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttx
from repro_torch.state import transformer_from_reference
from repro_torch.training.train_loop import trainable

TOL = 1e-5
GRAD_RTOL = 1e-4
ARCHS = ["qwen3_moe_30b_a3b", "deepseek_v2_236b"]


def _ref_module(name):
    return importlib.import_module(f"repro.configs.{name}")


def _perturbed_reference(cfg, seed):
    """Reference params with norm scales (and any biases) moved off 1 / 0."""
    params = jtx.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        last = str(path[-1])
        x = np.asarray(x)
        if "'b'" in last or "'scale'" in last:
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, params)


def _pair(name, seed=3):
    jcfg = _ref_module(name).smoke_config()
    tcfg = get_arch(name).smoke_config()
    return jcfg, tcfg, _perturbed_reference(jcfg, seed)


def _layer(params, field, i=0):
    """Layer ``i`` of a stacked stack, as numpy."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[i], params[field])


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _reference_routing(cfg, p, x):
    """The reference's router on x (B, S, D): probs (T, E) and the
    ``lax.top_k`` ids (T, K), as ``local_moe`` computes them."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = (xt @ jnp.asarray(p["router"]["w"])).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])


def _assert_same_routing(name, tcfg, p, x, jcfg, jp):
    """The port's expert ids (``router_topk`` on its own probabilities)
    equal the reference's; prints each token's gap between its k-th and
    (k+1)-th probability, the margin a rounding difference would have to
    cross to flip a choice."""
    probs, jids = _reference_routing(jcfg, jp, x)
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    tprobs = torch.softmax(xt @ p["router"]["w"], dim=-1)
    _, tids = router_topk(tprobs, tcfg.moe.top_k)
    srt = -np.sort(-probs, axis=1)
    gaps = srt[:, tcfg.moe.top_k - 1] - srt[:, tcfg.moe.top_k]
    print(f"ROUTING {name} min_gap={float(gaps.min())!r} "
          f"probs_max_abs_diff={float(np.abs(tprobs.numpy() - probs).max())!r}")
    flips = np.nonzero((tids.numpy() != jids).any(1))[0]
    assert not flips.size, (f"{name}: tokens {flips.tolist()} route "
                            f"differently; gaps {gaps[flips].tolist()}")
    return jids


# -- the router's selection ------------------------------------------------

def test_router_topk_is_lax_top_k_with_ties_to_the_lower_expert():
    """Values and ids bit for bit ``lax.top_k``'s on seeded probabilities
    with exact ties (repeated values), and on uniform rows: experts
    0..k-1.  The plain selection (``use_kernel=False``) gives the same."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 5, (40, 12)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True) + 1.0
    probs[3] = 1.0 / 12
    for k in (1, 3, 8, 12):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        for use_kernel in (True, False):
            tv, ti = router_topk(torch.from_numpy(probs), k,
                                 use_kernel=use_kernel)
            assert ti.dtype == torch.int32
            assert_parity(f"router_topk.k{k}.values", tv, jv)
            assert_parity(f"router_topk.k{k}.ids", ti, ji)
        assert ti[3].tolist() == list(range(k))
    before = select_topm.launches
    router_topk(torch.from_numpy(probs), 2)
    assert select_topm.launches == before      # CPU: the plain version


def test_router_topk_passes_the_gradient_to_the_gates():
    """The values are the probabilities gathered at the chosen ids, so a
    gradient reaches every chosen gate, as ``lax.top_k``'s does."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 1, (6, 8)).astype(np.float32)
    w = rng.normal(0, 1, (6, 3)).astype(np.float32)
    want = jax.grad(lambda z: jnp.sum(jax.lax.top_k(
        jax.nn.softmax(z, -1), 3)[0] * w))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    vals, _ = router_topk(torch.softmax(z, -1), 3)
    (vals * torch.from_numpy(w)).sum().backward()
    assert_parity("router_topk.grad", z.grad, want, TOL)


# -- the MoE FFN ---------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.3])
def test_moe_ffn_matches_reference(name, cf):
    """``_moe_ffn`` of the first MoE layer on seeded inputs, against the
    reference's with ``NO_SHARDING``: the expert ids equal, the output
    within 1e-5 — at the default capacity and at ``capacity_factor`` 0.3,
    where the test checks that assignments are dropped."""
    jcfg, tcfg, params = _pair(name, seed=4)
    jp = _layer(params, "moe_layers")["ffn"]
    p = _torch_tree(jp)
    x = np.random.default_rng(5).normal(0, 1, (3, 10, tcfg.d_model)) \
        .astype(np.float32)
    ids = _assert_same_routing(f"{name}.cf{cf}", tcfg, p, x, jcfg, jp)
    t, m = 30, tcfg.moe
    capacity = max(int(t * m.top_k / m.n_experts * (cf or m.capacity_factor)),
                   4)
    counts = np.bincount(ids.reshape(-1), minlength=m.n_experts)
    dropped = int(np.maximum(counts - capacity, 0).sum())
    if cf is not None:
        assert dropped > 0, (capacity, counts)
    want = jtx._moe_ffn(jcfg, jp, jnp.asarray(x), jcm.NO_SHARDING,
                        capacity_factor=cf)
    got = ttx._moe_ffn(tcfg, p, torch.from_numpy(x), capacity_factor=cf)
    assert_parity(f"moe_ffn.{name}.cf{cf}.dropped{dropped}", got, want, TOL)
    plain = ttx._moe_ffn(tcfg, p, torch.from_numpy(x), capacity_factor=cf,
                         use_kernel=False)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("n,e", [(1, 3), (96, 9), (4096, 161)])
def test_expert_slots_equal_the_one_hot_cumsum(n, e):
    """Each assignment's slot in its expert equals the reference's
    one-hot cumsum (``transformer.py:489-490``) on seeded ids with heavy
    repeats, the pad expert e included."""
    flat_e = np.random.default_rng(n).integers(0, e + 1, n)
    onehot = jax.nn.one_hot(jnp.asarray(flat_e), e + 1, dtype=jnp.int32)
    want = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    assert_parity(f"expert_slots.{n}x{e}",
                  ttx._expert_slots(torch.from_numpy(flat_e)), want)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_exact_tie_router_picks_the_first_experts(name):
    """Zero router weights: every gate is 1/E, ``lax.top_k`` takes experts
    0..k-1 for every token, so the first k experts fill to capacity and
    the rest of the assignments drop; the port does the same."""
    jcfg, tcfg, params = _pair(name, seed=6)
    jp = _layer(params, "moe_layers")["ffn"]
    jp["router"]["w"] = np.zeros_like(jp["router"]["w"])
    p = _torch_tree(jp)
    x = np.random.default_rng(7).normal(0, 1, (2, 9, tcfg.d_model)) \
        .astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(18, -1)
                          @ p["router"]["w"], dim=-1)
    _, ids = router_topk(probs, tcfg.moe.top_k)
    assert (ids == torch.arange(tcfg.moe.top_k, dtype=torch.int32)).all()
    _, jids = _reference_routing(jcfg, jp, x)
    assert (jids == np.arange(tcfg.moe.top_k)).all()
    want = jtx._moe_ffn(jcfg, jp, jnp.asarray(x), jcm.NO_SHARDING)
    got = ttx._moe_ffn(tcfg, p, torch.from_numpy(x))
    assert_parity(f"moe_ffn.{name}.tied", got, want, TOL)


# -- MLA attention ----------------------------------------------------------

def test_mla_attention_matches_reference():
    """``_mla_attention`` (prefill form) of layer 0: output and the cache's
    latent (c_kv, k_rope) within 1e-5."""
    name = "deepseek_v2_236b"
    jcfg, tcfg, params = _pair(name, seed=8)
    jp = _layer(params, "dense_layers")["attn"]
    p = _torch_tree(jp)
    b, s = 2, 11
    x = np.random.default_rng(9).normal(0, 1, (b, s, tcfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    want, jkv = jtx._mla_attention(jcfg, jp, jnp.asarray(x),
                                   jcm.NO_SHARDING, jnp.asarray(pos))
    got, kv = ttx._mla_attention(tcfg, p, torch.from_numpy(x),
                                 torch.from_numpy(pos).long(), True)
    assert_parity("mla_attention.out", got, want, TOL)
    for key in ("c_kv", "k_rope"):
        assert_parity(f"mla_attention.{key}", kv[key], jkv[key], TOL)


def test_mla_decode_layer_matches_reference_over_three_steps():
    """``_mla_decode_layer`` (the absorbed form) of layer 0 over three
    steps from a random latent cache with ragged lengths, one row at the
    cache's end (the reference's one-hot insert writes nothing there):
    outputs and both caches within 1e-5."""
    name = "deepseek_v2_236b"
    jcfg, tcfg, params = _pair(name, seed=10)
    jp = _layer(params, "dense_layers")["attn"]
    p = _torch_tree(jp)
    a = tcfg.mla
    rng = np.random.default_rng(11)
    b, s = 3, 9
    c_kv = rng.normal(0, 1, (b, s, a.kv_lora_rank)).astype(np.float32)
    k_rope = rng.normal(0, 1, (b, s, a.qk_rope_dim)).astype(np.float32)
    lens = np.array([2, 5, 9], np.int32)
    jcache = {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope)}
    tc, tr = torch.from_numpy(c_kv.copy()), torch.from_numpy(k_rope.copy())
    for step in range(3):
        x = rng.normal(0, 1, (b, 1, tcfg.d_model)).astype(np.float32)
        want, jcache = jtx._mla_decode_layer(jcfg, jp, jnp.asarray(x), jcache,
                                             jnp.asarray(lens),
                                             jcm.NO_SHARDING)
        got = ttx._mla_decode_layer(tcfg, p, torch.from_numpy(x), tc, tr,
                                    torch.from_numpy(lens))
        assert_parity(f"mla_decode{step}.out", got, want, TOL)
        assert_parity(f"mla_decode{step}.c_kv", tc, jcache["c_kv"], TOL)
        assert_parity(f"mla_decode{step}.k_rope", tr, jcache["k_rope"], TOL)
        lens = lens + 1


# -- the models: serving ----------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """``prefill`` and three teacher-forced ``decode_step``s: logits and
    caches within 1e-5, ``len`` exact; the first MoE layer's routing on
    the prefill's input equal to the reference's."""
    jcfg, tcfg, params = _pair(name)
    model = transformer_from_reference(tcfg, params, device="cpu")
    b, s, max_len = 3, 12, 16
    toks = lm_batch(b, s, tcfg.vocab, seed=1)["tokens"]
    keys = ("c_kv", "k_rope") if tcfg.mla is not None else ("k", "v")

    jl, jc = jtx.prefill(jcfg, params, jnp.asarray(toks), max_len=max_len)
    tl, tc = model.prefill(torch.from_numpy(toks), max_len=max_len)
    assert sorted(tc) == sorted(jc)
    assert_parity(f"{name}.prefill.logits", tl, jl, TOL)
    for key in keys:
        assert tc[key].shape == jc[key].shape
        assert_parity(f"{name}.prefill.cache.{key}", tc[key], jc[key], TOL)
    assert_parity(f"{name}.prefill.len", tc["len"], jc["len"])

    rng = np.random.default_rng(2)
    for step in range(3):
        nxt = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jtx.decode_step(jcfg, params, jnp.asarray(nxt), jc)
        tl, tc = model.decode_step(torch.from_numpy(nxt), tc)
        assert_parity(f"{name}.decode{step}.logits", tl, jl, TOL)
        for key in keys:
            assert_parity(f"{name}.decode{step}.cache.{key}", tc[key],
                          jc[key], TOL)
        assert_parity(f"{name}.decode{step}.len", tc["len"], jc["len"])


@pytest.mark.parametrize("name", ARCHS)
def test_build_step_prefill_and_decode(name):
    """The registry's arch through ``build_step`` prefill / decode on the
    CPU: the steps are the model's own calls, the decode cache has the
    input spec's shapes, and the plain route gives the same values."""
    arch = get_arch(name)
    cfg = arch.smoke_config()
    small = dataclasses.replace(arch, config=cfg)
    b, s = 2, 10
    pre = build_step(small, dataclasses.replace(
        arch.cell("prefill_32k"), dims={"batch": b, "seq": s}))
    dec = build_step(small, dataclasses.replace(
        arch.cell("decode_32k"), dims={"batch": b, "seq": s + 2}))
    model = ttx.Transformer(cfg, ttx.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"))
    toks = torch.from_numpy(lm_batch(b, s, cfg.vocab, seed=5)["tokens"])
    logits, cache = pre.fn(model, {"tokens": toks}, max_len=s + 2)
    assert torch.equal(logits, model.prefill(toks, max_len=s + 2)[0])
    specs = dec.example_args["cache"]
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in specs.items()}
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    logits2, cache2 = dec.fn(model, {"tokens": nxt, "cache": cache})
    assert torch.isfinite(logits2).all()
    assert cache2["len"].tolist() == [s + 1] * b
    plain = ttx.Transformer(cfg, model.tree(), use_kernel=False)
    assert torch.equal(plain.prefill(toks, max_len=s + 2)[0], logits)
    assert torch.equal(plain.decode_step(nxt, cache)[0], logits2)


# -- the models: training ---------------------------------------------------

def _rel_close(name, got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert_parity(name, got, want, atol=rtol * scale)


@pytest.mark.parametrize("name,remat", [("qwen3_moe_30b_a3b", False),
                                        ("deepseek_v2_236b", True)])
def test_loss_and_gradients_match_reference(name, remat):
    """``loss_fn`` and every leaf's gradient (routers, 3-D experts, shared
    experts, MLA's LoRA weights and norms) against ``jax.grad`` of the
    reference's, f32, within 1e-4 relative to the leaf's largest value."""
    jcfg, tcfg, params = _pair(name, seed=12)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    batch = lm_batch(4, 16, tcfg.vocab, seed=2)
    batch["labels"][1, ::3] = -1
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtx.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()})))(params)
    model = transformer_from_reference(tcfg, params, device="cpu")
    tree = trainable(model.tree())
    got = ttx.backward(tcfg, tree, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    _rel_close(f"{name}.loss", got, want, GRAD_RTOL)
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_t = jax.tree_util.tree_leaves(tree)
    assert len(flat_j) == len(flat_t)
    for (path, g), leaf in zip(flat_j, flat_t):
        assert leaf.grad is not None, jax.tree_util.keystr(path)
        _rel_close(f"{name}.grad{jax.tree_util.keystr(path)}", leaf.grad, g,
                   GRAD_RTOL)


@pytest.mark.parametrize("name", ARCHS)
def test_build_step_train_runs_and_lowers_the_loss(name):
    """``build_step(train_4k)`` on the smoke config: two AdamW steps with
    finite losses, every parameter moved where its gradient is nonzero,
    the serving copy refreshed, and the loss on the first batch lower
    after than before."""
    arch = get_arch(name)
    cfg = arch.smoke_config()
    arch = dataclasses.replace(arch, config=cfg)
    cell = dataclasses.replace(arch.cell("train_4k"),
                               dims={"batch": 4, "seq": 16})
    plan = build_step(arch, cell)
    model = ttx.Transformer(cfg, ttx.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    state = plan.optimizer.init(model.tree())
    batch = lm_batch(4, 16, cfg.vocab, seed=8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        before = float(ttx.loss_fn(cfg, model.tree(), tb))
    start = [t.detach().clone() for t in model.parameters()]
    for _ in range(2):
        model, state, loss = plan.fn(model, state, batch)
        assert torch.isfinite(loss)
    with torch.no_grad():
        after = float(ttx.loss_fn(cfg, model.tree(), tb))
    assert after < before, (before, after)
    moved = [not torch.equal(a, b) for a, b in zip(start, model.parameters())]
    assert sum(moved) >= len(moved) - 1, moved
    fresh = ttx.Transformer(cfg, {k: v for k, v in model.tree().items()})
    toks = tb["tokens"][:2]
    assert torch.equal(model.prefill(toks)[0], fresh.prefill(toks)[0])


# -- configs and shapes -------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_and_counts_match_reference(name):
    """Configs field for field (nested MoE / MLA configs too), and
    ``param_count`` / ``active_param_count`` / ``layer_counts`` of the
    full and smoke configs as exact integers."""
    ref = _ref_module(name)
    arch = get_arch(name)
    for cfg, jcfg in ((arch.config, ref.CONFIG),
                      (arch.smoke_config(), ref.smoke_config())):
        got = dataclasses.asdict(cfg)
        want = dataclasses.asdict(jcfg)
        assert got.pop("dtype") == getattr(torch, jnp.dtype(
            want.pop("dtype")).name)
        assert got == want
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.layer_counts() == jcfg.layer_counts()
        assert cfg.mla is None or cfg.mla.qk_dim == jcfg.mla.qk_dim
    assert [c.name for c in arch.shapes] == [c.name for c in ref.ARCH.shapes]
    want = {"qwen3_moe_30b_a3b": (30_532_122_624, 3_353_032_704, (0, 48)),
            "deepseek_v2_236b": (235_741_434_880, 21_375_800_320, (1, 59))}
    cfg = arch.config
    assert (cfg.param_count(), cfg.active_param_count(),
            cfg.layer_counts()) == want[name]


@pytest.mark.parametrize("name", ARCHS)
def test_parameter_names_and_shapes_follow_the_reference_tree(name):
    jcfg, tcfg = _ref_module(name).smoke_config(), get_arch(name).smoke_config()
    ref_tree = jtx.init_params(jcfg, jax.random.PRNGKey(0))
    port = ttx.Transformer(tcfg, ttx.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    got = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert got == {n: x.shape for n, x in _flatten(ref_tree).items()}
    assert tcm.count_params(port) == jcm.count_params(ref_tree) \
        == tcfg.param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_match_reference(name):
    """Every cell's input specs (the MLA decode cache's c_kv / k_rope too)
    have the reference's names, shapes and dtypes."""
    arch = get_arch(name)
    jarch = _ref_module(name).ARCH
    for cell in arch.shapes:
        got = input_specs(arch, cell)
        want = jreg.input_specs(jarch, jarch.cell(cell.name))
        assert sorted(got) == sorted(want)
        for key, spec in got.items():
            pairs = (spec.items() if key == "cache"
                     else [(key, spec)])
            for ck, cs in pairs:
                ws = want[key][ck] if key == "cache" else want[key]
                assert cs.shape == ws.shape, (cell.name, ck)
                assert cs.dtype == getattr(torch, jnp.dtype(ws.dtype).name)
            if key == "cache":
                assert sorted(spec) == sorted(want[key])
