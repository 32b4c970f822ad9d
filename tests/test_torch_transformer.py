"""The port's LM serving path (``repro_torch.models.transformer``,
``configs``, ``launch.steps``, ``data.batches``) against the JAX
reference on the CPU.

The reference's ``init_params`` tree (with its zero biases and unit norm
scales perturbed by seeded numpy noise, so that every parameter matters)
is carried into the port by ``repro_torch.state.transformer_from_reference``;
then ``prefill`` and three teacher-forced ``decode_step``s run in both
packages on the same tokens.  Smoke configs in f32; tolerance 1e-5 on
logits and caches (the two packages' matmul, rsqrt, exp and sin/cos
round differently in the last bits; ``len`` is exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.data.batches import lm_batch as jax_lm_batch
from repro.models import common as jcm
from repro.models import transformer as jtx
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ShapeCell, input_specs
from repro_torch.data.batches import lm_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.steps import build_step
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttx
from repro_torch.state import transformer_from_reference

TOL = 1e-5
ARCHS = ["llama3_2_1b", "codeqwen1_5_7b"]


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _perturbed_reference(cfg, seed):
    """Reference params with biases and norm scales moved off 0 / 1."""
    params = jtx.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        last = str(path[-1])
        x = np.asarray(x)
        if "'b'" in last or "'scale'" in last:
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, params)


def _reference_cfg(name):
    import importlib
    return importlib.import_module(f"repro.configs.{name}").smoke_config()


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    jcfg = _reference_cfg(name)
    tcfg = get_arch(name).smoke_config()
    params = _perturbed_reference(jcfg, seed=3)
    model = transformer_from_reference(tcfg, params, device="cpu")
    b, s, max_len = 3, 12, 16
    toks = lm_batch(b, s, tcfg.vocab, seed=1)["tokens"]

    jl, jc = jtx.prefill(jcfg, params, jnp.asarray(toks), max_len=max_len)
    tl, tc = model.prefill(torch.from_numpy(toks), max_len=max_len)
    assert tuple(tc["k"].shape) == (tcfg.n_layers, b, tcfg.n_kv_heads,
                                    max_len, tcfg.dh)
    assert_parity(f"{name}.prefill.logits", tl, jl, TOL)
    for key in ("k", "v"):
        assert_parity(f"{name}.prefill.cache.{key}", tc[key], jc[key], TOL)
    assert_parity(f"{name}.prefill.len", tc["len"], jc["len"])

    rng = np.random.default_rng(2)
    for step in range(3):
        nxt = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jtx.decode_step(jcfg, params, jnp.asarray(nxt), jc)
        tl, tc = model.decode_step(torch.from_numpy(nxt), tc)
        assert_parity(f"{name}.decode{step}.logits", tl, jl, TOL)
        for key in ("k", "v"):
            assert_parity(f"{name}.decode{step}.cache.{key}", tc[key],
                          jc[key], TOL)
        assert_parity(f"{name}.decode{step}.len", tc["len"], jc["len"])


def test_decode_into_a_full_cache_matches_reference():
    """max_len = S: the reference's one-hot insert writes nothing, so the
    new token attends to the prompt only; the port's indexed write keeps
    that."""
    name = "llama3_2_1b"
    jcfg, tcfg = _reference_cfg(name), get_arch(name).smoke_config()
    params = _perturbed_reference(jcfg, seed=4)
    model = transformer_from_reference(tcfg, params, device="cpu")
    toks = lm_batch(2, 8, tcfg.vocab, seed=4)["tokens"]
    jl, jc = jtx.prefill(jcfg, params, jnp.asarray(toks))
    tl, tc = model.prefill(torch.from_numpy(toks))
    nxt = np.array([[3], [7]], np.int32)
    jl, jc = jtx.decode_step(jcfg, params, jnp.asarray(nxt), jc)
    tl, tc = model.decode_step(torch.from_numpy(nxt), tc)
    assert_parity("full_cache.logits", tl, jl, TOL)
    assert_parity("full_cache.cache.k", tc["k"], jc["k"], TOL)


def test_two_decodes_from_one_cache_branch_as_in_reference():
    """decode_step leaves its input cache as it was: two different tokens
    decoded from one cache give two caches (and logits) that each equal
    the reference's, and the input cache still equals the prefill's."""
    name = "llama3_2_1b"
    jcfg, tcfg = _reference_cfg(name), get_arch(name).smoke_config()
    params = _perturbed_reference(jcfg, seed=5)
    model = transformer_from_reference(tcfg, params, device="cpu")
    toks = lm_batch(2, 6, tcfg.vocab, seed=5)["tokens"]
    jl, jc = jtx.prefill(jcfg, params, jnp.asarray(toks), max_len=9)
    tl, tc = model.prefill(torch.from_numpy(toks), max_len=9)
    before = {key: val.clone() for key, val in tc.items()}
    for branch, nxt in enumerate(([[3], [7]], [[11], [2]])):
        nxt = np.array(nxt, np.int32)
        jbl, jbc = jtx.decode_step(jcfg, params, jnp.asarray(nxt), jc)
        tbl, tbc = model.decode_step(torch.from_numpy(nxt), tc)
        assert_parity(f"branch{branch}.logits", tbl, jbl, TOL)
        for key in ("k", "v"):
            assert_parity(f"branch{branch}.cache.{key}", tbc[key], jbc[key],
                          TOL)
        assert_parity(f"branch{branch}.len", tbc["len"], jbc["len"])
        for key, val in before.items():
            assert torch.equal(tc[key], val), f"input cache {key} changed"


def test_ragged_cache_insert_writes_each_rows_own_position():
    cache = torch.zeros(3, 2, 5, 4)
    new = torch.arange(24, dtype=torch.float32).reshape(3, 2, 1, 4) + 1
    lens = torch.tensor([0, 3, 5], dtype=torch.int32)
    want = np.asarray(jtx._cache_insert(jnp.zeros((3, 2, 5, 4)),
                                        jnp.asarray(new.numpy()),
                                        jnp.asarray(lens.numpy())))
    assert_parity("cache_insert", ttx._cache_insert(cache, new, lens), want)


def test_parameter_names_and_shapes_follow_the_reference_tree():
    for name in ARCHS:
        jcfg, tcfg = _reference_cfg(name), get_arch(name).smoke_config()
        ref = _flatten(jtx.init_params(jcfg, jax.random.PRNGKey(0)))
        port = ttx.Transformer(tcfg, ttx.init_params(
            tcfg, torch.Generator().manual_seed(0), "cpu"))
        got = {n: tuple(p.shape) for n, p in port.named_parameters()}
        assert got == {n: x.shape for n, x in ref.items()}
        assert tcm.count_params(port) == jcm.count_params(
            jtx.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", ["llama3_2_1b", "codeqwen1_5_7b",
                                  "qwen1_5_110b"])
def test_configs_match_reference(name):
    import importlib
    ref = importlib.import_module(f"repro.configs.{name}")
    arch = get_arch(name)
    for cfg, jcfg in ((arch.config, ref.CONFIG),
                      (arch.smoke_config(), ref.smoke_config())):
        got = dataclasses.asdict(cfg)
        want = dataclasses.asdict(jcfg)
        assert got.pop("dtype") == getattr(torch, jnp.dtype(
            want.pop("dtype")).name)
        assert got == want
        assert cfg.param_count() == jcfg.param_count()
    assert [c.name for c in arch.shapes] == [c.name for c in
                                             ref.ARCH.shapes]


def test_llama_full_width_param_count():
    cfg = get_arch("llama3_2_1b").config
    assert cfg.param_count() == 1_235_814_400      # 1.236 B, tied embedding


def test_unported_families_raise():
    # every family is ported: egnn resolves, and an unknown kind is
    # refused as the reference's build_step refuses it
    assert get_arch("egnn").kind == "gnn"
    arch = get_arch("llama3_2_1b")
    with pytest.raises(ValueError, match="unknown"):
        build_step(dataclasses.replace(arch, kind="unknown"),
                   arch.cell("train_4k"))


def test_input_specs_match_reference_shapes():
    name = "llama3_2_1b"
    arch = get_arch(name)
    import importlib
    jarch = importlib.import_module(f"repro.configs.{name}").ARCH
    for cell in arch.shapes:
        got = input_specs(arch, cell)
        want = jreg.input_specs(jarch, jarch.cell(cell.name))
        for key, spec in got.items():
            if key == "cache":
                for ck, cs in spec.items():
                    assert cs.shape == want[key][ck].shape
            else:
                assert spec.shape == want[key].shape
                assert spec.dtype == torch.int32


def test_build_step_prefill_and_decode():
    arch = get_arch("llama3_2_1b")
    cfg = arch.smoke_config()
    small = dataclasses.replace(arch, config=cfg)
    b, s = 2, 10
    pre = build_step(small, ShapeCell("p", "prefill", {"batch": b, "seq": s}))
    dec = build_step(small, ShapeCell("d", "decode", {"batch": b, "seq": s}))
    assert pre.example_args["tokens"].shape == (b, s)
    assert dec.example_args["cache"]["k"].shape == (cfg.n_layers, b,
                                                    cfg.n_kv_heads, s, cfg.dh)
    params = ttx.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    model = ttx.Transformer(cfg, params)
    toks = torch.from_numpy(lm_batch(b, s, cfg.vocab, seed=5)["tokens"])
    before = flash_attention.launches
    logits, cache = pre.fn(model, {"tokens": toks}, max_len=s + 2)
    want_logits, _ = model.prefill(toks, max_len=s + 2)
    assert torch.equal(logits, want_logits)
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    logits2, cache2 = dec.fn(model, {"tokens": nxt, "cache": cache})
    assert torch.isfinite(logits2).all()
    assert cache2["len"].tolist() == [s + 1] * b
    assert flash_attention.launches == before    # CPU: plain versions
    # the plain route gives the same values on the CPU
    plain = ttx.Transformer(cfg, params, use_kernel=False)
    assert torch.equal(plain.prefill(toks, max_len=s + 2)[0], want_logits)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_lm_batch_is_byte_identical(seed):
    got = lm_batch(3, 17, 1000, seed=seed)
    want = jax_lm_batch(3, 17, 1000, seed=seed)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes()
