"""Port parity: LM serving on a mesh (``build_step``'s prefill and decode
plans on a ``DeviceMesh``, ``Transformer.prefill`` / ``decode_step`` of a
meshed model, the decode cache placed by ``cache_specs`` with its
sequence over ``model``, and ``common.merge_by_lse``) against the JAX
reference on the CPU.

The port's ranks run in one launch a world size (``tests/_torch_dist.py``:
``lm_serve``; the (1, 2) mesh on 2 gloo ranks, (2, 2) and (1, 4) on 4);
the reference's meshed plans run, jitted with their shardings, in one
subprocess on 4 fake XLA devices.  Everything is f32 (TF32 off, as the
port pins it), the reference's ``init_params`` tree (norm scales moved
off 1 by seeded noise) carried into the port.

* The smoke configs of the three LMs (Llama-3.2-1B: GQA with its kv
  heads whole, one head shared by two ``model`` ranks at M = 4, and a
  variant with 16 kv heads, which split over ``model``; Qwen3-30B-A3B:
  MoE; DeepSeek-V2: MoE + MLA's absorbed decode): a
  prompt of 7 tokens a row prefilled into a cache of 16 positions, then 4
  teacher-forced decode steps at positions 7-10, which cross a slice
  boundary at M = 2 (8) and at M = 4 (8), with the slices past the
  current position empty.  Logits of every call within 1e-5 of the
  reference's meshed plans, and (MoE at capacity factor 100, so that no
  token is dropped) within 1e-5 of the port's no-mesh plans; the cache,
  gathered, within 1e-5 of both, ``len`` equal.
* The MoE configs at their own capacity factor (each rank drops tokens by
  its local count) against the reference's meshed plans; every ``model``
  rank of a ``data`` group routes alike, and at factor 100 the routing is
  the no-mesh plans'.
* A cache length that does not split over ``model`` raises ``ValueError``
  naming the axis where the reference's plan raises ``ValueError``; the
  cache placement round-trips.
* ``merge_by_lse_parts`` over 1-4 sequence slices of kernel 8's plain
  version (one slice with no visible key) against the unsplit decode.
"""

import dataclasses
import importlib
import pickle

import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.models import transformer as jtx
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_plain)
from repro_torch.launch.steps import build_step
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttx
from repro_torch.state import transformer_from_reference

TOL = 1e-5
LM = ("llama3_2_1b", "qwen3_moe_30b_a3b", "deepseek_v2_236b")
MOE = LM[1:]
MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model"))]
SHAPES = [s for s, _ in MESHES]
B, S, MAX_LEN, STEPS = 4, 7, 16, 4
FREE = 100.0            # a capacity factor at which no token is dropped
# a Llama smoke variant whose 16 kv heads split over ``model`` (k and v
# column-parallel, ``n_kv_heads % 16 == 0``), on the meshes of one data rank
KV16 = "llama3_2_1b:kv16"
OVER = {KV16: {"n_heads": 16, "n_kv_heads": 16, "head_dim": 4}}


def _arch(variant):
    return variant.split(":")[0]


def _cfgs(variant, cf):
    """(reference, port) smoke configs of ``variant``, the MoE capacity
    factor set."""
    name, out = _arch(variant), []
    for cfg in (importlib.import_module(f"repro.configs.{name}")
                .smoke_config(), get_arch(name).smoke_config()):
        cfg = dataclasses.replace(cfg, **OVER.get(variant, {}))
        if cfg.moe is not None and cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


def _cases():
    """(config, capacity factor, mesh shape) → the rank task's case: the
    MoE configs at factor 100 on every mesh and at their own factor on
    the 4-rank meshes; the kv16 variant at (1, 2) and (1, 4)."""
    cases = {}
    for name in LM + (KV16,):
        for cf in ((None,) if name not in MOE else (FREE, None)):
            shapes = SHAPES[1:] if cf is None and name in MOE else SHAPES
            for shape in shapes if name != KV16 else SHAPES[::2]:
                cases[(name, cf, shape)] = {
                    "arch": _arch(name), "params": name,
                    "cfg": _cfgs(name, cf)[1], "mesh": shape}
    return cases


CASES = list(_cases())
# the cases whose routing drops nothing, held to the no-mesh plans too
UNDROPPED = [(v, shape) for v, cf, shape in CASES
             if cf is not None or v not in MOE]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if "'scale'" in str(path[-1]) or "'b'" in str(path[-1]):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(jitter, params)


def _inputs():
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, (B, S)).astype(np.int32)
    feed = [rng.integers(0, 512, (B, 1)).astype(np.int32)
            for _ in range(STEPS)]
    return prompt, feed


def _no_mesh(variant, params, prompt, feed):
    """The port's no-mesh plans at factor 100: every call's logits, the
    caches after the prefill and after the last step, each MoE call's
    expert ids."""
    cfg = _cfgs(variant, FREE)[1]
    arch = dataclasses.replace(get_arch(_arch(variant)), config=cfg)
    pre = build_step(arch, arch.cell("prefill_32k"))
    dec = build_step(arch, arch.cell("decode_32k"))
    model = transformer_from_reference(cfg, params, device="cpu")
    ids, orig = [], ttx.router_topk

    def router(probs, k, *, use_kernel=True):
        vals, idx = orig(probs, k, use_kernel=use_kernel)
        ids.append(idx.numpy())
        return vals, idx
    ttx.router_topk = router
    try:
        logits, cache = pre.fn(model, {"tokens": prompt}, max_len=MAX_LEN)
        out = {"logits": [logits.numpy()],
               "prefill_cache": {k: v.numpy() for k, v in cache.items()}}
        for tok in feed:
            logits, cache = dec.fn(model, {"tokens": tok, "cache": cache})
            out["logits"].append(logits.numpy())
    finally:
        ttx.router_topk = orig
    out["cache"] = {k: v.numpy() for k, v in cache.items()}
    out["ids"] = ids
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    params = {name: _perturbed(jtx.init_params(
        _cfgs(name, None)[0], jax.random.PRNGKey(7)), 7)
        for name in LM + (KV16,)}
    prompt, feed = _inputs()
    rng = np.random.default_rng(9)
    llama = _cfgs("llama3_2_1b", None)[1]
    kv = (llama.n_layers, B, llama.n_kv_heads, MAX_LEN, llama.dh)
    roundtrip = {"k": rng.normal(size=kv).astype(np.float32),
                 "v": rng.normal(size=kv).astype(np.float32),
                 "len": rng.integers(0, MAX_LEN, B).astype(np.int32)}
    tmp = tmp_path_factory.mktemp("lm_serve_ref")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"params": params, "prompt": prompt, "feed": feed,
                     "cases": CASES, "over": OVER}, f)
    proc = td.start_reference(f"""
        import dataclasses, importlib, pickle
        import numpy as np, jax
        from repro.compat import make_mesh
        from repro.distributed.sharding import make_ctx
        from repro.launch import steps as jsteps
        from repro.models import transformer as tx
        d = pickle.load(open({str(tmp / "in.pkl")!r}, "rb"))
        out = {{}}

        def whole(tree):
            return {{k: np.asarray(v) for k, v in tree.items()}}

        for name, cf, shape in d["cases"]:
            arch = importlib.import_module(
                f"repro.configs.{{name.split(':')[0]}}").ARCH
            cfg = dataclasses.replace(arch.smoke_config(),
                                      **d["over"].get(name, {{}}))
            if cf is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cf))
            arch = dataclasses.replace(arch, config=cfg)
            mesh = make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:int(np.prod(shape))])
            sc = make_ctx(mesh)
            pre = jsteps.build_step(arch, arch.cell("prefill_32k"), mesh)
            dec = jsteps.build_step(arch, arch.cell("decode_32k"), mesh)
            fpre = jax.jit(lambda p, b: tx.prefill(
                cfg, p, b["tokens"], sc, max_len={MAX_LEN}),
                in_shardings=pre.in_shardings,
                out_shardings=pre.out_shardings)
            fdec = jax.jit(dec.fn, in_shardings=dec.in_shardings,
                           out_shardings=dec.out_shardings)
            p = d["params"][name]
            with mesh:
                logits, cache = fpre(p, {{"tokens": d["prompt"]}})
                res = {{"logits": [np.asarray(logits)],
                        "prefill_cache": whole(cache)}}
                for tok in d["feed"]:
                    logits, cache = fdec(p, {{"tokens": tok,
                                              "cache": cache}})
                    res["logits"].append(np.asarray(logits))
                res["cache"] = whole(cache)
                if name == "llama3_2_1b":
                    try:
                        jax.jit(pre.fn, in_shardings=pre.in_shardings,
                                out_shardings=pre.out_shardings)(
                            p, {{"tokens": d["prompt"]}})
                    except ValueError as e:
                        res["indivisible"] = str(e)
            out[(name, cf, shape)] = res
        pickle.dump(out, open({str(tmp / "out.pkl")!r}, "wb"))
    """)
    payload = {"meshes": MESHES, "cases": _cases(), "params": params,
               "prompt": prompt, "feed": feed, "max_len": MAX_LEN,
               "roundtrip": roundtrip, "roundtrip_cfg": llama}
    try:
        out = {}
        for world in (2, 4):
            out[world] = td.launch("lm_serve", world,
                                   tmp_path_factory.mktemp("lm_serve"),
                                   payload)
    finally:
        ref = td.finish_reference(proc, tmp / "out.pkl")
    plain = {name: _no_mesh(name, params[name], prompt, feed)
             for name in LM + (KV16,)}
    return out, ref, plain, roundtrip


def _ranks(out, shape):
    return out[int(np.prod(shape))]


def _tag(case):
    name, cf, shape = case
    return f"{name}-{'cf100' if cf else 'own_cf'}-d{shape[0]}m{shape[1]}"


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_mesh_serving_matches_reference_plans(served, case):
    """Every call's logits (B, V) and the cache after the prefill and
    after the last decode step within 1e-5 of the reference's meshed
    plans; ``len`` equal."""
    out, ref, _, _ = served
    got, want = _ranks(out, case[2])[0][case], ref[case]
    assert len(got["logits"]) == len(want["logits"]) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert_parity(f"serve.{_tag(case)}.logits{i}", g, w, atol=TOL)
    for which in ("prefill_cache", "cache"):
        assert set(got[which]) == set(want[which])
        for key, w in want[which].items():
            assert_parity(f"serve.{_tag(case)}.{which}.{key}",
                          got[which][key], w,
                          atol=0.0 if key == "len" else TOL)
    assert got["cache"]["len"].tolist() == [S + STEPS] * B


@pytest.mark.parametrize("name,shape", UNDROPPED,
                         ids=[f"{v}-d{s[0]}m{s[1]}" for v, s in UNDROPPED])
def test_mesh_serving_matches_no_mesh_plans(served, name, shape):
    """At capacity factor 100 (no token dropped) the meshed plans compute
    what the no-mesh plans do: logits and caches within 1e-5."""
    out, _, plain, _ = served
    got = _ranks(out, shape)[0][(name, None if name not in MOE else FREE,
                                 shape)]
    want = plain[name]
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert_parity(f"serve.{name}.{shape}.vs_no_mesh.logits{i}", g, w,
                      atol=TOL)
    for which in ("prefill_cache", "cache"):
        for key, w in want[which].items():
            assert_parity(f"serve.{name}.{shape}.vs_no_mesh.{which}.{key}",
                          got[which][key], w,
                          atol=0.0 if key == "len" else TOL)


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_mesh_cache_layout(served, case):
    """The decode plan's cache is placed by ``cache_specs``: the rows over
    ``data``, the sequence over ``model`` (each rank max_len / M
    positions); a whole cache fed to the decode plan is placed there and
    gives the same step, bit for bit."""
    out, _, _, _ = served
    name, _, (n_data, n_model) = case
    got = _ranks(out, case[2])[0][case]
    cfg = _cfgs(name, None)[1]
    assert (name == KV16) == (cfg.n_kv_heads % 16 == 0)
    keys = ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")
    assert got["placements"]["len"] == ["Shard(dim=0)", "Replicate()"]
    for key in keys:
        seq_dim = 2 if cfg.mla is not None else 3
        assert got["placements"][key] == ["Shard(dim=1)",
                                          f"Shard(dim={seq_dim})"]
        shape = got["cache"][key].shape
        want = list(shape)
        want[1], want[seq_dim] = B // n_data, MAX_LEN // n_model
        assert got["local_shapes"][key] == tuple(want)
    assert_parity(f"serve.{_tag(case)}.from_whole_cache", got["from_whole"],
                  got["logits"][1])


@pytest.mark.parametrize("shape", SHAPES[1:], ids=["d2m2", "d1m4"])
@pytest.mark.parametrize("name", MOE)
def test_moe_routing_on_mesh(served, name, shape):
    """Every ``model`` rank of a ``data`` group routes its tokens alike,
    at both capacity factors; at factor 100 each call's expert ids, the
    data groups' rows in order, are the no-mesh plans'.  The own factor
    drops tokens in the prefill (its logits differ from factor 100's)."""
    out, _, plain, _ = served
    ranks = _ranks(out, shape)
    own, free = (ranks[0][(name, cf, shape)]["logits"][0]
                 for cf in (None, FREE))
    assert np.abs(own - free).max() > 1e-3
    n_data, n_model = shape
    for cf in (FREE, None):
        per = []
        for d in range(n_data):
            group = [ranks[d * n_model + m][(name, cf, shape)]["ids"]
                     for m in range(n_model)]
            for other in group[1:]:
                assert len(other) == len(group[0])
                for a, b in zip(other, group[0]):
                    np.testing.assert_array_equal(a, b)
            per.append(group[0])
        if cf == FREE:
            want = plain[name]["ids"]
            assert len(per[0]) == len(want) > 0
            for i, w in enumerate(want):
                got = np.concatenate([p[i].reshape(-1, w.shape[-1])
                                      for p in per])
                np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("shape", SHAPES, ids=["d1m2", "d2m2", "d1m4"])
def test_indivisible_cache_length_raises_like_the_reference(served, shape):
    """The prefill plan without ``max_len`` makes a cache of S = 7
    positions, which no M > 1 splits: the reference's plan raises
    ``ValueError`` (its output sharding), and so does the port's, naming
    the ``model`` axis."""
    out, ref, _, _ = served
    case = ("llama3_2_1b", None, shape)
    assert "divisible" in ref[case]["indivisible"]
    msg = _ranks(out, shape)[0][case]["indivisible"]
    assert "'model'" in msg and "7 positions" in msg, msg


@pytest.mark.parametrize("shape", SHAPES, ids=["d1m2", "d2m2", "d1m4"])
def test_cache_placement_round_trips(served, shape):
    """``place_cache`` gives each rank its rows and positions (torch's
    even chunks) and ``gather_cache`` the whole back; a length that does
    not split over ``model`` raises naming it."""
    out, _, _, whole = served
    ranks = _ranks(out, shape)
    n_data, n_model = shape
    for r, res in enumerate(ranks):
        got = res[("roundtrip", shape)]
        assert got["equal"]
        d, m = divmod(r, n_model)
        for key in ("k", "v"):
            want = np.split(np.split(whole[key], n_data, 1)[d], n_model, 3)[m]
            np.testing.assert_array_equal(got["local"][key], want)
        np.testing.assert_array_equal(got["local"]["len"],
                                      np.split(whole["len"], n_data)[d])
        assert "'model'" in got["indivisible"]


# -- the merge, on one rank ----------------------------------------------------

@pytest.mark.parametrize("cuts", [(), (8,), (5, 11), (3, 8, 20)],
                         ids=["1", "2", "3", "4"])
def test_merge_by_lse_parts_matches_unsplit_decode(cuts):
    """Kernel 8's plain decode on each sequence slice of a cache (its
    offset, its own ``kv_len``), merged by ``merge_by_lse_parts``, equals
    the unsplit decode within 1e-6 with no NaN.  Row 0 sees 6 keys, so
    every slice past its first holds none of them (all masked); row 2
    sees all 24."""
    rng = np.random.default_rng(11)
    b, hq, hkv, s, d = 3, 8, 2, 24, 16
    q = torch.from_numpy(rng.normal(size=(b, hq, 1, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    lens = torch.tensor([6, 17, 24], dtype=torch.int32)
    want = tcm.decode_attention(q, k, v, lens, use_kernel=False)
    bounds = (0,) + cuts + (s,)
    outs, lses = [], []
    for lo, hi in zip(bounds, bounds[1:]):
        o, lse = tcm.decode_attention(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                      lens, use_kernel=False, offset=lo,
                                      return_lse=True)
        outs.append(o)
        lses.append(lse)
        if lo >= 6:                        # row 0 sees nothing here
            assert torch.all(o[0] == 0) and torch.all(lse[0] == NEG_INF)
    got = tcm.merge_by_lse_parts(outs, lses)
    assert not torch.isnan(got).any()
    assert_parity(f"merge_by_lse.{len(outs)}_slices", got, want, atol=1e-6)


def test_merge_by_lse_of_empty_slices_is_zero_and_one_rank_is_identity():
    """Where no slice holds a visible key the merge is 0, not NaN; on an
    axis of one rank (or none) ``merge_by_lse`` returns its input."""
    q = torch.ones((1, 2, 1, 4))
    k = torch.ones((1, 1, 6, 4))
    parts = [flash_attention_plain(q, k[:, :, :3], k[:, :, :3],
                                   kv_len=torch.zeros(1, dtype=torch.int32),
                                   return_lse=True) for _ in range(3)]
    got = tcm.merge_by_lse_parts([p[0] for p in parts], [p[1] for p in parts])
    assert torch.equal(got, torch.zeros_like(got))
    out, lse = parts[0]
    assert tcm.merge_by_lse(out, lse, None, "model") is out
