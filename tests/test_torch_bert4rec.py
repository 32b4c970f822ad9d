"""The port's BERT4Rec (``repro_torch.models.bert4rec``, its config, its
batches and its steps) against the JAX reference on the CPU.

The reference's ``init_params(PRNGKey(0))`` tree at the smoke config,
with its zero biases and unit LayerNorm scales moved by seeded numpy
noise so that every parameter matters, is carried into the port by
``repro_torch.state.bert4rec_from_reference``.  ``encode``,
``serve_scores``, ``retrieval_score`` and ``loss_fn`` (and its gradient)
then run in both packages on the same ids, with an all-padding row and a
half-padded row in the batch.  f32; tolerance 1e-5 (the packages'
matmuls, exp, tanh and rsqrt round differently in the last bits);
batches bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity
from _torch_parity import torch_single_thread  # noqa: F401
from repro.configs import bert4rec as jconf
from repro.configs import registry as jreg
from repro.data import batches as jbatches
from repro.models import bert4rec as jb
from repro_torch.configs import get_arch
from repro_torch.configs.registry import RECSYS_SHAPES, input_specs
from repro_torch.data import batches as tbatches
from repro_torch.launch.steps import build_step
from repro_torch.models import bert4rec as tb
from repro_torch.models import common as tcm
from repro_torch.state import bert4rec_from_reference

TOL = 1e-5


def _pair(seed=0):
    cfg = jconf.smoke_config()
    params = jb.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        last = str(path[-1])
        if "'b'" in last or "'scale'" in last or "'bias'" in last:
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(jitter, params)
    tcfg = get_arch("bert4rec").smoke_config()
    return cfg, params, bert4rec_from_reference(tcfg, params, device="cpu")


def _batch(cfg, b=6, seed=1):
    """``bert4rec_batch`` rows with row 0 all padding and row 1 padded
    over its first half."""
    batch = tbatches.bert4rec_batch(b, cfg.seq_len, cfg.n_items,
                                    cfg.mask_token, seed=seed)
    batch["items"][0] = 0
    batch["labels"][0] = -1
    batch["items"][1, :cfg.seq_len // 2] = 0
    batch["labels"][1, :cfg.seq_len // 2] = -1
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_encode_matches_reference():
    cfg, params, model = _pair()
    batch = _batch(cfg)
    want = jb.encode(cfg, params, jnp.asarray(batch["items"]))
    with torch.no_grad():
        got = tb.encode(model.cfg, model.tree(),
                        torch.from_numpy(batch["items"]))
    assert got.shape == (6, cfg.seq_len, cfg.embed_dim)
    assert bool(torch.isfinite(got).all())        # the all-padding row too
    assert_parity("bert4rec.encode", got, want, atol=TOL)


def test_serve_scores_match_reference():
    cfg, params, model = _pair()
    batch = _batch(cfg)
    batch.pop("labels")
    want = jb.serve_scores(cfg, params, _jax(batch))
    got = model(batch)
    assert got.shape == (6, cfg.vocab)
    assert_parity("bert4rec.serve_scores", got, want, atol=TOL)


@pytest.mark.parametrize("n", [1, 37])
def test_retrieval_score_matches_reference(n):
    cfg, params, model = _pair()
    batch = _batch(cfg, b=2)
    one = {"items": batch["items"][1:2],
           "candidates": tbatches.candidates(n, cfg.vocab, seed=4)}
    want = jb.retrieval_score(cfg, params, _jax(one))
    got = model.retrieval_score(one)
    assert got.shape == (n,)
    assert_parity(f"bert4rec.retrieval.n{n}", got, want, atol=TOL)
    # one row of serve_scores at the candidates' columns
    full = model({"items": one["items"]})[0, torch.from_numpy(
        one["candidates"]).long()]
    assert_parity(f"bert4rec.retrieval_vs_serve.n{n}", got, full, atol=TOL)


def test_loss_and_gradients_match_reference():
    cfg, params, model = _pair()
    batch = _batch(cfg)
    want, jgrads = jax.value_and_grad(
        lambda p: jb.loss_fn(cfg, p, _jax(batch)))(params)
    tree = model.tree()
    for leaf in jax.tree_util.tree_leaves(tree):
        leaf.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    assert_parity("bert4rec.loss", loss.detach(), want, atol=TOL)
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_t = jax.tree_util.tree_leaves(tree)
    assert len(flat_j) == len(flat_t)
    for (path, g), leaf in zip(flat_j, flat_t):
        assert_parity(f"bert4rec.grad{jax.tree_util.keystr(path)}",
                      leaf.grad, g, atol=TOL)


@pytest.mark.parametrize("b,seq,n_items,mask,seed",
                         [(4, 16, 100, 100, 0), (3, 200, 3706, 3706, 9)])
def test_bert4rec_batch_bitwise(b, seq, n_items, mask, seed):
    got = tbatches.bert4rec_batch(b, seq, n_items, mask, seed=seed)
    want = jbatches.bert4rec_batch(b, seq, n_items, mask, seed=seed)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key


def test_config_specs_and_step_plans():
    arch = get_arch("bert4rec")
    assert dataclasses.asdict(arch.config) == dataclasses.asdict(
        jconf.ARCH.config)
    assert dataclasses.asdict(arch.smoke_config()) == dataclasses.asdict(
        jconf.smoke_config())
    assert (arch.kind, arch.optimizer, arch.model) == ("recsys", "adamw",
                                                       "bert4rec")
    assert arch.config.param_count() == jconf.ARCH.config.param_count()
    gen = torch.Generator().manual_seed(0)
    params = tb.init_params(arch.smoke_config(), gen)
    assert tcm.count_params(params) == arch.smoke_config().param_count()
    for cell in RECSYS_SHAPES:
        want = jreg.input_specs(jconf.ARCH, cell)
        got = input_specs(arch, cell)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()}
        assert build_step(arch, cell).example_args == got


def test_steps_serve_retrieve_and_train():
    """``build_step``'s serve (``serve_scores``), retrieval and train
    steps on the smoke model; the train step lowers the loss on its
    batch."""
    cfg, params, model = _pair()
    arch = dataclasses.replace(get_arch("bert4rec"), config=model.cfg)
    batch = _batch(cfg, b=8)
    serve = build_step(arch, dataclasses.replace(arch.cell("serve_p99"),
                                                 dims={"batch": 8}))
    assert_parity("bert4rec.serve_step", serve.fn(model, {
        "items": batch["items"]}), jb.serve_scores(
            cfg, params, _jax({"items": batch["items"]})), atol=TOL)
    ret = build_step(arch, dataclasses.replace(
        arch.cell("retrieval_cand"), dims={"batch": 1, "n_candidates": 9}))
    one = {"items": batch["items"][2:3],
           "candidates": tbatches.candidates(9, cfg.vocab, seed=5)}
    assert_parity("bert4rec.retrieval_step", ret.fn(model, one),
                  jb.retrieval_score(cfg, params, _jax(one)), atol=TOL)
    train = build_step(arch, dataclasses.replace(arch.cell("train_batch"),
                                                 dims={"batch": 8}))
    state = train.optimizer.init(model.tree())
    losses = []
    for _ in range(4):
        model, state, loss = train.fn(model, state, batch)
        losses.append(float(loss))
    assert int(state["step"]) == 4
    assert losses[-1] < losses[0]
