"""The port's examples (``examples/torch_*.py``) on the CPU against the
reference's (``examples/*.py``): each pair runs as subprocesses with the
same arguments, the port's with ``--device cpu``, started together.  The
CF sweep's CSV (``fit_s`` aside) must be equal on the sequential and the
ring engine; ``torch_train_lm`` at a 2-layer d 64 config recovers from an
injected fault and its loss falls.  The quickstart and the serving
example are in ``test_torch_examples_quickstart.py`` and
``test_torch_examples_serve.py``."""

import re
from pathlib import Path

import numpy as np
import torch
from _torch_parity import load_example
from _torch_parity import run_example_pair as run_pair


def _csv(out):
    rows = [line.split(",") for line in out.splitlines()
            if re.match(r"^(jaccard|cosine|pcc),", line)]
    return [r[:2] + r[3:] for r in rows]          # fit_s aside


def test_cf_sweep_matches_reference():
    args = ("--users", "256", "--items", "128", "--topn", "10")
    ref, port, ring = run_pair("train_cf_movielens", args,
                               port_extras=((), ("--engine", "ring")))
    print(ref, port, ring, sep="\n")
    assert len(_csv(ref)) == 3
    assert _csv(port) == _csv(ref)
    assert _csv(ring) == _csv(ref)
    assert "devices=1 engine=ring" in ring


def test_train_lm_recovers_and_learns(tmp_path, capsys):
    torch_train_lm = load_example("torch_train_lm")
    default = Path("/tmp/repro_torch_lm_ckpt")
    before = sorted(default.iterdir()) if default.exists() else None
    ckpt = tmp_path / "ckpt"
    res = torch_train_lm.main(
        ["--steps", "30", "--batch", "4", "--seq", "32",
         "--inject-fault-at", "5", "--ckpt-dir", str(ckpt),
         "--device", "cpu"],
        checkpoint_every=2, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, attn_chunk_q=16, attn_chunk_kv=16,
        xent_chunk=16)
    out = capsys.readouterr().out
    assert res.restarts == 1 and res.final_step == 30
    assert "restarts=1" in out
    # the loop resumed from step 4's checkpoint: steps 4..29 after the fault
    assert len(res.losses) == 5 + 26
    assert all(torch.isfinite(torch.tensor(res.losses)))
    assert sum(res.losses[-10:]) < sum(res.losses[:10])     # the loss falls
    assert sorted(p.name for p in ckpt.iterdir())[-1] == "step_00000030"
    after = sorted(default.iterdir()) if default.exists() else None
    assert after == before                    # nothing written outside
    # the reference's ~100M model: the same fields, f32
    ref_cfg = load_example("train_lm").build_config()
    cfg = torch_train_lm.build_config()
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "tie_embeddings", "remat", "attn_chunk_q",
                  "attn_chunk_kv", "xent_chunk"):
        assert getattr(cfg, field) == getattr(ref_cfg, field), field
    assert cfg.dtype == torch.float32
    assert np.dtype(ref_cfg.dtype) == np.float32
