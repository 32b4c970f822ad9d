"""The port's dry run (``repro_torch.launch.dryrun``, the counterpart of
``repro.launch.dryrun``) on the CPU.

One arch of each kind — the dense LM, the MoE LM, EGNN, DLRM and
``cf_movielens`` — at its smoke config, each with its one-device plan
(``--mesh none``) and on a (data 2, model 2) mesh of fake ranks
(``cf_movielens``: one axis of 4), must give complete records.  Every
run happens in a subprocess, because a dry run's default process group is
a fake one and must not outlive it in a test worker.

The smoke Llama's train step counts the matmul flops that its widths
give by hand; its per-device argument bytes on the (2, 2) mesh equal the
reference's ``compiled.memory_analysis().argument_size_in_bytes`` for
the same cell (``repro.launch.dryrun._compile_plan`` on fake XLA
devices, in a subprocess), apart from the leaves named here.  The
``--all`` mode runs each cell in its own process, resumes where
records exist, writes skip records and reports failures.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch import dryrun

SRC = Path(__file__).resolve().parents[1] / "src"
# (shape, dims replaced): small LM batches so the meshes split them
SMOKE = {"llama3_2_1b": ("train_4k", {"batch": 8, "seq": 64}),
         "qwen3_moe_30b_a3b": ("train_4k", {"batch": 8, "seq": 64}),
         "egnn": ("full_graph_sm", None),
         "dlrm_mlperf": ("train_batch", None),
         "cf_movielens": ("fit_ml1m", None)}
MESHES = ("none", "2x2")
KEYS = ("arch", "shape", "variant", "step", "mesh", "n_devices", "trace_s",
        "flops_per_device", "bytes_accessed_per_device", "matmul_flops",
        "memory", "collectives", "collective_bytes_total", "kernels", "ops")

PORT = """
    import json
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for arch, (shape, dims) in SMOKE.items():
        for mesh in MESHES:
            out[f"{arch} {mesh}"] = run_cell(arch, shape, mesh=mesh,
                                             smoke=True, dims=dims)
    print("RECORDS " + json.dumps(out))
"""

REFERENCE = """
    import dataclasses, json
    from repro.launch import dryrun     # fake XLA host devices
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import get_arch
    arch = get_arch("llama3_2_1b")
    arch = dataclasses.replace(arch, config=arch.smoke_config())
    cell = arch.cell("train_4k")
    cell = dataclasses.replace(cell, dims={**cell.dims, "batch": 8,
                                           "seq": 64})
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    ma = dryrun._compile_plan(arch, cell, mesh).memory_analysis()
    print("ARGUMENT " + json.dumps(ma.argument_size_in_bytes))
"""


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": str(SRC) + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _spawn(code):
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())


def _result(proc, tag, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    line = [x for x in out.splitlines() if x.startswith(tag + " ")]
    return json.loads(line[-1][len(tag) + 1:])


@pytest.fixture(scope="module")
def runs():
    """The port's ten smoke records and the reference's argument bytes,
    each from its own subprocess, run side by side."""
    port = _spawn(f"SMOKE = {SMOKE!r}\nMESHES = {MESHES!r}\n"
                  + textwrap.dedent(PORT))
    ref = _spawn(REFERENCE)
    return _result(port, "RECORDS"), _result(ref, "ARGUMENT")


@pytest.mark.parametrize("arch", sorted(SMOKE))
@pytest.mark.parametrize("mesh", MESHES)
def test_smoke_records_are_complete(runs, arch, mesh):
    rec = runs[0][f"{arch} {mesh}"]
    assert all(key in rec for key in KEYS), sorted(rec)
    assert rec["n_devices"] == (1 if mesh == "none" else 4)
    assert rec["mesh"] == mesh
    assert rec["flops_per_device"] > 0 and rec["ops"] > 0
    assert rec["bytes_accessed_per_device"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] >= 0 and mem["output_bytes"] > 0
    total = sum(c["bytes"] for c in rec["collectives"].values())
    assert rec["collective_bytes_total"] == total
    if mesh != "none":
        assert total > 0, rec["collectives"]
    want_kernels = {"llama3_2_1b": {"flash_attention",
                                    "flash_attention_bwd"},
                    "qwen3_moe_30b_a3b": {"flash_attention",
                                          "flash_attention_bwd",
                                          "select_topm"},
                    "cf_movielens": {"fused_similarity"}}.get(arch, set())
    assert set(rec["kernels"]) == want_kernels
    for k in rec["kernels"].values():
        assert k["calls"] > 0 and k["operations"] > 0 and k["bytes"] > 0


def test_llama_matmul_flops_match_the_hand_count(runs):
    """2·T flops a weight a token, three products (forward, dX, dW) a
    weight, the loss's output product four times (its chunked logits are
    recomputed in the backward); attention is kernel 8's, counted apart."""
    rec = runs[0]["llama3_2_1b none"]
    d, hq, hkv, hd, ff, v, layers = 64, 4, 2, 16, 128, 512, 2
    tokens = 8 * 64
    per_layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff
    want = 2 * tokens * (3 * layers * per_layer + 4 * d * v)
    assert rec["matmul_flops"] == pytest.approx(want, rel=0.01)
    # remat is off in the smoke config: one forward and one backward
    # launch of kernel 8 a layer
    assert rec["kernels"]["flash_attention"]["calls"] == layers
    assert rec["kernels"]["flash_attention_bwd"]["calls"] == layers


def test_argument_bytes_match_the_reference(runs):
    """Per device on the (2, 2) mesh: the same parameter, optimizer
    state (an int32 step counter in both) and batch leaves; the port's
    tokens and labels are the global (8, 64) int32 batch on every rank
    (its meshed steps take the global batch), the reference's each
    device's (4, 64) data shard."""
    port = runs[0]["llama3_2_1b 2x2"]["memory"]["argument_bytes"]
    named = {"tokens": 8 * 64 * 4 - 4 * 64 * 4,
             "labels": 8 * 64 * 4 - 4 * 64 * 4}
    assert port - runs[1] == sum(named.values())


def test_all_runs_cells_in_subprocesses(tmp_path):
    """One small cell runs in its own process, a skipped cell gets a skip
    record, a second pass resumes (nothing rerun), ``force`` reruns, and
    a failing cell is reported."""
    cells = [("egnn", "molecule", False), ("llama3_2_1b", "long_500k", True)]
    assert dryrun.run_all(cells, tmp_path, mesh="none") == []
    rec = json.loads((tmp_path / "egnn__molecule.json").read_text())
    assert rec["mesh"] == "none" and rec["flops_per_device"] > 0
    skip = json.loads((tmp_path / "llama3_2_1b__long_500k.json").read_text())
    assert skip["skipped"].startswith("pure full-attention arch")
    stamp = (tmp_path / "egnn__molecule.json").stat().st_mtime_ns
    assert dryrun.run_all(cells, tmp_path, mesh="none") == []
    assert (tmp_path / "egnn__molecule.json").stat().st_mtime_ns == stamp
    assert dryrun.run_all(cells[:1], tmp_path, mesh="none", force=True) == []
    assert (tmp_path / "egnn__molecule.json").stat().st_mtime_ns != stamp
    bad = dryrun.run_all([("egnn", "no_such_shape", False)], tmp_path,
                         mesh="none")
    assert [b[:2] for b in bad] == [("egnn", "no_such_shape")]
    assert not (tmp_path / "egnn__no_such_shape.json").exists()


def test_cell_list_is_the_reference_grid():
    from repro_torch.configs.registry import ASSIGNED
    cells = dryrun._cell_list()
    assert [a for a, _, _ in cells][-3:] == ["cf_movielens"] * 3
    assert {a for a, _, _ in cells} == set(ASSIGNED) | {"cf_movielens"}
    assert sum(skipped for _, _, skipped in cells) == 5
    assert len(cells) == 43


def test_variants():
    from repro_torch.configs.registry import get_arch
    lm = dryrun._apply_variant(get_arch("qwen3_moe_30b_a3b"), "cf1.5")
    assert lm.config.moe.capacity_factor == 1.5
    assert dryrun._apply_variant(get_arch("llama3_2_1b"),
                                 "gatherw_ub4").config.microbatch == 4
    cf = dryrun._apply_variant(get_arch("cf_movielens"), "blk512")
    assert cf.config.block_size == 512
    with pytest.raises(ValueError):
        dryrun._apply_variant(get_arch("egnn"), "ub2")
    with pytest.raises(ValueError):
        dryrun._apply_variant(get_arch("llama3_2_1b"), "bogus")
