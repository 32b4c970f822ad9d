"""The port's op cost model (``repro_torch.launch.op_cost``, the
counterpart of ``repro.launch.hlo_cost``) and the hand kernels' meta
branches, on the CPU.

The first five tests are ``tests/test_hlo_cost.py``'s at its shapes and
its expected numbers: a matmul's flops, a loop's (16 steps, then 8 × 4
nested), bytes that scale with the tensor and collectives inside a loop
(under a fake process group of 8 ranks, in a subprocess, so that no
default group outlives it).  Eager loops dispatch each iteration, so the
counts are exact.

Then each hand kernel's wrapper on meta tensors at one small shape:
outputs of the plain version's shapes and dtypes, the kernel module's
``work`` equal to a count written here by hand (the count ``PERF.md``'s
bound column divides) and handed to the counter as one op, the wrapper's
``launches`` and ``routes`` untouched, and the same wrapper on CPU
tensors still giving its plain version's values bit for bit.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cluster, predict, rerank, select
from repro_torch.kernels import similarity, support
from repro_torch.launch.op_cost import OpCounter, analyze

# the package names its ``ops`` functions ``embedding_bag`` and
# ``flash_attention``; these are the kernel modules
embedding_bag = importlib.import_module("repro_torch.kernels.embedding_bag")
flash_attention = importlib.import_module(
    "repro_torch.kernels.flash_attention")

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_matmul_flops_exact():
    r = analyze(lambda a, b: a @ b, _meta(512, 1024), _meta(1024, 256))
    assert r["flops"] == 2 * 512 * 1024 * 256
    assert r["matmul_flops"] == r["flops"]
    assert r["bytes"] == (512 * 1024 + 1024 * 256 + 512 * 256) * 4


def test_scan_multiplies_trip_count():
    def g(w, x):
        h = x
        for _ in range(16):
            h = torch.tanh(h @ w)
        return h.sum()
    r = analyze(g, _meta(256, 256), _meta(64, 256))
    want = 16 * 2 * 64 * 256 * 256
    assert r["matmul_flops"] == want
    assert r["flops"] == pytest.approx(want, rel=0.05)


def test_nested_scan():
    def g(w, x):
        h = x
        for _ in range(8):
            for _ in range(4):
                h = h @ w
        return h.sum()
    r = analyze(g, _meta(64, 64), _meta(16, 64))
    want = 8 * 4 * 2 * 16 * 64 * 64
    assert r["matmul_flops"] == want
    assert r["flops"] == pytest.approx(want, rel=0.1)


def test_bytes_scale_with_tensor_size():
    r1 = analyze(lambda a: a * 2.0, _meta(1024, 1024))
    r2 = analyze(lambda a: a * 2.0, _meta(2048, 1024))
    assert r2["bytes"] == 2 * r1["bytes"]
    assert r1["bytes"] == 2 * 1024 * 1024 * 4


def test_collectives_counted_inside_loops():
    """Ten all-reduces inside a loop count ten times, and a known
    sequence of every other kind — the ``torch.distributed`` calls the
    port makes and a DTensor redistribution — is counted in full, with
    each output's bytes."""
    code = """
        import json
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.op_cost import analyze
        dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                                rank=0, world_size=8)
        mesh = make_local_mesh((8,), ("d",), device="meta")
        group = mesh.get_group("d")

        def f(x):
            h = x
            for _ in range(10):
                dist.all_reduce(h, group=group)
                h = h * 0.125
            parts = [torch.empty_like(h) for _ in range(8)]
            dist.all_gather(parts, h, group=group)
            out = torch.empty((8 * 32, 64), device=h.device)
            dist.all_gather_into_tensor(out, h, group=group)
            rs = torch.empty((4, 64), device=h.device)
            dist.reduce_scatter_tensor(rs, h, group=group)
            a2a = torch.empty_like(h)
            dist.all_to_all_single(a2a, h, group=group)
            d = DTensor.from_local(h, mesh, [Shard(0)], run_check=False)
            whole = d.redistribute(mesh, [Replicate()]).to_local()
            return whole
        r = analyze(f, torch.empty((32, 64), device="meta"))
        print("COLL", json.dumps(r["collectives"]))
        dist.destroy_process_group()
    """
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("COLL ")]
    got = json.loads(line[0][5:])
    per = 32 * 64 * 4
    assert got["all-reduce"] == {"count": 10, "bytes": 10 * per}
    # list all-gather, all_gather_into_tensor, DTensor's Shard → Replicate
    assert got["all-gather"] == {"count": 3, "bytes": 3 * 8 * per}
    assert got["reduce-scatter"] == {"count": 1, "bytes": per / 8}
    assert got["all-to-all"] == {"count": 1, "bytes": per}


# -- the hand kernels' meta branches -----------------------------------------

def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _ints(rng, hi, *shape, dtype=torch.int32):
    return torch.from_numpy(rng.integers(0, hi, shape)).to(dtype)


def _case_similarity(rng):
    ra = torch.from_numpy(rng.integers(0, 6, (6, 40)).astype(np.float32))
    rb = torch.from_numpy(rng.integers(0, 6, (5, 40)).astype(np.float32))
    kw = {"measure": "pcc"}
    # six Gram products: 12·m·n·D; both blocks and the (m, n) f32 out
    hand = (12 * 6 * 5 * 40, 6 * 40 * 4 + 5 * 40 * 4 + 6 * 5 * 4)
    return (similarity.fused_similarity, (ra, rb), kw,
            lambda: similarity.similarity_plain(ra, rb, **kw),
            similarity.work(ra, rb, "pcc"), hand)


def _case_predict(rng):
    src = torch.from_numpy(rng.integers(0, 6, (10, 20)).astype(np.float32))
    ids = _ints(rng, 10, 3, 4)
    w, nbm, qm = _rand(rng, 3, 4), _rand(rng, 3, 4), _rand(rng, 3)
    args = (src, ids, w, nbm, qm, 2, 12)
    # 10 of the 10 rows (min(m·k, U)) over T = 10 items at 4 bytes, ids /
    # w / means 4 bytes a slot, q_means, the (3, 10) out; 4 ops a term
    # (3·4·10 terms) and 5 an output
    hand = (4 * 3 * 4 * 10 + 5 * 3 * 10,
            10 * 10 * 4 + 3 * 4 * 4 * 3 + 3 * 4 + 3 * 10 * 4)
    return (predict.fused_tile_predict, args, {},
            lambda: predict.tile_predict_plain(*args),
            predict.work(src, ids, 2, 12), hand)


def _case_cluster(rng):
    x, c = _rand(rng, 7, 16), _rand(rng, 3, 16)
    hand = (2 * 7 * 3 * 16 + 2 * (7 + 3) * 16 + 3 * 7 * 3,
            ((7 + 3) * 16 + 7 * 3) * 4)
    return (cluster.fused_centroid_distances, (x, c), {},
            lambda: cluster.centroid_distances_plain(x, c),
            cluster.work(x, c), hand)


def _case_scan(rng):
    q, p = _rand(rng, 4, 8), _rand(rng, 20, 8)
    q_ids = torch.arange(4, dtype=torch.int32)
    hand = (2 * 4 * 20 * 8, (4 + 20) * 8 * 4 + 4 * 4 + 4 * 5 * 8)
    return (select.fused_scan_topm, (q, p, q_ids), {"m": 5},
            lambda: select.scan_topm_plain(q, p, q_ids, 5),
            select.scan_work(q, p, 5), hand)


def _case_select(rng):
    sc = _rand(rng, 4, 20)
    q_ids = torch.full((4,), -1, dtype=torch.int32)
    hand = (4 * 20, 4 * 20 * 4 + 4 * 4 + 4 * 5 * 8)
    return (select.select_topm, (sc, q_ids), {"m": 5},
            lambda: select.select_topm_twin(sc, q_ids, m=5),
            select.select_work(sc, 5), hand)


def _case_rerank(rng):
    qv = torch.from_numpy(rng.integers(0, 6, (3, 12)).astype(np.float32))
    cr = torch.from_numpy(rng.integers(0, 6, (5, 12)).astype(np.float32))
    norms, counts = _rand(rng, 5).abs(), _rand(rng, 5).abs()
    kw = {"measure": "pcc"}
    hand = (12 * 3 * 5 * 12, 3 * 12 * 4 + 5 * 12 * 4 + 5 * 8 + 3 * 5 * 4)
    return (rerank.fused_rerank_scores, (qv, cr, norms, counts), kw,
            lambda: rerank.rerank_scores_plain(qv, cr, norms, counts, **kw),
            rerank.work(qv, cr, "pcc"), hand)


def _case_support(rng):
    dev, msk = _rand(rng, 6, 9), (_rand(rng, 6, 9) > 0).float()
    ids, w, qm = _ints(rng, 6, 2, 3), _rand(rng, 2, 3), _rand(rng, 2)
    args = (dev, msk, ids, w, qm)
    # "table" route: 6 rows of two (9,) f32 tables, 8 bytes a slot, the
    # query means, the (2, 9) out; 4 ops a term (2·3·9) and 5 an output
    hand = (4 * 2 * 3 * 9 + 5 * 2 * 9,
            6 * 2 * 9 * 4 + 2 * 3 * 8 + 2 * 4 + 2 * 9 * 4)
    return (support.fused_support_scores, args, {},
            lambda: support.support_scores_plain(*args),
            support.work(dev, msk, ids), hand)


def _case_flash(rng):
    q, k, v = _rand(rng, 1, 4, 6, 8), _rand(rng, 1, 2, 6, 8), \
        _rand(rng, 1, 2, 6, 8)
    # causal 6 × 6: 21 visible pairs a head, 2·(d + dv) each; q, out and
    # k, v once
    hand = (2 * (8 + 8) * 21 * 4, (4 * 6 * 16 + 2 * 6 * 16) * 4)
    return (flash_attention.flash_attention, (q, k, v), {},
            lambda: flash_attention.flash_attention_plain(q, k, v),
            flash_attention.work(q, k, v), hand)


def _case_bag(rng):
    table, ids = _rand(rng, 10, 4), _ints(rng, 10, 3, 2, dtype=torch.int64)
    hand = (6 * 4, (6 * 4 + 3 * 4) * 4 + 6 * 8)
    return (embedding_bag.embedding_bag, (table, ids), {},
            lambda: embedding_bag.embedding_bag_plain(table, ids),
            embedding_bag.work(table, ids), hand)


def _case_flash_bwd(rng):
    q, k, v = _rand(rng, 1, 4, 6, 8), _rand(rng, 1, 2, 6, 8), \
        _rand(rng, 1, 2, 6, 8)
    o, lse = flash_attention.flash_attention_plain(q, k, v, return_lse=True)
    do = _rand(rng, 1, 4, 6, 8)
    args = (q, k, v, o, do, lse)
    # five products, 2·(3·d + 2·dv) a visible pair and head; q, o, dO, dQ
    # and k, v, dK, dV once
    hand = (2 * (3 * 8 + 2 * 8) * 21 * 4, (4 * 6 + 2 * 6) * 32 * 4)
    return (flash_attention.flash_attention_bwd, args, {},
            lambda: flash_attention.flash_attention_bwd_plain(*args),
            flash_attention.bwd_work(q, k, v), hand)


CASES = {"fused_similarity": _case_similarity,
         "fused_tile_predict": _case_predict,
         "fused_centroid_distances": _case_cluster,
         "fused_scan_topm": _case_scan, "select_topm": _case_select,
         "fused_rerank_scores": _case_rerank,
         "fused_support_scores": _case_support,
         "flash_attention": _case_flash, "embedding_bag": _case_bag,
         "flash_attention_bwd": _case_flash_bwd}


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_meta_branch(name):
    fn, args, kw, plain, work, hand = CASES[name](np.random.default_rng(0))
    assert work == pytest.approx(hand, rel=0, abs=0)
    launches = fn.launches
    routes = dict(getattr(fn, "routes", {}))
    meta_args = tuple(a.to(META) if isinstance(a, torch.Tensor) else a
                      for a in args)
    with OpCounter() as counter:
        got = fn(*meta_args, **kw)
    want = plain()
    assert [(t.shape, t.dtype, t.device.type) for t in _outs(got)] == \
        [(t.shape, t.dtype, "meta") for t in _outs(want)]
    assert counter.cost.kernels == {name: {"calls": 1,
                                           "operations": float(hand[0]),
                                           "bytes": float(hand[1])}}
    assert counter.cost.flops >= hand[0]
    assert fn.launches == launches
    assert dict(getattr(fn, "routes", {})) == routes
    # the CPU path is the plain version, bit for bit
    cpu = fn(*args, **kw)
    for a, b in zip(_outs(cpu), _outs(want)):
        assert torch.equal(a, b)
    assert fn.launches == launches


def test_meta_workspaces_count_in_the_peak():
    """The split decode's f32 workspace and the backward's Δ are live
    during their calls, so they reach the peak."""
    q = _meta(2, 8, 1, 64, dtype=torch.bfloat16)
    k = _meta(2, 2, 1000, 64, dtype=torch.bfloat16)
    with OpCounter() as counter:
        out = flash_attention.flash_attention(q, k, k)
    assert flash_attention.route(q, k) == "split"
    splits = -(-1000 // 128)
    ws = 2 * 2 * splits * 16 * (64 + 2) * 4
    assert counter.cost.peak_bytes >= ws + out.numel() * 2
    q, k, lse = _meta(1, 2, 6, 8), _meta(1, 2, 6, 8), _meta(1, 2, 6)
    with OpCounter() as counter:
        flash_attention.flash_attention_bwd(q, k, k, q, q, lse)
    # dq, dk, dv (3 · 384 bytes) and Δ (48 bytes), each a 512-byte block
    assert counter.cost.peak_bytes == 4 * 512


def test_inference_mode_counts_composite_ops():
    """Under ``torch.inference_mode`` a composite op (``matmul``, ``to``)
    reaches the counter whole; it is counted as the ops it runs."""
    a, b = _meta(4, 8, 16), _meta(16, 32)
    with torch.inference_mode():
        r = analyze(lambda x, y: (x @ y).to(torch.bfloat16), a, b)
    assert r["matmul_flops"] == 2 * 4 * 8 * 16 * 32
    assert r["flops"] == r["matmul_flops"] + 4 * 8 * 32


def test_work_takes_the_counts_the_data_sets():
    """Where the bound counts what the data needs (``PERF.md``: the rated
    terms and distinct rows of kernels 2 and 7, kernel 9's valid and
    distinct ids, a decode's cache length), ``work`` takes those counts;
    without them it counts the most a call can need."""
    src, ids = _meta(100, 50), _meta(8, 4, dtype=torch.int32)
    # 5 distinct rows of 20 items (f32), 30 rated terms, the (8, 20) out
    assert predict.work(src, ids, 10, 30, rows_read=5, terms=30) == (
        4 * 30 + 5 * 8 * 20, 5 * 20 * 4 + 8 * 4 * 4 * 3 + 8 * 4 + 8 * 20 * 4)
    r8, means = _meta(100, 50, dtype=torch.int8), _meta(100)
    width = support.support_width(50)
    assert support.work(r8, means, ids, rows_read=5, terms=30) == (
        4 * 30 + 5 * 8 * width,
        5 * (50 + 4) + 8 * 4 * 8 + 8 * 4 + 8 * width * 4)
    table, bags = _meta(1000, 16), _meta(8, 10, dtype=torch.int32)
    assert embedding_bag.work(table, bags, distinct=12, n_valid=40) == (
        40 * 16, (12 * 16 + 8 * 16) * 4 + 8 * 10 * 4)
    q = _meta(4, 32, 1, 64, dtype=torch.bfloat16)
    k = _meta(4, 8, 2080, 64, dtype=torch.bfloat16)
    # a decode at kv_len 2049: phase 12's decode bound
    assert flash_attention.work(q, k, k, kv_len=2049) == (
        4.0 * 4 * 32 * 2049 * 64,
        (2 * 4 * 8 * 2049 * 64 + 2 * 4 * 32 * 64) * 2.0)
