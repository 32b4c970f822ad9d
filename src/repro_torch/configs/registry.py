"""Architecture registry of the port (counterpart of
``repro.configs.registry``): ``ShapeCell`` and ``ArchSpec`` with the
reference's fields, the LM and recsys shape sets, and ``input_specs`` as
shapes.

Ported: the LM configs (dense ``llama3_2_1b``, ``codeqwen1_5_7b``,
``qwen1_5_110b``; MoE ``qwen3_moe_30b_a3b``; MoE + MLA
``deepseek_v2_236b``), the recsys configs (``dlrm_mlperf``, ``fm``,
``xdeepfm``, ``bert4rec``), the GNN config (``egnn``, with the GNN
shape set: a full graph at Cora and ogbn-products size, a Reddit-scale
sampled minibatch and batched molecules) and the paper's CF config
(``cf_movielens``, with the CF shape set): every config of the
reference.  ``input_specs`` gives ``TensorSpec(shape, dtype)``
stand-ins, as the reference gives ``jax.ShapeDtypeStruct``s: nothing is
allocated.  ``ASSIGNED`` names the reference's 40-cell pool
(``cf_movielens`` is extra); ``all_archs`` and ``all_cells`` walk the
registry as the reference's do.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    step: str                 # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None    # reason, if this cell is not runnable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str                 # lm | gnn | recsys | cf
    config: Any
    optimizer: str
    shapes: Tuple[ShapeCell, ...]
    smoke_config: Callable[[], Any]
    model: str = ""           # recsys model module name

    def cell(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(f"{self.name} has no shape {name!r}")


def lm_shapes(full_attention: bool = True) -> Tuple[ShapeCell, ...]:
    """The LM shape set (reference ``registry.py:55``)."""
    skip = ("pure full-attention arch: 524288-token decode is out of scope "
            "per assignment (no sub-quadratic attention variant); see "
            "DESIGN.md §4" if full_attention else None)
    return (
        ShapeCell("train_4k", "train", {"batch": 256, "seq": 4096}),
        ShapeCell("prefill_32k", "prefill", {"batch": 32, "seq": 32768}),
        ShapeCell("decode_32k", "decode", {"batch": 128, "seq": 32768}),
        ShapeCell("long_500k", "decode", {"batch": 1, "seq": 524288},
                  skip=skip),
    )


GNN_SHAPES = (
    ShapeCell("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeCell("minibatch_lg", "train",
              {"n_nodes": 232965, "n_edges": 114615892,
               "batch_nodes": 1024, "fanout1": 15, "fanout2": 10,
               "d_feat": 602}),
    ShapeCell("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeCell("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 11}),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_048_576}),   # 2^20 ≈ "1M";
              # divides the 512-device mesh exactly (1e6 does not)
)


CF_SHAPES = (
    ShapeCell("fit_ml1m", "cf_fit", {"users": 6144, "items": 3952}),
    ShapeCell("fit_1m_users", "cf_fit", {"users": 1048576, "items": 65536}),
    ShapeCell("predict_bulk", "cf_predict",
              {"users": 1048576, "items": 65536}),
)


def input_specs(arch: ArchSpec, cell: ShapeCell) -> Dict[str, Any]:
    """Model inputs of ``cell`` as ``TensorSpec``s."""
    if arch.kind == "lm":
        return _lm_inputs(arch.config, cell)
    if arch.kind == "gnn":
        return _gnn_inputs(arch.config, cell)
    if arch.kind == "recsys":
        return _recsys_inputs(arch, cell)
    if arch.kind == "cf":
        return _cf_inputs(arch.config, cell)
    raise ValueError(arch.kind)


def _lm_inputs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    b, s = cell.dims["batch"], cell.dims["seq"]
    i32 = torch.int32
    if cell.step == "train":
        return {"tokens": TensorSpec((b, s), i32),
                "labels": TensorSpec((b, s), i32)}
    if cell.step == "prefill":
        return {"tokens": TensorSpec((b, s), i32)}
    if cell.step == "decode":
        # ``init_cache`` on the meta device (GQA k / v, or MLA's c_kv /
        # k_rope latent), as the reference's eval_shape of it
        from repro_torch.models.transformer import init_cache
        cache = init_cache(cfg, b, s, cfg.dtype, device="meta")
        return {"tokens": TensorSpec((b, 1), i32),
                "cache": {key: TensorSpec(tuple(val.shape), val.dtype)
                          for key, val in cache.items()}}
    raise ValueError(cell.step)


def pad_edges(e: int, mult: int = 1024) -> int:
    """Edge lists shard over all 512 devices → pad to a clean multiple.

    Padding edges are (dummy → dummy) self-loops on one extra node whose
    label is -1, so they contribute nothing to the loss."""
    return ((e + mult - 1) // mult) * mult


def _gnn_inputs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    """The EGNN inputs (reference ``registry.py:136``): B graphs for
    ``molecule``; the sampler's padded subgraph for ``minibatch_lg``,
    sized b·(1 + f1 + f1·f2) + 1 nodes (``NeighborSampler.node_budget``
    gives one fewer) and the padded edge budget; else the whole graph
    plus the dummy node, its edges padded by :func:`pad_edges`."""
    d = cell.dims
    f32, i32 = torch.float32, torch.int32
    if cell.name == "molecule":
        b, n, e = d["batch"], d["n_nodes"], d["n_edges"]
        return {"feat": TensorSpec((b, n, d["d_feat"]), f32),
                "coord": TensorSpec((b, n, 3), f32),
                "edges": TensorSpec((b, 2, e), i32),
                "labels": TensorSpec((b, n), i32)}
    if cell.name == "minibatch_lg":
        b = d["batch_nodes"]
        f1, f2 = d["fanout1"], d["fanout2"]
        n_budget = b * (1 + f1 + f1 * f2) + 1
        e_budget = pad_edges(b * (f1 + f1 * f2))
        return {"feat": TensorSpec((n_budget, d["d_feat"]), f32),
                "coord": TensorSpec((n_budget, 3), f32),
                "edges": TensorSpec((2, e_budget), i32),
                "labels": TensorSpec((n_budget,), i32)}
    n, e = d["n_nodes"] + 1, pad_edges(d["n_edges"])
    return {"feat": TensorSpec((n, d["d_feat"]), f32),
            "coord": TensorSpec((n, 3), f32),
            "edges": TensorSpec((2, e), i32),
            "labels": TensorSpec((n,), i32)}


def _recsys_inputs(arch: ArchSpec, cell: ShapeCell) -> Dict[str, Any]:
    """The recsys models' inputs (reference ``registry.py:160``): sparse
    ids (BERT4Rec: item sequences), DLRM's dense features, labels to
    train, candidates to retrieve."""
    cfg = arch.config
    b = cell.dims["batch"]
    if arch.model == "bert4rec":
        base = {"items": TensorSpec((b, cfg.seq_len), torch.int32)}
        if cell.step == "train":
            base["labels"] = TensorSpec((b, cfg.seq_len), torch.int32)
        if cell.step == "retrieval":
            base["candidates"] = TensorSpec((cell.dims["n_candidates"],),
                                            torch.int32)
        return base
    base = {"sparse": TensorSpec((b, cfg.n_sparse), torch.int32)}
    if arch.model == "dlrm":
        base["dense"] = TensorSpec((b, cfg.n_dense), torch.float32)
    if cell.step == "train":
        base["labels"] = TensorSpec((b,), torch.int32)
    if cell.step == "retrieval":
        base["candidates"] = TensorSpec((cell.dims["n_candidates"],),
                                        torch.int32)
    return base


def _cf_inputs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    """The (users, items) f32 rating matrix (reference ``registry.py:180``)."""
    u, i = cell.dims["users"], cell.dims["items"]
    return {"ratings": TensorSpec((u, i), torch.float32)}


# the reference's 40-cell pool (its ``_ARCH_MODULES[:10]``); cf_movielens
# is extra
ASSIGNED = (
    "qwen1_5_110b", "llama3_2_1b", "codeqwen1_5_7b", "qwen3_moe_30b_a3b",
    "deepseek_v2_236b", "egnn", "dlrm_mlperf", "fm", "xdeepfm", "bert4rec",
)

_ARCH_MODULES = ASSIGNED + ("cf_movielens",)


def get_arch(name: str) -> ArchSpec:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{key}").ARCH


def all_archs() -> Dict[str, ArchSpec]:
    """Every registered arch by name, in the reference's order."""
    return {name: get_arch(name) for name in _ARCH_MODULES}


def all_cells(include_skipped: bool = False):
    """Every assigned (arch, shape) pair — the 40-cell grid (less the
    skipped cells unless ``include_skipped``)."""
    out = []
    for name in ASSIGNED:
        arch = get_arch(name)
        for cell in arch.shapes:
            if cell.skip and not include_skipped:
                continue
            out.append((arch, cell))
    return out

