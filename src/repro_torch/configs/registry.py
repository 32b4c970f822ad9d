"""Architecture registry of the port (counterpart of
``repro.configs.registry``): ``ShapeCell`` and ``ArchSpec`` with the
reference's fields, the LM and recsys shape sets, and ``input_specs`` as
shapes.

Ported: the LM configs (dense ``llama3_2_1b``, ``codeqwen1_5_7b``,
``qwen1_5_110b``; MoE ``qwen3_moe_30b_a3b``; MoE + MLA
``deepseek_v2_236b``), the recsys configs (``dlrm_mlperf``, ``fm``,
``xdeepfm``, ``bert4rec``) and the paper's CF config (``cf_movielens``,
with the CF shape set); the GNN family raises ``NotImplementedError``
naming its ROADMAP item.  ``input_specs`` gives
``TensorSpec(shape, dtype)`` stand-ins, as the reference gives
``jax.ShapeDtypeStruct``s: nothing is allocated.  ``ASSIGNED`` names the
reference's 40-cell pool (``cf_movielens`` is extra).
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
    """Model inputs of ``cell`` as ``TensorSpec``s (the LM, recsys and CF
    families)."""
    if arch.kind == "lm":
        return _lm_inputs(arch.config, cell)
    if arch.kind == "recsys":
        return _recsys_inputs(arch, cell)
    if arch.kind == "cf":
        return _cf_inputs(arch.config, cell)
    raise NotImplementedError(
        f"{arch.kind} inputs are not ported yet (ROADMAP Queue 1 item "
        f"11, egnn)")


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

_PORTED = ("llama3_2_1b", "codeqwen1_5_7b", "qwen1_5_110b",
           "qwen3_moe_30b_a3b", "deepseek_v2_236b", "dlrm_mlperf", "fm",
           "xdeepfm", "bert4rec", "cf_movielens")
_WAITING = {
    "egnn": "the GNN family (ROADMAP Queue 1 item 11, egnn)",
}


def get_arch(name: str) -> ArchSpec:
    key = name.replace("-", "_").replace(".", "_")
    if key in _WAITING:
        raise NotImplementedError(f"{name}: not ported yet — {_WAITING[key]}")
    if key not in _PORTED:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{key}").ARCH

