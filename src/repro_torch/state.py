"""Carry a fitted engine's state across from the JAX reference.

``repro.core.facade.CFEngine.state()`` returns a dict of host (numpy)
arrays — ratings, cached top-k scores and ids, means, the rated-count /
rating-sum sufficient statistics, and a ``meta`` version stamp.
:func:`from_reference_state` turns that dict into the port's tensors on a
device; ``repro_torch.core.facade.CFEngine.load_state`` accepts either
form.  This is how a model fitted by the reference is served by the port.
An approx-mode tree also carries the reference ``ClusteredIndex.state()``
subtree under ``"index"`` (basis, centroids, counts, meta, proxies,
spill_dist, spill_ids, sums) and, with ``recommend_mode="approx"``, the
``ItemClusteredIndex.state()`` subtree under ``"item_index"`` (the same
keys plus has_pos, item_meta, profiles); both pass through as host
arrays, and a subtree that lacks a key raises.

:func:`transformer_from_reference` does the same for the LM family: the
reference's ``repro.models.transformer.init_params`` tree (host arrays)
becomes the port's ``Transformer`` module on a device, so both packages
compute on the same weights.  :func:`recsys_from_reference` does it for
the recsys models (DLRM, FM, xDeepFM and BERT4Rec — also
:func:`bert4rec_from_reference`), whose trees hold lists too (xDeepFM's
``"cin"``, BERT4Rec's ``"blocks"``), and :func:`egnn_from_reference` for
EGNN (its ``"layers"`` list).  :func:`opt_state_from_reference`
and :func:`opt_state_to_numpy` carry an optimizer state tree across
(``{"step", "m", "v"}``, ``{"step", "acc"}``, ``{"step"[, "mu"]}``), so
both packages train from one state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

_DTYPES = {"ratings": torch.float32, "scores": torch.float32,
           "idx": torch.int32, "means": torch.float32, "cnt": torch.int32,
           "tot": torch.float32}
INDEX_KEYS = ("basis", "centroids", "counts", "meta", "proxies",
              "spill_dist", "spill_ids", "sums")
ITEM_INDEX_KEYS = INDEX_KEYS + ("has_pos", "item_meta", "profiles")


def _host(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy().copy()
    return np.array(val)


def _subtree(tree: dict, name: str, keys) -> Dict[str, np.ndarray]:
    """``tree[name]`` as host arrays (empty when absent or empty); a
    partial subtree raises."""
    sub = tree.get(name) or {}
    missing = [key for key in keys if sub and key not in sub]
    if missing:
        raise ValueError(f"state[{name!r}] lacks {missing}")
    return {key: _host(sub[key]) for key in keys if sub}


def from_reference_state(tree: dict, device="cuda") -> Dict[str, object]:
    """Reference ``CFEngine.state()`` tree → the port's tensors on
    ``device`` (plus ``"version"``, the ratings version as an int, and
    ``"index"`` / ``"item_index"``, the clustered indexes' subtrees as
    host arrays — empty when the engine has no such index)."""
    dev = resolve_device(device)
    out: Dict[str, object] = {}
    for key, dtype in _DTYPES.items():
        val = tree[key]
        if isinstance(val, torch.Tensor):
            out[key] = val.to(device=dev, dtype=dtype)
        else:
            out[key] = torch.as_tensor(np.array(val)).to(device=dev,
                                                          dtype=dtype)
    meta = tree["meta"]
    if isinstance(meta, torch.Tensor):
        meta = meta.cpu().numpy()
    out["version"] = int(np.asarray(meta).reshape(-1)[0])
    out["index"] = _subtree(tree, "index", INDEX_KEYS)
    out["item_index"] = _subtree(tree, "item_index", ITEM_INDEX_KEYS)
    u = out["ratings"].shape[0]
    k = out["scores"].shape[1]
    want = {"scores": (u, k), "idx": (u, k), "means": (u,), "cnt": (u,),
            "tot": (u,)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise ValueError(f"state[{key!r}] has shape "
                             f"{tuple(out[key].shape)}, want {shape}")
    return out


def _tensor_tree(tree, dev):
    if isinstance(tree, dict):
        return {key: _tensor_tree(val, dev) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensor_tree(val, dev) for val in tree]
    arr = _host(tree)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)       # bf16 host arrays (ml_dtypes)
    return torch.from_numpy(np.array(arr, order="C")).to(dev)  # keeps 0-d


def transformer_from_reference(cfg, params: dict, device="cuda",
                               use_kernel: bool = True):
    """Reference transformer parameter tree (nested dict of host or jax
    arrays, f32, layers stacked on axis 0) → the port's ``Transformer``
    on ``device`` with the same parameter names and values: the dense
    GQA tree, the MLA attention's and the MoE FFN's (3-D expert tensors,
    the router, the shared experts) in the ``dense_layers`` and
    ``moe_layers`` stacks alike."""
    from repro_torch.models.transformer import Transformer
    dev = resolve_device(device)
    return Transformer(cfg, _tensor_tree(params, dev), use_kernel=use_kernel)


def recsys_from_reference(cfg, params: dict, device="cuda"):
    """Reference recsys parameter tree (nested dicts and lists of host or
    jax arrays, f32) → the port's model for ``cfg`` (``DLRMConfig`` →
    ``DLRM``, ``FMConfig`` → ``FM``, ``XDeepFMConfig`` → ``XDeepFM``,
    ``BERT4RecConfig`` → ``BERT4Rec``) on ``device`` with the same
    parameter paths and values."""
    from repro_torch.models import bert4rec, dlrm, fm, xdeepfm
    models = {dlrm.DLRMConfig: dlrm.DLRM, fm.FMConfig: fm.FM,
              xdeepfm.XDeepFMConfig: xdeepfm.XDeepFM,
              bert4rec.BERT4RecConfig: bert4rec.BERT4Rec}
    if type(cfg) not in models:
        raise TypeError(f"no recsys model of the port for {type(cfg)}")
    dev = resolve_device(device)
    return models[type(cfg)](cfg, _tensor_tree(params, dev))


def bert4rec_from_reference(cfg, params: dict, device="cuda"):
    """Reference BERT4Rec parameter tree → the port's ``BERT4Rec`` on
    ``device`` (:func:`recsys_from_reference` for a ``BERT4RecConfig``)."""
    from repro_torch.models.bert4rec import BERT4RecConfig
    if not isinstance(cfg, BERT4RecConfig):
        raise TypeError(f"need a BERT4RecConfig, got {type(cfg)}")
    return recsys_from_reference(cfg, params, device)


def egnn_from_reference(cfg, params: dict, device="cuda"):
    """Reference EGNN parameter tree (``embed_in``, ``layers`` — a list of
    {phi_e, phi_x, phi_h} MLPs — and ``readout``, host or jax arrays,
    f32) → the port's ``EGNN`` for ``cfg`` on ``device`` with the same
    parameter paths and values."""
    from repro_torch.models.egnn import EGNN, EGNNConfig
    if not isinstance(cfg, EGNNConfig):
        raise TypeError(f"need an EGNNConfig, got {type(cfg)}")
    return EGNN(cfg, _tensor_tree(params, resolve_device(device)))


_OPT_KEYS = ({"step", "m", "v"}, {"step", "acc"}, {"step"},
             {"step", "mu"})


def opt_state_from_reference(state: dict, device="cuda"):
    """A reference optimizer state tree (host or jax arrays) → tensors on
    ``device`` in the same structure (``step`` an int32 0-d tensor)."""
    if set(state) not in _OPT_KEYS:
        raise ValueError(f"not an optimizer state: keys {sorted(state)}")
    return _tensor_tree(state, resolve_device(device))


def opt_state_to_numpy(state):
    """An optimizer state tree (or any tree of tensors) → numpy arrays in
    the same structure, for the reference's ``update``."""
    if isinstance(state, dict):
        return {key: opt_state_to_numpy(val) for key, val in state.items()}
    if isinstance(state, (list, tuple)):
        return [opt_state_to_numpy(val) for val in state]
    return _host(state)
