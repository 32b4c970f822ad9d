"""Carry a fitted engine's state across from the JAX reference.

``repro.core.facade.CFEngine.state()`` returns a dict of host (numpy)
arrays — ratings, cached top-k scores and ids, means, the rated-count /
rating-sum sufficient statistics, and a ``meta`` version stamp.
:func:`from_reference_state` turns that dict into the port's tensors on a
device; ``repro_torch.core.facade.CFEngine.load_state`` accepts either
form.  This is how a model fitted by the reference is served by the port.
An approx-mode tree also carries the reference ``ClusteredIndex.state()``
subtree under ``"index"`` (basis, centroids, counts, meta, proxies,
spill_dist, spill_ids, sums), which passes through as host arrays.
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


def _host(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy().copy()
    return np.array(val)


def from_reference_state(tree: dict, device="cuda") -> Dict[str, object]:
    """Reference ``CFEngine.state()`` tree → the port's tensors on
    ``device`` (plus ``"version"``, the ratings version as an int, and
    ``"index"``, the clustered index's subtree as host arrays — empty in
    exact mode).

    Item-index state (``recommend_mode="approx"``) is not ported yet; a
    tree that carries it raises ``NotImplementedError``.
    """
    if tree.get("item_index"):
        raise NotImplementedError(
            "item-index state is not ported yet (ROADMAP Queue 1 item 8); "
            "carry an engine without recommend_mode='approx'")
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
    index = tree.get("index") or {}
    missing = [key for key in INDEX_KEYS if index and key not in index]
    if missing:
        raise ValueError(f"state['index'] lacks {missing}")
    out["index"] = {key: _host(index[key]) for key in INDEX_KEYS
                    if index}
    u = out["ratings"].shape[0]
    k = out["scores"].shape[1]
    want = {"scores": (u, k), "idx": (u, k), "means": (u,), "cnt": (u,),
            "tot": (u,)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise ValueError(f"state[{key!r}] has shape "
                             f"{tuple(out[key].shape)}, want {shape}")
    return out
