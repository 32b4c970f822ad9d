"""UserCF — the end-to-end memory-based collaborative-filtering model
(port of ``repro.core.cf_model``).

``fit``       computes top-k neighbors for every user (the paper's
              "training")
``predict``   fills the full rating matrix from neighbors
``evaluate``  reproduces the paper's metric suite on a held-out split
``recommend`` returns the top-n unseen items per user

The engine is selectable: ``sequential`` (one device, the paper's
baseline), ``sharded`` (query users sharded over a mesh axis, the paper's
multi-threading) or ``ring`` (candidate shards rotating around the axis).
All three give identical neighbors by construction.

On CUDA tensors ``sequential`` fits through
:func:`repro_torch.core.engine.kernel_topk` (the hand-written similarity
kernel, as the facade's ``kernel`` backend does) and predicts through the
tile-predict kernel, one launch over every item; on CPU tensors it runs
the plain versions (``topk_neighbors``, the item-tiled predictor).  This
``sequential`` is the paper's single-device engine, not the facade's
plain ``CFEngine(backend="sequential")``.  The mesh engines take a
``DeviceMesh`` (``torch.distributed``) and predict with
``sharded_predict``, as the reference does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import engine, metrics, neighbors, predict
from repro_torch.core.similarity import SIMILARITY_MEASURES, user_means
from repro_torch.device import resolve_device

def as_model_tensor(x, device: torch.device) -> torch.Tensor:
    """A rating matrix as an f32 tensor on ``device``: numpy goes there; a
    tensor on another device type is an error, never a silent copy."""
    if isinstance(x, torch.Tensor):
        if x.device.type != device.type:
            raise ValueError(f"ratings on {x.device} but the model runs on "
                             f"{device}")
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass
class CFConfig:
    measure: str = "pcc"            # jaccard | cosine | pcc | pcc_sig
    top_k: int = 40                 # neighbors per user (paper's top-N)
    engine: str = "sequential"      # sequential | sharded | ring
    block_size: int = 1024          # candidate-block tile height
    relevance_threshold: float = 3.5

    def __post_init__(self):
        if self.measure not in SIMILARITY_MEASURES:
            raise ValueError(f"unknown measure {self.measure!r}")
        if self.engine not in ("sequential", "sharded", "ring"):
            raise ValueError(f"unknown engine {self.engine!r}")


@dataclasses.dataclass
class CFState:
    """Fitted neighbor model (the paper's in-memory similarity structure)."""
    scores: torch.Tensor    # (U, k) f32
    idx: torch.Tensor       # (U, k) int32 global neighbor ids
    means: torch.Tensor     # (U,) f32
    fit_seconds: float = 0.0


class UserCF:
    """The paper's model.  ``mesh`` is required by the ``sharded`` and
    ``ring`` engines; ``device`` (default ``"cuda"``, a missing card
    raises) is where numpy inputs go and tensors must live."""

    def __init__(self, config: CFConfig, mesh=None, *, device="cuda"):
        self.config = config
        self.mesh = mesh
        if config.engine != "sequential" and mesh is None:
            raise ValueError(f"engine={config.engine!r} requires a mesh")
        self.device = resolve_device(device)
        self.state: Optional[CFState] = None

    def _tensor(self, x) -> torch.Tensor:
        return as_model_tensor(x, self.device)

    # -- fit ---------------------------------------------------------------
    def fit(self, ratings) -> CFState:
        cfg = self.config
        r = self._tensor(ratings)
        t0 = time.perf_counter()
        bs = min(cfg.block_size, r.shape[0])
        if cfg.engine == "sequential" and r.is_cuda:
            scores, idx = engine.kernel_topk(r, cfg.top_k,
                                             measure=cfg.measure,
                                             block_size=bs)
        elif cfg.engine == "sequential":
            scores, idx = neighbors.topk_neighbors(
                r, cfg.top_k, measure=cfg.measure, block_size=bs)
        elif cfg.engine == "sharded":
            scores, idx = engine.sharded_topk(
                r, cfg.top_k, self.mesh, measure=cfg.measure,
                block_size=cfg.block_size)
        else:
            scores, idx = engine.ring_sharded_topk(
                r, cfg.top_k, self.mesh, measure=cfg.measure,
                block_size=cfg.block_size)
        if r.is_cuda:
            torch.cuda.synchronize(r.device)
        dt = time.perf_counter() - t0
        self.state = CFState(scores=scores, idx=idx, means=user_means(r),
                             fit_seconds=dt)
        return self.state

    # -- predict -----------------------------------------------------------
    def predict(self, ratings) -> torch.Tensor:
        """(U, I) predictions: through the tile-predict kernel on the card
        (one launch over every item, bit for bit the one-shot form), the
        plain item tiles on the CPU, ``sharded_predict`` with a mesh."""
        if self.state is None:
            raise RuntimeError("call fit() first")
        st = self.state
        r = self._tensor(ratings)
        if self.config.engine == "sequential" or self.mesh is None:
            return predict.predict_from_neighbors_blocked(
                r, st.scores, st.idx, means=st.means,
                gather_src=predict.make_gather_source(r), use_kernel=True)
        return engine.sharded_predict(r, st.scores, st.idx, self.mesh)

    # -- evaluate ----------------------------------------------------------
    def evaluate(self, train, test, topn: int = 10) -> Dict[str, float]:
        """The paper's metric suite (MAE, RMSE, Eqs. 4-6 precision /
        recall / F1 with the confusion counts) on the held-out ratings,
        and the top-``topn`` list's precision / recall / F1."""
        train, test = self._tensor(train), self._tensor(test)
        pred = self.predict(train)
        test_mask = test > 0
        out = {"mae": metrics.mae(pred, test, test_mask),
               "rmse": metrics.rmse(pred, test, test_mask)}
        out.update(metrics.precision_recall_f1(
            pred, test, threshold=self.config.relevance_threshold,
            mask=test_mask))
        ranked = metrics.topn_precision_recall(
            pred, test, train > 0, topn,
            threshold=self.config.relevance_threshold)
        out.update({f"top{topn}_{k}": v for k, v in ranked.items()})
        return {k: float(v) for k, v in out.items()}

    # -- recommend ---------------------------------------------------------
    def recommend(self, ratings, n: int = 10):
        """(scores, item ids), each (U, n): the top-n unseen items."""
        r = self._tensor(ratings)
        return predict.recommend_topn(self.predict(r), r > 0, n)
