"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and public names so each counterpart is easy to find, and
never imports ``jax`` or ``repro``.  Ported so far: the exact CF main path
(``core`` similarity → streaming top-k → tile prediction → top-n unseen,
the ``CFEngine`` facade, the supervised ``BatchingServer``), the
approximate user index and the two-stage item index (``index``:
``CFEngine(neighbor_mode="approx")`` / ``recommend_mode="approx"``), and
the LM family's prefill → decode serving path for dense GQA configs and
the recsys CTR models' serving and retrieval steps (DLRM, FM, xDeepFM)
(``models``, ``configs``, ``launch.steps``), with hand-written CUDA
kernels under ``csrc/`` and their dispatching entry points in
``kernels.ops``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
