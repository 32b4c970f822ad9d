"""Device resolution and numeric switches for the PyTorch/CUDA port.

Every entry point (``CFEngine``, ``BatchingServer``, ``launch.serve``)
takes ``device=`` and defaults to ``"cuda"``.  A missing card is an error,
never a quiet CPU run: the CPU is used only when the caller asks for it
(``device="cpu"``), as the parity tests do.

The reference computes every Gram product in f32 at
``Precision.HIGHEST``; TF32 would keep ~3 decimal digits, so both TF32
switches are pinned off here, explicitly, at import.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE, *,
                   allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no card is present (no silent CPU fallback).  ``"meta"`` (shapes and
    dtypes, no data) is taken only with ``allow_meta``, which the dry run
    (``launch/dryrun.py``) passes when it asks for meta by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain CPU path")
    if dev.type == "meta" and allow_meta:
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; want cuda or cpu")
    return dev
