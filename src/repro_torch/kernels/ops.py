"""Public entry points for the port's kernels with device dispatch (port of
``repro.kernels.ops``).

``impl`` names the path, one to one with the reference's choices:

==========  =====================================  ======================
port        runs                                   reference
==========  =====================================  ======================
``kernel``  the CUDA kernel (CUDA tensors only;    ``"pallas"``
            CPU tensors raise)
``plain``   the kernel's plain PyTorch version,    ``"pallas_interpret"``
            on any device (the CPU stand-in, as
            interpret mode is the reference's)
``oracle``  the oracle in ``kernels/ref.py``       ``"xla"``
==========  =====================================  ======================

``impl=None`` picks ``kernel`` for CUDA tensors (and for meta tensors,
whose wrappers hand their work to a dry run's counter) and ``oracle``
for CPU tensors, as the reference picks ``"pallas"`` on a TPU and ``"xla"``
elsewhere.  The reference passes any other keyword on to its Pallas
kernel, where all but ``beta`` only set the kernel's tiles (``bm``,
``bn``, ``bk``, ``bq``) or ``interpret``.  The port's kernels tile
themselves, so such a keyword gets no meaning here: it raises
``TypeError``.  ``beta`` (``pcc_sig``'s horizon) is an argument of
:func:`pairwise_similarity` and reaches all three paths.
"""

from __future__ import annotations

import torch

from repro_torch.core.similarity import PCC_SIG_BETA
from repro_torch.kernels import ref
from repro_torch.kernels.embedding_bag import (embedding_bag as _bag_kernel,
                                               embedding_bag_plain)
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _flash_kernel,
                                                 flash_attention_plain)
from repro_torch.kernels.similarity import (fused_similarity as _sim_kernel,
                                            similarity_plain)

IMPLS = ("kernel", "plain", "oracle")
# the kernel wrappers take CUDA tensors, and meta tensors in a dry run
# (``launch/dryrun.py``: meta outputs, the kernel's work counted)
_KERNEL_DEVICES = ("cuda", "meta")


def _resolve(impl: str | None, x: torch.Tensor, kw: dict, what: str) -> str:
    if kw:
        raise TypeError(f"{what}: {sorted(kw)} only tile the reference's "
                        f"Pallas kernel; the port's kernels tile themselves")
    impl = impl or ("kernel" if x.device.type in _KERNEL_DEVICES
                    else "oracle")
    if impl not in IMPLS:
        raise ValueError(f"{what}: unknown impl {impl!r}; want one of "
                         f"{IMPLS}")
    if impl == "kernel" and x.device.type not in _KERNEL_DEVICES:
        raise ValueError(f"{what}: impl='kernel' needs CUDA tensors, got "
                         f"{x.device}")
    return impl


def pairwise_similarity(ra, rb, *, measure="all", impl: str | None = None,
                        beta: float = PCC_SIG_BETA, **kw):
    """Pairwise similarity of two rating blocks (the fused-similarity
    kernel, its plain version or the oracle)."""
    impl = _resolve(impl, ra, kw, "pairwise_similarity")
    if impl == "kernel":
        return _sim_kernel(ra, rb, measure=measure, beta=beta)
    if impl == "plain":
        return similarity_plain(ra, rb, measure=measure, beta=beta)
    return ref.similarity_ref(ra, rb, measure, beta=beta)


def flash_attention(q, k, v, *, causal=True, scale=None,
                    impl: str | None = None, **kw):
    """Causal / full GQA attention (the flash kernel, its plain version or
    the oracle)."""
    impl = _resolve(impl, q, kw, "flash_attention")
    if impl == "kernel":
        return _flash_kernel(q, k, v, causal=causal, scale=scale)
    if impl == "plain":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale)


def embedding_bag(table, indices, *, combiner="sum",
                  impl: str | None = None, **kw):
    """(V, D) table × (B, L) ids (−1 = padding) → (B, D) bags (the
    embedding-bag kernel, its plain version or the oracle)."""
    impl = _resolve(impl, table, kw, "embedding_bag")
    if impl == "kernel":
        return _bag_kernel(table, indices, combiner=combiner)
    if impl == "plain":
        return embedding_bag_plain(table, indices, combiner=combiner)
    return ref.embedding_bag_ref(table, indices, combiner=combiner)
