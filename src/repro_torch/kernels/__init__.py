"""Hand-written CUDA kernels of the port (sources under ``csrc/``).

Each kernel module holds the wrapper (launch on CUDA tensors, plain
version on CPU tensors, a ``launches`` count) and its plain PyTorch
version; ``ref.py`` holds the oracles under the reference's names,
``ops.py`` the dispatching entry points and ``_build.py`` compiles and
loads the sources.  Importing builds nothing.
"""

from repro_torch.kernels.cluster import (centroid_distances,
                                         fused_centroid_distances)
from repro_torch.kernels.ops import (embedding_bag, flash_attention,
                                     pairwise_similarity)

__all__ = ["centroid_distances", "embedding_bag", "flash_attention",
           "fused_centroid_distances", "pairwise_similarity"]
