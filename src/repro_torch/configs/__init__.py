"""Per-architecture configs of the port (the reference's published
numbers) and the shape registry."""

from repro_torch.configs.registry import (ASSIGNED, ArchSpec, ShapeCell,
                                          TensorSpec, all_archs, all_cells,
                                          get_arch, input_specs)

__all__ = ["ASSIGNED", "ArchSpec", "ShapeCell", "TensorSpec", "all_archs",
           "all_cells", "get_arch", "input_specs"]
