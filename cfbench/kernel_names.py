"""Names of the port's hand-written kernels as the device trace shows
them (the function's own name, :func:`cfbench.trace.base_name`).

Kernel 1, ``csrc/similarity.cu``: the int8 tensor-core route's row
preparation and product kernel, and the f32 route's kernel.  Kernel 2,
``csrc/predict.cu``: the int8 and f32 routes of the tile predictor.
"""

KERNEL_1 = ("imma_kernel", "row_prep", "similarity_kernel")
KERNEL_2 = ("predict_int8_kernel", "predict_kernel")
