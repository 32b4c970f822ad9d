"""Kernel 5's share of its roofline in the bulk recommend's top-n: a
pass's counted select bytes (``cfbench.counts_topn``) at the HBM rate,
over the device seconds of kernel 5's launches a traced pass."""

# kernel 5, csrc/select.cu: the radix select, staged and unstaged routes
KERNEL_5 = ("radix_topm_kernel",)


def read(ctx):
    work = ctx.work.get("topn")
    if work is None or ctx.peaks is None or not ctx.trace.steps:
        return None
    t = ctx.trace.device_seconds(KERNEL_5) / ctx.trace.steps
    if t <= 0:
        return None
    return 100.0 * work["bytes"] / ctx.peaks["hbm_bytes"] / t
