"""Kernel 2's share of its roofline: a pass's counted work at its bound
(``cfbench.counts.recommend_work``: bytes at the HBM rate or
operations at the f32 peak, the larger) over the
device seconds of kernel 2's launches a traced pass."""

from cfbench import counts, kernel_names


def read(ctx):
    work = ctx.work.get("pass")
    if work is None or ctx.peaks is None or not ctx.trace.steps:
        return None
    t = ctx.trace.device_seconds(kernel_names.KERNEL_2) / ctx.trace.steps
    if t <= 0:
        return None
    return 100.0 * counts.bound_seconds(work, ctx.peaks) / t
