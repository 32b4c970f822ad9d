"""Kernel 1's share of its roofline: a fit's counted work at its bound
(``cfbench.counts.fit_work``, operations at the int8 peak) over the
device seconds of kernel 1's launches a traced fit."""

from cfbench import counts, kernel_names


def read(ctx):
    work = ctx.work.get("fit")
    if work is None or ctx.peaks is None or not ctx.trace.steps:
        return None
    t = ctx.trace.device_seconds(kernel_names.KERNEL_1) / ctx.trace.steps
    if t <= 0:
        return None
    return 100.0 * counts.bound_seconds(work, ctx.peaks) / t
