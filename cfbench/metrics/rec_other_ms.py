"""Device milliseconds a traced recommend pass spends in every operation but
kernel 2's launches (sorts, selects, gathers, copies, elementwise work)."""

from cfbench import kernel_names


def read(ctx):
    if "pass" not in ctx.work or not ctx.trace.steps:
        return None
    other = ctx.trace.device_seconds(kernel_names.KERNEL_2, exclude=True)
    return 1e3 * other / ctx.trace.steps if other > 0 else None
