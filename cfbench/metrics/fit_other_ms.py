"""Device milliseconds a traced fit spends in every operation but
kernel 1's launches (sorts, selects, gathers, copies, elementwise work)."""

from cfbench import kernel_names


def read(ctx):
    if "fit" not in ctx.work or not ctx.trace.steps:
        return None
    other = ctx.trace.device_seconds(kernel_names.KERNEL_1, exclude=True)
    return 1e3 * other / ctx.trace.steps if other > 0 else None
