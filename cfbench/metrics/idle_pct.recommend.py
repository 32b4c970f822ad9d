"""Share of the traced window in which no operation ran on the device."""


def read(ctx):
    if "pass" not in ctx.work or ctx.trace.window_s <= 0 \
            or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
