"""Stream submissions (kernel launches, asynchronous copies and memsets)
that start inside the program's ``engine.fit`` span, per call: what
a traced fit asks of the launch path."""

from cfbench import spans


def read(ctx):
    return spans.launches(ctx.trace, spans.FIT_ROOT)
