"""Stream submissions (kernel launches, asynchronous copies and memsets)
that start inside the program's ``engine.recommend`` span, per call: what
a traced recommend pass asks of the launch path."""

from cfbench import spans


def read(ctx):
    return spans.launches(ctx.trace, spans.RECOMMEND_ROOT)
