"""Host waits on the device (stream, device and event synchronises, blocking
copies) that start inside the program's ``engine.recommend`` span, per call."""

from cfbench import spans


def read(ctx):
    return spans.syncs(ctx.trace, spans.RECOMMEND_ROOT)
