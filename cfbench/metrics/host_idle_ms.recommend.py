"""Device-idle milliseconds while the host is inside the program's
``engine.recommend`` span, per call: the idle time that is the program's own,
apart from the harness's between calls."""

from cfbench import spans


def read(ctx):
    return spans.host_idle_ms(ctx.trace, spans.RECOMMEND_ROOT)
