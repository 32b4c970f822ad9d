"""The whole step's share of the card's peak: the work a step needs
(``cfbench.counts``) at its roofline bound, over the step's seconds on
the host's clock (the traced run's untraced steps)."""

from cfbench import counts


def read(ctx):
    work = ctx.work.get("pass")
    if work is None or ctx.peaks is None or ctx.step_s <= 0:
        return None
    return 100.0 * counts.bound_seconds(work, ctx.peaks) / ctx.step_s
