"""Device ms per burst of the LK refinement: the ops launched under the
program's ranges mfsr.lk."""

STAGES = ('mfsr.lk',)


def read(ctx):
    ms = ctx.summary.stage_sum(STAGES)
    return ms if ms > 0 else None
