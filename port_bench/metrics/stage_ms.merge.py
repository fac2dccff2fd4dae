"""Device ms per burst of the merge and its solve: the ops launched under
the program's ranges mfsr.merge and mfsr.solve."""

STAGES = ('mfsr.merge', 'mfsr.solve')


def read(ctx):
    ms = ctx.summary.stage_sum(STAGES)
    return ms if ms > 0 else None
