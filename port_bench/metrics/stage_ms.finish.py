"""Device ms per burst of the restore and the finalize: the ops launched
under the program's ranges mfsr.restore and mfsr.finalize."""

STAGES = ('mfsr.restore', 'mfsr.finalize')


def read(ctx):
    ms = ctx.summary.stage_sum(STAGES)
    return ms if ms > 0 else None
