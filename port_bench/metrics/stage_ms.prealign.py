"""Device ms per burst of pre-alignment: the ops launched under the
program's ranges mfsr.prealign."""

STAGES = ('mfsr.prealign',)


def read(ctx):
    ms = ctx.summary.stage_sum(STAGES)
    return ms if ms > 0 else None
