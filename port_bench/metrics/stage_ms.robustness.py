"""Device ms per burst of robustness and the kernel parameters: the ops
launched under the program's ranges mfsr.robustness and
mfsr.kernel_params."""

STAGES = ('mfsr.robustness', 'mfsr.kernel_params')


def read(ctx):
    ms = ctx.summary.stage_sum(STAGES)
    return ms if ms > 0 else None
