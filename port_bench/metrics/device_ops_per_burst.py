"""Device ops (kernels, copies, memsets) per traced burst: the work the
host dispatches for one burst."""


def read(ctx):
    return ctx.summary.ops_per_burst if ctx.summary.ops_per_burst > 0 else None
