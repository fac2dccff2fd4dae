"""The RGB merge kernel's share of its roofline: the least time of the
call at the cell's shapes (``work.merge_fast_bound``) over the kernel's
device time per burst (every op whose name holds ``merge_fast_``)."""

from port_bench import work


def read(ctx):
    if getattr(ctx, "layout", None) != "rgb":
        return None
    ms = ctx.summary.kernel_sum("merge_fast_")
    bound = work.merge_fast_bound(ctx.merge, ctx.scale, ctx.k_max, ctx.residual_bound,
                                  ctx.frames, ctx.height, ctx.width)
    if ms <= 0 or bound is None:
        return None
    return 100.0 * bound.least_s() * 1e3 / ms
