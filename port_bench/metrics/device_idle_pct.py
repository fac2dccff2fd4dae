"""The share of the traced window in which no kernel, copy or memset ran
on the device."""


def read(ctx):
    s = ctx.summary
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
