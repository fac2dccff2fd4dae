"""Device ms per burst of the ops launched outside every ``mfsr.*``
range (the entry points' own code between the stages): with the
``stage_ms`` metrics of the stages it adds up to the burst's device
total."""

from port_bench.trace import OTHER


def read(ctx):
    ms = ctx.summary.stage_ms.get(OTHER, 0.0)
    return ms if ms > 0 else None
