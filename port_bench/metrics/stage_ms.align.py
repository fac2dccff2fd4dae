"""Device ms per burst of tile alignment and the tile warp: the ops
launched under the program's ranges mfsr.align and mfsr.tile_warp."""

STAGES = ('mfsr.align', 'mfsr.tile_warp')


def read(ctx):
    ms = ctx.summary.stage_sum(STAGES)
    return ms if ms > 0 else None
