"""Share of the window, in percent, in the program's batch.build_grids spans: the grid and schedule builder (native or numpy)."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "batch.build_grids")
