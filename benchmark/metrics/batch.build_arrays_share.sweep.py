"""Share of the window, in percent, in the program's batch.build_arrays spans: the trade columns and the builder's outputs in the working dtype."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "batch.build_arrays")
