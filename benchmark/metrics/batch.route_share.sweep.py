"""Share of the window, in percent, in the program's batch.route spans: the route checks of the batch driver."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "batch.route")
