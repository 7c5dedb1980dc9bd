"""Share of the window, in percent, in the program's batch.gather spans: the shards' outputs copied to the home card and concatenated."""
from benchmark import split_spans


def read(ctx):
    return split_spans.share(ctx, "batch.gather")
