"""Share of the window, in percent, in the program's batch.shard_copy spans: each shard's rows of the batch, its sigmas and its SPIKE preps copied to its card."""
from benchmark import split_spans


def read(ctx):
    return split_spans.share(ctx, "batch.shard_copy")
