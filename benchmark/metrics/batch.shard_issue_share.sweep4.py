"""Share of the window, in percent, in the program's batch.shard spans: the host issuing each shard's kernel calls (march, greeks) to its card."""
from benchmark import split_spans


def read(ctx):
    return split_spans.share(ctx, "batch.shard")
