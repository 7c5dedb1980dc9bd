"""Bytes that crossed between cards in the program's batch.shard_copy and batch.gather spans, per request, in 10^6 B."""
from benchmark import split_spans


def read(ctx):
    return split_spans.peer_mb_per_request(ctx)
