"""Bytes the program's batch.upload spans moved, per request, in 10^6 B."""
from benchmark import program_spans


def read(ctx):
    return program_spans.upload_mb_per_request(ctx)
