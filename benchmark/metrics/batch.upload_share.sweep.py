"""Share of the window, in percent, in the program's batch.upload spans: the built arrays copied to the device."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "batch.upload")
