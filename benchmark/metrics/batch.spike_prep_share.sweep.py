"""Share of the window, in percent, in the program's batch.spike_prep spans: the SPIKE preps behind the interface guard."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "batch.spike_prep")
