"""Share of the window, in percent, spent in the service's build_batch (host-clock span)."""
from benchmark import readers


def read(ctx):
    return readers.span_share(ctx, "service.build_batch")
