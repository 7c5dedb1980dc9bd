"""Share of the window, in percent, in the program's service.host_copy spans: the host waiting on the device for a request's outputs."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "service.host_copy")
