"""Share of the window, in percent, in the program's service.ki_parity spans: the knock-in parity legs."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "service.ki_parity")
