"""Share of the traced window, in percent, in which no operation ran on the device."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
