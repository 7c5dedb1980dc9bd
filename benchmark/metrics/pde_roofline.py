"""The least time of the window's Crank-Nicolson work over the device's busy time, in percent (counting.py, peaks.json)."""
from benchmark import readers


def read(ctx):
    return readers.pde_roofline(ctx)
