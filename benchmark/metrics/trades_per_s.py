"""Trades priced with their greeks per second, over all the window's trades and time (closed loops)."""
from benchmark import readers


def read(ctx):
    return readers.trades_per_s(ctx)
