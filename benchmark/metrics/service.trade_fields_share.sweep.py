"""Share of the window, in percent, in the program's service.trade_fields spans: the trade dicts read into per-field lists."""
from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx, "service.trade_fields")
