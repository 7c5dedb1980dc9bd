"""The schedule rows the program's builders made, over the trade rows they
built, in percent: the sum of ``schedules`` over the sum of ``rows`` across
the window's ``batch.build_grids`` records. None where the window holds no
request (an untraced run) or no build that counts its schedules (a program
that builds a row per trade)."""
from benchmark import program_spans


def read(ctx):
    recs = program_spans._window(ctx) or []
    builds = [r for r in recs if r.name == "batch.build_grids" and "schedules" in r.attrs]
    rows = sum(r.attrs.get("rows", 0) for r in builds)
    if not rows:
        return None
    return 100.0 * sum(r.attrs["schedules"] for r in builds) / rows
