"""Share of the program's batch.driver calls, in percent, in which a guard turned auto away from the route its rule prefers."""
from benchmark import program_spans


def read(ctx):
    return program_spans.guard_refused_share(ctx)
