"""Process start to the first timed request, in seconds: imports, the service's build, kernel builds on a checkout's first run, warm-up and making the requests."""


def read(ctx):
    return ctx.setup_s
