"""Device kernels, copies and memsets a step, from the profiler over the
profiled replays of the window's own step."""


def read(ctx):
    if ctx.replay is None or ctx.replay["launches"] == 0:
        return None
    return ctx.replay["launches"] / ctx.replay["steps"]
