"""The 95th percentile of the window's step times (ms), from the CUDA event
recorded on the stream after every step: stalls such as an epoch's
reshuffle show here."""

import statistics


def read(ctx):
    ms = ctx.window["step_ms"]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
