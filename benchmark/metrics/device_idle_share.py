"""Percent of the profiled replays' span in which no operation ran on the
device: 100 (1 - the union of device intervals / the span)."""


def read(ctx):
    rep = ctx.replay
    if rep is None or rep["launches"] == 0:
        return None
    return 100.0 * (1.0 - rep["busy_us"] / rep["window_us"])
