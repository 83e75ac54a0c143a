"""Device ms a step of the evolution engine's forward, its three calls a
step, two inside the residual (the span ``engine``), from the program's own
span marks over the replays of the captured step (median of
``lib/program_spans.py``'s measured replays)."""

from lib import program_spans


def read(ctx):
    return program_spans.ms(ctx, "engine")
