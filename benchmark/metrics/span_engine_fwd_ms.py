"""Device ms a step of the evolution engine's forward (the span ``engine``,
every call of a step summed: two on the jet path, the data forward's and
one inside the residual; three on the nested jvps, two of them inside the
residual), from the program's own span marks over the replays of the
captured step (median of ``lib/program_spans.py``'s measured replays)."""

from lib import program_spans


def read(ctx):
    return program_spans.ms(ctx, "engine")
