"""Device ms a step of the reverse pass, the gradient call (the span
``backward``), from the program's own span marks over the replays of the
captured step (median of ``lib/program_spans.py``'s measured replays)."""

from lib import program_spans


def read(ctx):
    return program_spans.ms(ctx, "backward")
