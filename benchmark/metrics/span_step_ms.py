"""Device ms a step of the whole train step (the span ``step``: all of
``PretrainEpoch.step_fn``), from the program's own span marks over the
replays of the captured step (median of ``lib/program_spans.py``'s measured
replays)."""

from lib import program_spans


def read(ctx):
    return program_spans.ms(ctx, "step")
