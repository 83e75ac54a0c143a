"""Device ms a step of the model's forward on the batch and the data loss,
with the EMA update and the loss's combination after the residual (the span
``data_forward``, both occurrences), from the program's own span marks over
the replays of the captured step (median of ``lib/program_spans.py``'s
measured replays)."""

from lib import program_spans


def read(ctx):
    return program_spans.ms(ctx, "data_forward")
