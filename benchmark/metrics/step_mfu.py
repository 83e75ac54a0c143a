"""The whole step's model operations (gate-level counts of the
configuration, ``lib/flops.py``) times the window's steps over its seconds,
as a percent of a third of the card's TF32 peak (3xTF32)."""

from lib import flops


def read(ctx):
    w = ctx.window
    rate = ctx.system.work()["model_flops"] * w["steps"] / w["seconds"]
    return 100.0 * rate / flops.PEAK_3XTF32
