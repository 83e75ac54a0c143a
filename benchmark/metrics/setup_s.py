"""Seconds from the process's start to the window's: imports, builds, data,
weights, the compared steps with the capture, the warm replays."""


def read(ctx):
    return ctx.setup_s
