"""The window's fastest step (ms, from the per-step CUDA events): a steady
statistic beside the rate. A fresh capture replays slower for its first
tens of replays (by about 0.35 us a graph node); set-up replays past that,
and a window that still meets it reads a lower rate but the same fastest
step."""


def read(ctx):
    ms = ctx.window["step_ms"]
    return min(ms) if ms else None
