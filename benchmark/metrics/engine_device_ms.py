"""Device ms of the kernels launched inside the calls into the evolution
engine (every call of one profiled eager step, the span ``engine``;
forward only, as for ``residual_device_ms``)."""


def read(ctx):
    return ctx.spans.get("engine") or None
