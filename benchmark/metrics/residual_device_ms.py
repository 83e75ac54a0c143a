"""Device ms of the kernels launched inside the call into the residual
(one profiled eager step; the span ``residual`` of the system's
``spans/`` folder). The residual's reverse pass runs later, under the
step's gradient call, and is not in it."""


def read(ctx):
    return ctx.spans.get("residual") or None
