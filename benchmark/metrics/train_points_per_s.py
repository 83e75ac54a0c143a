"""The distinct input points that the window's completed steps trained on,
over all the window's seconds by the host clock (one synchronise at its
end)."""


def read(ctx):
    w = ctx.window
    return w["steps"] * ctx.system.points_per_step / w["seconds"]
