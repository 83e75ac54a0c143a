"""The device memory the process holds through the window (GiB):
``torch.cuda.max_memory_reserved()`` after ``reset_peak_memory_stats()``.
Reserved and not allocated, because a CUDA graph's replay allocates
nothing: the step's tensors live in the graph's memory pool, reserved when
it was captured."""


def read(ctx):
    if not ctx.window_reserved:
        return None
    return ctx.window_reserved / 2 ** 30
