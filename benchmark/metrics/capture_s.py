"""Host seconds of the captured step's set-up, as the program counts it
(``CapturedStep.capture_s``): from its first eager warm-up to the end of
its first capture, the warm-ups' device work included. None where the
step was not captured or the program keeps no such count."""


def read(ctx):
    captured = getattr(getattr(ctx.system, "pe", None), "captured", None)
    return getattr(captured, "capture_s", None)
