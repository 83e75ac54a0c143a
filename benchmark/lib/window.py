"""The measured window: the window's own step called back to back for a
fixed number of seconds, the device kept two steps ahead of the host (the
host waits on the event of the step before the last), one synchronise at
the end. Every step records a CUDA event after it, so the step times come
from the device's clock with no host synchronisation in the loop."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

AHEAD = 2


def run(step: Callable[[], torch.Tensor], seconds: float, device) -> Dict:
    """Returns the steps completed, the window's seconds by the host clock
    (from the first call to the end of the final synchronise), each step's
    milliseconds by the device's events, and the count of steps whose loss
    was not finite."""
    cuda = device.type == "cuda"
    losses = torch.empty(1 << 16, device=device)
    events, stamps = [], []
    if cuda:
        torch.cuda.synchronize()
        first = torch.cuda.Event(enable_timing=True)
        first.record()
    t0 = time.perf_counter()
    steps = 0
    host = []
    while True:
        h0 = time.perf_counter()
        loss = step()
        host.append(time.perf_counter() - h0)
        losses[steps % losses.numel()].copy_(loss.reshape(()))
        steps += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if steps > AHEAD:
                events[steps - 1 - AHEAD].synchronize()
        else:
            stamps.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
        marks = [first] + events
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    elapsed = time.perf_counter() - t0
    kept = losses[: min(steps, losses.numel())]
    return {"steps": steps, "seconds": elapsed, "step_ms": step_ms,
            "host_ms": [1e3 * h for h in host],
            "failed": int((~torch.isfinite(kept)).sum())}
