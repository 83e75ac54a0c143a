"""The card's launch mode, read by a probe graph.

A process on the card can run for a while with every CUDA graph node
launched about 0.2 us slower than the card's fast level, the Cz pretrain
step 3% slower. It enters that mode at a heavy CUDA call of its own (the
first eager step, a capture, a later capture too) and leaves it at a
random moment, 0-54 s later in the runs seen (PERF.md). A graph of
``NODES`` one-element adds reads the mode: its microseconds a node, taken
before the program has run, are the fast level, and the slow mode reads
15-20% above it. ``settle`` replays the window's own step until the probe
reads the fast level again, so that the window starts in it; the wait is
the card's, and the run reports it apart from its set-up.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

NODES = 1000
REPLAYS = 20
SLACK = 1.06  # fast readings differ by under 1%, the slow mode reads 1.15x or more
BATCH = 8  # steps between two readings
CAP_S = 90.0  # the longest wait for the fast level (the longest seen: 54 s)


class Probe:
    """A captured graph of ``NODES`` one-element adds on ``device``;
    ``fast`` is its reading at construction."""

    def __init__(self, device):
        x = torch.zeros(1, device=device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(NODES):
                x.add_(1)
        self.fast = self.read()

    def read(self) -> float:
        """Microseconds a node over ``REPLAYS`` replays, after one."""
        torch.cuda.synchronize()
        self.graph.replay()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPLAYS):
            self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / (REPLAYS * NODES)

    def slow(self, reading: float) -> bool:
        return reading > SLACK * self.fast


def settle(step: Callable[[], object], probe, cap_s: float) -> dict:
    """Calls ``step`` in batches of ``BATCH`` until ``probe`` reads its fast
    level or ``cap_s`` seconds have passed; returns the seconds waited, the
    steps taken, whether the last reading was fast, and the last reading
    and the fast level (us a node)."""
    t0 = time.perf_counter()
    steps = 0
    reading = probe.read()
    while probe.slow(reading) and time.perf_counter() - t0 < cap_s:
        for _ in range(BATCH):
            step()
        steps += BATCH
        reading = probe.read()
    return {"wait_s": time.perf_counter() - t0, "steps": steps, "fast": not probe.slow(reading),
            "probe_us": reading, "fast_us": probe.fast}
