"""Readings of torch.profiler traces: device intervals, busy and idle time,
launches, time by kernel name, and the device time of the kernels launched
inside a named span.

The profiler links each kernel (or copy, or memset) to the CPU operator
that launched it; inside a CUDA graph's replay it still sees every kernel.
Device time is the union of the device intervals, so overlapping kernels
count once and the idle share can never fall below 0.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10
PREFIX = "bench::"  # the benchmark's own spans, which are not device work


def _profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _is_device(e) -> bool:
    """An operation on the device: a kernel, a copy or a memset, and not
    the device-side shadow of a ``record_function`` span."""
    from torch.autograd import DeviceType

    return (e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(PREFIX))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _host_doing(cpu_events, t: float, skip: str) -> str:
    """The innermost host event that covers time ``t``."""
    best, width = None, None
    for e in cpu_events:
        a, b = e.time_range.start, e.time_range.end
        if a <= t <= b and e.name != skip and (width is None or b - a < width):
            best, width = e.name, b - a
    return best or "host waiting"


def replays(step: Callable[[], object], steps: int, name: str = PREFIX + "replays") -> Dict:
    """Profile ``steps`` calls of the window's own step, ending in a
    synchronise. Returns the device intervals' union over the traced span,
    the span, launches a step, seconds by kernel name and the longest idle
    gaps by what the host was doing then."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    _sync()
    with _profile() as prof:
        with record_function(name):
            for _ in range(steps):
                step()
            _sync()
    events = prof.events()
    spans = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    dev = [e for e in events if _is_device(e)]
    merged = union([(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in dev
                    if e.time_range.end > lo and e.time_range.start < hi])
    busy_us = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)),
                  reverse=True)[:TOP]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    return {
        "steps": steps,
        "window_us": hi - lo,
        "busy_us": busy_us,
        "launches": len(dev),
        "kernel_us": by_name,
        "device_ops": sorted(((k, v * 1e-6) for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [[_host_doing(cpu, t + g / 2, name), g * 1e-6] for g, t in gaps if g > 0],
    }


@contextlib.contextmanager
def spans_on(obj, attr: str, name: str):
    """Wrap ``obj.attr`` in a ``record_function(name)`` for the duration of
    the block (an instance or module attribute; nothing of the program is
    edited)."""
    from torch.profiler import record_function

    had = attr in vars(obj)
    inner = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with record_function(name):
            return inner(*args, **kwargs)

    setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        if had:
            setattr(obj, attr, inner)
        else:
            delattr(obj, attr)


@contextlib.contextmanager
def spans_at(root, paths: Dict[str, str]):
    """Spans named ``PREFIX + name`` around the calls at each dotted path
    (from ``root``) of ``paths``, for the duration of the block."""
    with contextlib.ExitStack() as stack:
        for name, path in paths.items():
            *owner, attr = path.split(".")
            stack.enter_context(spans_on(functools.reduce(getattr, owner, root), attr,
                                         PREFIX + name))
        yield


def span_device_ms(step: Callable[[], object], root, paths: Dict[str, str]) -> Dict[str, float]:
    """Profile one call of ``step`` with the spans of ``paths`` around their
    calls, and return, for each span that occurred, the device milliseconds
    of the kernels launched while it was open on its thread (every
    occurrence summed)."""
    _sync()
    with spans_at(root, paths), _profile() as prof:
        step()
        _sync()
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    out: Dict[str, float] = {}
    for name in paths:
        opened = [e for e in cpu if e.name == PREFIX + name]
        if not opened:
            continue
        # the outermost occurrences only: a span opened inside another of the
        # same name (a nested call) is already covered
        outer = [s for s in opened if not any(
            o is not s and o.thread == s.thread and o.time_range.start <= s.time_range.start
            and s.time_range.end <= o.time_range.end for o in opened)]
        us = 0.0
        for s in outer:
            a, b = s.time_range.start, s.time_range.end
            for e in cpu:
                if e.thread == s.thread and a <= e.time_range.start and e.time_range.end <= b:
                    us += sum(k.duration for k in e.kernels)
        out[name] = us * 1e-3
    return out
