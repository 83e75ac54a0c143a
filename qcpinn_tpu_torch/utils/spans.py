"""The port's span recorder: device spans that a CUDA graph captures and
replays, and host spans on the profiler's clock.

Off by default, and free when off: a call site costs one check and gets a
shared no-op context; no kernel is launched, no autograd node inserted, no
``record_function`` opened, and the mark kernel's source is never built. A
graph captured with spans off is node for node the graph without them.

On, each edge of a span (its begin and its end) is recorded in order, with
the span that encloses it and, at a begin, the rows of the layer's input.
One recording is one outermost span and everything inside it (the Cz
pretrain step: ``step``). Where the work is on the card, an edge launches
``qc_span_mark`` (``ops/csrc/span_mark.cu``, through ctypes on the current
stream, bypassing the dispatcher, so it runs unchanged under
``torch.func.jvp`` and under stream capture), which writes the device's
nanosecond timer into the edge's slot of a stamp buffer. A captured graph
holds the marks, so each replay stamps every edge again, and :func:`read`
after a replay gives that replay's spans. The marks appear in a profiler's
device trace by name, one an edge, in recorded order: the k-th mark of a
replay is the k-th edge, which places every span on the trace's own clock.
On the CPU an edge records ``time.perf_counter_ns()`` instead. Each span
also opens ``record_function("qc::<name>")`` on the host where it is
recorded (at capture, or in an eager step).

A layer's reverse pass is bracketed by :func:`reverse_begin` at its output
and :func:`reverse_end` at its input: identity ``autograd.Function``s whose
backward records the edges (with ``jvp`` rules, so that they pass through
nested ``torch.func.jvp``). Autograd runs ready nodes in descending order
of creation, so every node made inside the layer's forward call runs after
the begin and before the end.

:func:`host_span` is a ``record_function`` alone (no device mark): what the
host was doing, for a profiled run's idle gaps.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "qc::"
SLOTS = 4096  # edges a recording may hold (the Cz step has 24)

_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Recording:
    """One recorded outermost span: its edges in order, each (name, begin,
    link, rows), where ``link`` is, at a begin, the index of the enclosing
    span's begin (-1 for none) and, at an end, the index of its own begin.
    On the card edge k's stamp is slot k of the stamp buffer; on the CPU it
    is ``host_ns[k]``."""

    cuda: bool
    edges: List[Tuple[str, bool, int, int]] = dataclasses.field(default_factory=list)
    host_ns: List[int] = dataclasses.field(default_factory=list)


class _State:
    def __init__(self):
        self.on = False
        self.open: Optional[Recording] = None  # the recording being made
        self.stack: List[int] = []  # begins of the open spans
        self.host: List[object] = []  # their record_function handles
        self.last: Optional[Recording] = None  # whose stamps read() reads
        self.generation = 0  # recordings completed
        self.stamps: Optional[torch.Tensor] = None
        self.lib: Optional[ctypes.CDLL] = None


_S = _State()


def enabled() -> bool:
    return _S.on


def enable(on: bool = True) -> None:
    """Turn spans on or off for the process. Turning them on with a card
    present builds the mark kernel (once) and allocates the stamp buffer
    there. A ``CapturedStep`` captured the other way captures again at its
    next call."""
    if _S.open is not None:
        raise RuntimeError("spans switched inside a span")
    if on and torch.cuda.is_available() and _S.stamps is None:
        _library()
        _S.stamps = torch.zeros(SLOTS, dtype=torch.int64, device="cuda")
    _S.on = bool(on)


@contextlib.contextmanager
def turned_on():
    """Spans on for the block, then as they were."""
    was = _S.on
    enable(True)
    try:
        yield
    finally:
        enable(was)


def _library() -> ctypes.CDLL:
    if _S.lib is None:
        from ..ops import cuda_build

        lib = ctypes.CDLL(cuda_build.build("span_mark")[0])
        lib.qc_span_mark_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.qc_span_mark_launch.restype = ctypes.c_int
        lib.qc_span_mark_error_string.argtypes = [ctypes.c_int]
        lib.qc_span_mark_error_string.restype = ctypes.c_char_p
        _S.lib = lib
    return _S.lib


def _stamp(rec: Recording, slot: int) -> None:
    if not rec.cuda:
        rec.host_ns.append(time.perf_counter_ns())
        return
    lib = _S.lib
    err = lib.qc_span_mark_launch(_S.stamps.data_ptr(), slot,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"qc_span_mark launch failed: CUDA error {err} "
                           f"({lib.qc_span_mark_error_string(err).decode()})")


def _begin(name: str, rows: int, cuda: bool) -> None:
    if _S.open is None:
        _S.open = Recording(cuda=cuda and _S.stamps is not None)
    rec = _S.open
    k = len(rec.edges)
    if k >= SLOTS:
        raise RuntimeError(f"a recording holds at most {SLOTS} span edges")
    rf = torch.profiler.record_function(PREFIX + name)
    rf.__enter__()
    _S.host.append(rf)
    rec.edges.append((name, True, _S.stack[-1] if _S.stack else -1, rows))
    _S.stack.append(k)
    _stamp(rec, k)


def _end(name: str) -> None:
    rec = _S.open
    if rec is None or rec.edges[_S.stack[-1]][0] != name:
        raise RuntimeError(f"span {name!r} ends where it did not begin")
    k = len(rec.edges)
    _stamp(rec, k)
    rec.edges.append((name, False, _S.stack.pop(), 0))
    _S.host.pop().__exit__(None, None, None)
    if not _S.stack:
        _S.open, _S.last = None, rec
        _S.generation += 1


def _abandon() -> None:
    """Drop the recording being made (an exception left its spans open)."""
    while _S.host:
        _S.host.pop().__exit__(None, None, None)
    _S.open, _S.stack = None, []


def _rows(x: Optional[torch.Tensor]) -> int:
    return int(x.shape[0]) if x is not None and x.ndim else 0


class _Span:
    __slots__ = ("name", "x")

    def __init__(self, name: str, x: Optional[torch.Tensor]):
        self.name, self.x = name, x

    def __enter__(self):
        x = self.x
        _begin(self.name, _rows(x), x is not None and x.is_cuda)

    def __exit__(self, kind, value, tb):
        if kind is None:
            _end(self.name)
        else:
            _abandon()


def span(name: str, x: Optional[torch.Tensor] = None):
    """A device span around the block; ``x`` is the layer's input (its
    rows are counted; an outermost span on a CUDA tensor stamps on the
    card)."""
    if not _S.on:
        return _NULL
    return _Span(name, x)


def host_span(name: str):
    """``record_function("qc::<name>")`` around the block, with spans on."""
    if not _S.on:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


class _ReverseMark(torch.autograd.Function):
    """Identity whose backward records an edge of ``name``: the begin at a
    layer's output (the reverse pass enters there), the end at its input."""

    @staticmethod
    def forward(x, name, begin):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name, ctx.begin = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        if ctx.begin:
            _begin(ctx.name, _rows(g), g.is_cuda)
        else:
            _end(ctx.name)
        return g, None, None

    @staticmethod
    def jvp(ctx, t, _name, _begin):
        return t.view_as(t)


def reverse_begin(name: str, y: torch.Tensor) -> torch.Tensor:
    """``y`` (a layer's output), its backward marking the begin of span
    ``name``; ``y`` itself with spans off."""
    if not _S.on:
        return y
    return _ReverseMark.apply(y, name, True)


def reverse_end(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` (a layer's input), its backward marking the end of span
    ``name``; ``x`` itself with spans off."""
    if not _S.on:
        return x
    return _ReverseMark.apply(x, name, False)


def generation() -> int:
    """How many recordings have completed in this process."""
    return _S.generation


def last() -> Optional[Recording]:
    return _S.last


def use(rec: Recording) -> None:
    """Read ``rec``'s layout next: a graph replay that wrote it."""
    _S.last = rec


def layout() -> List[Tuple[str, str]]:
    """The last recording's edges in order, (name, "begin" or "end"): the
    k-th ``qc_span_mark`` of a step in a device trace is the k-th edge."""
    rec = _S.last
    return [(e[0], "begin" if e[1] else "end") for e in rec.edges] if rec else []


def read() -> Dict[str, Dict[str, float]]:
    """The last recorded step's spans by name (after waiting for the card):
    ``ms`` (every occurrence summed), ``self_ms`` (less the part its child
    spans cover), ``rows`` (summed) and ``count``. Raises if the stamps run
    backwards."""
    rec = _S.last
    if rec is None:
        return {}
    if rec.cuda:
        torch.cuda.synchronize()
        ns = _S.stamps[:len(rec.edges)].tolist()
    else:
        ns = rec.host_ns
    if any(b < a for a, b in zip(ns, ns[1:])):
        raise RuntimeError("span stamps out of order")
    child_ms = [0.0] * len(rec.edges)
    out: Dict[str, Dict[str, float]] = {}
    for k, (name, begin, link, _) in enumerate(rec.edges):
        if begin:
            continue
        ms = (ns[k] - ns[link]) * 1e-6
        parent = rec.edges[link][2]
        if parent >= 0:
            child_ms[parent] += ms
        row = out.setdefault(name, {"ms": 0.0, "self_ms": 0.0, "rows": 0, "count": 0})
        row["ms"] += ms
        row["self_ms"] += ms - child_ms[link]
        row["rows"] += rec.edges[link][3]
        row["count"] += 1
    return out
