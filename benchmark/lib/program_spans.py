"""The program's own spans (``qcpinn_tpu_torch/utils/spans.py``), read over
one traced stretch that every span reader shares: the spans turned on, the
window's own step driven on (its captured step captures again with the
marks), ``WARM`` replays to let the fresh capture settle (it replays slower
for its first 8-38), then ``MEASURED`` replays with the stamps read after
each; the medians by span name are kept on ``ctx``. The spans are turned
off at the end whatever happens. A program without the recorder gives
nothing to read."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

WARM = 40
MEASURED = 10


def readings(ctx) -> Optional[Dict[str, Dict[str, float]]]:
    """Each span's median ``ms``, ``self_ms`` and ``rows`` over the measured
    replays, by name; None where the program has no recorder."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    try:
        from qcpinn_tpu_torch.utils import spans
    except ImportError:
        return None
    spans.enable(True)
    try:
        for _ in range(WARM):
            ctx.system.step()
        steps = []
        for _ in range(MEASURED):
            ctx.system.step()
            steps.append(spans.read())
    finally:
        spans.enable(False)
    names = set.intersection(*(set(s) for s in steps))
    ctx.program_spans = {n: {k: statistics.median(s[n][k] for s in steps)
                             for k in ("ms", "self_ms", "rows")} for n in names}
    return ctx.program_spans


def ms(ctx, name: str) -> Optional[float]:
    """Span ``name``'s median device ms a step (every occurrence summed),
    or None."""
    got = readings(ctx)
    return got[name]["ms"] if got and name in got else None
