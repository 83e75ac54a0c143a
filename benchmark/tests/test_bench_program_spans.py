"""The program's spans as the benchmark reads them, on the small cell on
the CPU: the shared traced stretch yields every span of the step, each span
reader a positive number, and the spans are off again afterwards; the
capture's seconds exist only where a step was captured (on the card)."""

from types import SimpleNamespace

import torch

from conftest import small_cell
from lib import program_spans, spec

SPAN_READERS = ("span_step_ms", "span_data_fwd_ms", "span_residual_ms", "span_backward_ms",
                "span_optimizer_ms", "span_engine_fwd_ms", "span_engine_bwd_ms")


def test_every_span_is_read_and_spans_end_off(monkeypatch):
    from qcpinn_tpu_torch.utils import spans

    monkeypatch.setattr(program_spans, "WARM", 2)
    cell = small_cell("cz16-pretrain-b256")
    system = spec.system(cell.traffic).build(cell.config, cell.traffic, 2**31 + 5,
                                             torch.device("cpu"))
    ctx = SimpleNamespace(system=system)
    got = program_spans.readings(ctx)
    assert not spans.enabled()
    assert set(got) == {"step", "data_forward", "residual", "backward", "optimizer", "engine",
                        "engine.bwd"}
    assert got["step"]["rows"] == cell.traffic["batch"]
    for name in SPAN_READERS:
        value = spec.reader(name).read(ctx)
        assert value is not None and value > 0, name
    assert got["engine.bwd"]["ms"] < got["backward"]["ms"] < got["step"]["ms"]
    assert spec.reader("capture_s").read(ctx) is None  # no capture on the CPU
    assert system.taken == program_spans.WARM + program_spans.MEASURED


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import sys

    import qcpinn_tpu_torch.utils

    monkeypatch.delattr(qcpinn_tpu_torch.utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "qcpinn_tpu_torch.utils.spans", None)
    ctx = SimpleNamespace(system=None)
    assert program_spans.readings(ctx) is None
    assert all(spec.reader(name).read(ctx) is None for name in SPAN_READERS)
