"""The port's span recorder (qcpinn_tpu_torch/utils/spans.py) on the Cz
pretrain step (train/cz_pipeline.py) of a small Hybrid16QPINN: 4 qubits,
trunk 8, batch 8. Off, it leaves no trace; on, the step's losses and
parameters are bit-equal to off, its edges nest, its four phases tile
``step``, and ``engine.bwd`` brackets the engine's reverse pass."""

import numpy as np
import pytest
import torch

from qcpinn_tpu_torch.data.cz_loader import DataStats
from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
from qcpinn_tpu_torch.physics.operators_fwd import cz_residuals_fwd
from qcpinn_tpu_torch.train import cz_pipeline as czp
from qcpinn_tpu_torch.utils import spans

B = 8
STATS = DataStats(length_scale=1.0, velocity_scale=1.0, pressure_scale=1.0, temp_min=0.0,
                  temp_max=1.0, pressure_coeff=3.0)
PHASES = ["data_forward", "residual", "data_forward", "backward", "optimizer"]


def _data(rows=4 * B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 1, (rows, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (rows, 5)).astype(np.float32))


def _epoch(path="jet"):
    """The step on the residual path ``path``: the model's jet (the
    pipeline's choice) or the nested jvps, forced."""
    X, Y = _data()
    model = Hybrid16QPINN(4, 2, width=8, remat=False, seed=3, device="cpu")
    cfg = czp.CzConfig(n_qubits=4, n_layers=2, batch_size=B, physics_weight=0.05,
                       physics_warmup=0)
    pe = czp.make_pretrain_epoch(model, X, Y, STATS, cfg)
    pe.phys_w.fill_(0.05)
    pe.lr.fill_(1e-3)
    assert pe.residual_path == "jet"
    if path == "jvp":
        pe.residual_fn = cz_residuals_fwd
    assert pe.residual_path == path
    return model, pe


def _feed(pe, i):
    X, Y = _data()
    pe.xb.copy_(torch.as_tensor(X[i * B:(i + 1) * B]))
    pe.yb.copy_(torch.as_tensor(Y[i * B:(i + 1) * B]))


@pytest.fixture
def spans_on():
    spans.enable(True)
    yield
    spans.enable(False)


def _graph_nodes(root):
    seen, todo = set(), [root]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nf for nf, _ in fn.next_functions)
    return seen


def test_off_records_nothing_and_builds_nothing(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refused(*args):
        raise AssertionError("the recorder ran with spans off")

    for name in ("_library", "_begin", "_end", "_stamp"):
        monkeypatch.setattr(spans, name, refused)
    assert not spans.enabled()
    model, pe = _epoch()
    _feed(pe, 0)
    generation = spans.generation()
    total = pe.batch_loss(pe.xb, pe.yb, pe.phys_w)[0]
    assert not any("ReverseMark" in type(fn).__name__ for fn in _graph_nodes(total.grad_fn))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pe.static_step()
    names = {e.name for e in prof.events()}
    assert not any(n.startswith(spans.PREFIX) or "qc_span_mark" in n for n in names)
    assert spans.generation() == generation


def test_on_and_off_are_bit_equal():
    runs = []
    for on in (False, True):
        spans.enable(on)
        try:
            model, pe = _epoch()
            losses = []
            for i in range(3):
                _feed(pe, i)
                losses.append(pe.static_step())
        finally:
            spans.enable(False)
        runs.append((torch.stack(losses), dict(model.named_parameters()), pe.ema))
    (l_off, p_off, e_off), (l_on, p_on, e_on) = runs
    assert torch.equal(l_off, l_on)
    assert all(torch.equal(p, p_on[k]) for k, p in p_off.items())
    assert all(torch.equal(v, e_on[k]) for k, v in e_off.items())


def test_edges_nest_and_the_phases_tile_the_step(spans_on):
    from torch.profiler import ProfilerActivity, profile

    model, pe = _epoch()
    _feed(pe, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pe.static_step()
    rec = spans.last()
    depth, top = [], []
    for name, begin, link, rows in rec.edges:
        if begin:
            if len(depth) == 1:
                top.append(name)
            depth.append(name)
            assert rows == B
        else:
            assert depth.pop() == name
    assert not depth
    assert rec.edges[0][:2] == ("step", True) and rec.edges[-1][:2] == ("step", False)
    # the step's children, in order, each ending where the next begins
    kids = [k for k, e in enumerate(rec.edges) if e[1] and e[2] == 0]
    assert [rec.edges[k][0] for k in kids] == PHASES
    ends = [next(j for j, e in enumerate(rec.edges) if not e[1] and e[2] == k) for k in kids]
    assert [e + 1 for e in ends[:-1]] == kids[1:] and ends[-1] == len(rec.edges) - 2
    got = spans.read()
    assert got["data_forward"]["count"] == 2
    phases = sum(got[p]["ms"] for p in set(PHASES))
    assert phases <= got["step"]["ms"] and got["step"]["self_ms"] < 0.02 * got["step"]["ms"]
    # each edge opened its host span
    names = [e.name for e in prof.events()]
    for name in ("step", "data_forward", "residual", "engine", "backward", "engine.bwd",
                 "optimizer"):
        assert names.count(spans.PREFIX + name) == got[name]["count"]


# engine calls a step by residual path: the data forward's, then the
# residual's (the jet's one, or one in each jvp-over-jvp trace)
ENGINE_CALLS = {"jet": 2, "jvp": 3}


@pytest.mark.parametrize("path", ["jet", "jvp"])
def test_the_engine_runs_three_times_two_inside_the_residual(spans_on, path):
    """Three times on the nested jvps, two inside the residual; twice on the
    jet, once inside it."""
    model, pe = _epoch(path)
    _feed(pe, 0)
    pe.static_step()
    rec = spans.last()
    calls = ENGINE_CALLS[path]
    parents = [rec.edges[e[2]][0] for e in rec.edges if e[1] and e[0] == "engine"]
    assert parents == ["data_forward"] + ["residual"] * (calls - 1)
    bwd = [rec.edges[e[2]][0] for e in rec.edges if e[1] and e[0] == "engine.bwd"]
    assert bwd == ["backward"] * calls
    got = spans.read()
    assert got["engine"]["rows"] == got["engine.bwd"]["rows"] == calls * B
    assert got["engine.bwd"]["ms"] < got["backward"]["ms"]


@pytest.mark.parametrize("path", ["jet", "jvp"])
def test_engine_bwd_brackets_every_node_made_inside_the_engine_call(spans_on, path):
    """Every backward node created inside an engine call (its primal and the
    jet's channels, or the nested jvps' tangent streams) runs between that
    call's pair of marks, and nothing else runs there."""
    model, pe = _epoch(path)
    _feed(pe, 0)
    total = pe.batch_loss(pe.xb, pe.yb, pe.phys_w)[0]
    nodes = [fn for fn in _graph_nodes(total.grad_fn) if fn._sequence_nr() < 2 ** 63]
    marks = sorted(fn._sequence_nr() for fn in nodes if "ReverseMark" in type(fn).__name__)
    assert len(marks) == 2 * ENGINE_CALLS[path]  # an input and an output mark a call
    order = []
    for fn in nodes:
        fn.register_prehook(lambda grads, seq=fn._sequence_nr(): order.append(seq))
    torch.autograd.grad(total, [p for p in model.parameters() if p.requires_grad],
                        allow_unused=True)
    at = {seq: i for i, seq in enumerate(order)}
    for lo, hi in zip(marks[0::2], marks[1::2]):
        inside = [s for s in order if lo < s < hi]
        assert inside, "the engine call made no backward node"
        window = order[at[hi] + 1:at[lo]]
        assert sorted(window) == sorted(inside)
