"""The gate-level counts against hand counts on 2- and 3-qubit circuits,
and every cell's model held to the widths that the counts use."""

import pytest
import torch

from conftest import WORKLOADS
from lib import flops


def test_gate_kinds_on_two_qubits():
    # 4 amplitudes: a dense 2x2 is 2 complex multiply-adds an amplitude
    assert flops.gate_flops("1q", 2) == 4 * 2 * 8
    assert flops.gate_flops("diag", 2) == 4 * 6
    assert flops.gate_flops("cz", 2) == 1 * 6  # |11> alone
    with pytest.raises(ValueError):
        flops.gate_flops("toffoli", 2)


def test_circuit_on_two_qubits():
    # RY(0), CZ(0, 1), RZ(1), RX(1): 64 + 6 + 24 + 64
    assert flops.circuit_flops([("1q", (0,)), ("cz", (0, 1)), ("diag", (1,)), ("1q", (1,))],
                               2) == 158


def test_circuit_on_three_qubits():
    # RY on each wire (3 x 128), RZ on wire 1 (48), CZ(0, 2) (2 x 6), Rot on wire 2 (128)
    gates = [("1q", (0,)), ("1q", (1,)), ("1q", (2,)), ("diag", (1,)), ("cz", (0, 2)),
             ("1q", (2,))]
    assert flops.circuit_flops(gates, 3) == 384 + 48 + 12 + 128
    # <Z> of 3 wires on 8 amplitudes: |a|^2 and 3 multiply-adds each
    assert flops.readout_flops(3) == 8 * (3 + 6)


def test_mlp_and_peak():
    assert flops.mlp_flops((3, 5, 2)) == 2 * (15 + 10)
    assert flops.PEAK_3XTF32 == pytest.approx(165e12)


def test_the_configurations_circuit():
    from lib.spec import reference

    cz = reference("cz_hybrid16q")
    # 3 qubits, 1 layer: RY x3, RZ x3, Rot x3, CZ on (0,1), (1,2), (2,0)
    assert flops.circuit_flops(cz.circuit_gates(3, 1), 3) == 6 * 128 + 3 * 48 + 3 * 12


def _at(name: str, size: str):
    from conftest import small_cell
    from lib.spec import load

    return small_cell(name) if size == "small" else load(name)


@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_the_counted_widths_are_the_models(monkeypatch, name, size):
    # each cell's own system holds the model it builds to the widths that
    # its configuration's reference states (and the counts use): the build
    # passes, and stops once a stated width is one wider than the model's
    from lib import spec

    cell = _at(name, size)
    cpu = torch.device("cpu")
    spec.system(cell.traffic).build(cell.config, cell.traffic, 5, cpu)
    stated = spec.reference

    def one_wider(config_name):
        ref = stated(config_name)
        dims = ref.mlp_dims
        ref.mlp_dims = lambda cfg: {k: v[:-1] + (v[-1] + 1,) for k, v in dims(cfg).items()}
        return ref

    monkeypatch.setattr(spec, "reference", one_wider)
    with pytest.raises(SystemExit):
        spec.system(cell.traffic).build(cell.config, cell.traffic, 5, cpu)


@pytest.mark.parametrize("size", ["small", "full"])
def test_the_hand_counted_widths_of_cz_hybrid16q(size):
    from lib.spec import system
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN

    cell = _at("cz16-pretrain-b256", size)
    cfg = cell.config
    model = Hybrid16QPINN(cfg["n_qubits"], cfg["n_layers"], remat=False,
                          width=cfg["trunk_width"], device="cpu")
    entry = system(cell.traffic)
    entry.check_widths(model, cfg)  # the run's own check passes
    n, w = cfg["n_qubits"], cfg["trunk_width"]
    assert entry.model_widths(model) == {
        "coord_proj": (50, w, w), "res1": (w, w, w), "res2": (w, w, w),
        "to_quantum": (w, 64, n), "classical_skip": (w, 64), "post": (64 + n + 2, 128, 64, 5)}
    for key, value in (("to_quantum", 32), ("res_blocks", 3), ("post", [128, 64, 4]),
                       ("fourier_features", 16)):
        with pytest.raises(SystemExit):
            entry.check_widths(model, {**cfg, key: value})
