"""The gate-level counts against hand counts on 2- and 3-qubit circuits."""

import pytest

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


@pytest.mark.parametrize("size", ["small", "full"])
def test_the_counted_widths_are_the_models(size):
    from conftest import small_cell
    from lib.spec import load, system
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN

    cell = small_cell("cz16-pretrain-b256") if size == "small" else load("cz16-pretrain-b256")
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
