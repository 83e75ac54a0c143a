"""Tests of the benchmark. On the CPU they run the harness, the plain
references and the program at small sizes; the tests marked ``chip`` need
the card and skip without it (the fixture decides, never an import)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH, os.path.join(BENCH, "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)

# sizes a test run can hold: the qubits and the trunk, the widths that the
# port takes as parameters (the others it builds as published)
SMALL = {
    "cz_hybrid16q": ({"n_qubits": 4, "trunk_width": 8}, {"batch": 8, "warm_replays": 2}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card; skips without it")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


def small_cell(name: str):
    """The cell of ``BENCHMARK.json`` at a size the CPU holds."""
    from lib import spec

    cell = spec.load(name)
    cfg, traffic = SMALL[cell.config["name"]]
    cell.config.update(cfg)
    cell.traffic.update(traffic)
    return cell
