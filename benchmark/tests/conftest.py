"""Tests of the benchmark. On the CPU they run the harness, the plain
references and the program at small sizes; the tests marked ``chip`` need
the card and skip without it (the fixture decides, never an import).

The sizes a test runs a cell at are data, found by name like everything
else of the benchmark: ``sizes/configs/<config>.json`` and
``sizes/traffic/<mix>.json``, each ``{"small": {...}, "on_card": {...}}``,
the keys that replace the file's own. So a configuration or a traffic mix
joins the tests with files alone, and the tests that run every cell take
their cells from ``BENCHMARK.json``."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH, os.path.join(BENCH, "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)

SIZES = os.path.join(BENCH, "tests", "sizes")
with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
    WORKLOADS = {w["name"]: w for w in json.load(f)["workloads"]}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card; skips without it")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


def sizes_file(kind: str, name: str) -> str:
    """The sizes file of configuration or traffic mix ``name`` (``kind``
    is ``configs`` or ``traffic``)."""
    return os.path.join(SIZES, kind, f"{name}.json")


def sizes_of(kind: str, name: str, size: str) -> dict:
    """The keys that a test run at ``size`` replaces in the file of
    configuration or traffic mix ``name``: ``small``, or ``on_card`` on top
    of ``small``."""
    path = sizes_file(kind, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no test sizes for {name!r}: add "
            f"{os.path.relpath(path, os.path.dirname(BENCH))} holding "
            '{"small": {...}, "on_card": {...}}')
    with open(path) as f:
        found = json.load(f)
    return {**found["small"], **(found["on_card"] if size == "on_card" else {})}


def small_cell(name: str, size: str = "small"):
    """The cell of ``BENCHMARK.json`` at a size the CPU holds (``small``)
    or a larger one that is still quick on the card (``on_card``)."""
    from lib import spec

    cell = spec.load(name)
    w = WORKLOADS[name]
    cell.config.update(sizes_of("configs", w["config"], size))
    cell.traffic.update(sizes_of("traffic", w["traffic"], size))
    return cell
