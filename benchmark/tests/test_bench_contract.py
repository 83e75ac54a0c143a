"""BENCHMARK.json against the files the harness and its tests find by
name."""

import json
import os

from lib.spec import BENCH_DIR, load

ROOT = os.path.dirname(BENCH_DIR)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = load(w["name"])
        assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap"}
        assert os.path.exists(os.path.join(BENCH_DIR, "systems", cell.traffic["system"] + ".py"))
        assert os.path.exists(os.path.join(BENCH_DIR, "reference", cell.config["name"] + ".py"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_span_names_a_call_of_its_system():
    import functools

    import torch

    from conftest import small_cell
    from lib.spec import spans, system

    for w in BENCH["workloads"]:
        cell = small_cell(w["name"])
        built = system(cell.traffic).build(cell.config, cell.traffic, 5, torch.device("cpu"))
        paths = spans(cell.traffic["system"])
        assert paths
        for path in paths.values():
            assert callable(functools.reduce(getattr, path.split("."), built)), path


def test_configuration_files_are_the_named_ones():
    for c in BENCH["configs"]:
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]


def test_every_configuration_and_mix_has_its_test_sizes():
    from conftest import sizes_file

    for kind, key in (("configs", "config"), ("traffic", "traffic")):
        for name in {w[key] for w in BENCH["workloads"]}:
            path = sizes_file(kind, name)
            assert os.path.exists(path), f"add {os.path.relpath(path, ROOT)}"
            found = json.load(open(path))
            assert set(found) == {"small", "on_card"}, path


def test_metrics_name_only_cells_that_exist():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", ())) <= cells, m["name"]
