"""The cell a run measures, found by name: its entry in ``BENCHMARK.json``,
its configuration's file, its traffic mix's file (``traffic/<mix>.json``),
its limits (``limits/<cell>.json``), the metrics it reports (a reader each,
``metrics/<name>.py``) and the spans of its system
(``spans/<system>/<span>.json``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: str = ROOT) -> Cell:
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise SystemExit(f"no workload named {cell!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=cell,
        chips=w["chips"],
        config=_read(os.path.join(root, cfg["file"])),
        traffic=_read(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
        limits=_read(os.path.join(BENCH_DIR, "limits", f"{cell}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, cell)],
    )


def system(traffic: dict):
    """The module that builds the program's step for a traffic mix's entry
    (``systems/<entry>.py``)."""
    entry = traffic["system"]
    return load_module(os.path.join(BENCH_DIR, "systems", f"{entry}.py"), f"bench_sys_{entry}")


def reader(metric: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{metric}.py"),
                       "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def reference(config_name: str):
    return load_module(os.path.join(BENCH_DIR, "reference", f"{config_name}.py"),
                       f"bench_ref_{config_name}")


def spans(entry: str) -> Dict[str, str]:
    """The spans that the profiled eager step puts around calls of a
    system's objects, by name: each file ``spans/<entry>/<span>.json`` holds
    ``attr``, the dotted path from the system object to the call."""
    folder = os.path.join(BENCH_DIR, "spans", entry)
    if not os.path.isdir(folder):
        return {}
    return {f[:-len(".json")]: _read(os.path.join(folder, f))["attr"]
            for f in sorted(os.listdir(folder)) if f.endswith(".json")}
