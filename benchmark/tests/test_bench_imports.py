"""The import rule: nothing the benchmark runs loads JAX or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the references load nothing of the port."""

import json
import os
import subprocess
import sys

import pytest

from conftest import WORKLOADS
from lib.spec import BENCH_DIR

ROOT = os.path.dirname(BENCH_DIR)
JAX_SIDE = {"jax", "jaxlib", "flax", "qcpinn_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PRELUDE = (f"import sys; sys.path[:0] = [{os.path.join(BENCH_DIR, 'reference')!r}, "
           f"{BENCH_DIR!r}, {ROOT!r}]\n")


@pytest.mark.parametrize("cell", sorted(WORKLOADS))
def test_a_run_loads_no_jax(cell):
    # a whole run of each cell at a small size on the CPU, traced, through
    # the harness's own entry; then every module it holds
    code = PRELUDE + (
        "import torch, run\n"
        "sys.path.insert(0, " + repr(os.path.join(BENCH_DIR, "tests")) + ")\n"
        "from conftest import small_cell\n"
        f"run.measure(small_cell({cell!r}), 7, 0.1, True, torch.device('cpu'))\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n")
    names = _loaded(code)
    assert "qcpinn_tpu_torch" in names  # the port did run
    assert not names & JAX_SIDE, names & JAX_SIDE


def test_the_references_load_nothing_of_the_program():
    refs = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "reference"))
                  if f.endswith(".py"))
    code = PRELUDE + "".join(f"import {r}\n" for r in refs)
    names = _loaded(code)
    assert set(refs) <= names
    assert not names & (JAX_SIDE | {"qcpinn_tpu_torch"}), names
