#!/usr/bin/env python3
"""Benchmark of the PyTorch and CUDA port (``qcpinn_tpu_torch``) on one
NVIDIA H100: one cell of ``BENCHMARK.json``, run once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, in order: TF32 off (as the port runs); the cell's system built from
its configuration's and traffic mix's files, its weights and inputs drawn
on the device from ``--seed``; its first steps through the window's own
call (the warm-up and the CUDA graph's capture, and the readings that the
reference is held to) and the traffic's warm replays, which end the
set-up; more replays until the card launches graph nodes at its fast level
again (``lib/launch.py``, read by a probe graph before the program runs; the
wait is reported apart, as ``launch``); then ``--seconds`` of steps back to
back, each followed by a CUDA event. With ``--trace 1`` a profiled stretch
of replays and one profiled eager step (with the spans that
``spans/<system>/`` names around their calls) follow the window. Each
metric of the cell (end to end with ``--trace 0``, per layer with
``--trace 1``) is read by its own reader, ``metrics/<name>.py``. Then the
program is freed and the plain reference (``reference/<config>.py``)
follows the same first steps from the same weights and inputs. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace
1``), ``launch`` on the card, and last ``checks``, the numbers compared,
each beside its limit, which also end standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "qcpinn_tpu")


def _paths() -> None:
    for p in (os.path.join(BENCH, "reference"), BENCH, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def _caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the port's own nvcc outputs already land in its git-ignored
    ``ops/csrc/_build/``)."""
    cache = os.path.join(BENCH, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card() -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def measure(cell, seed: int, seconds: float, trace: bool, device, fault=None,
            t_start: float = T_START) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object
    and the numbers compared (also for the tests, which drive it on the
    CPU at a small size)."""
    import torch

    from lib import compare, launch, spec, window
    from lib import trace as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("start", t_start), ("imported", time.perf_counter())]
    # the card's fast launch level, read before the program has run
    probe = launch.Probe(device) if cuda else None
    marks.append(("the launch probe", time.perf_counter()))
    entry = spec.system(cell.traffic)
    marks.append(("the port imported", time.perf_counter()))
    system = entry.build(cell.config, cell.traffic, seed, device)
    sync()
    marks.append(("built", time.perf_counter()))
    mend = system.plant(fault) if fault else None
    prog = system.compared_steps()
    marks.append(("compared steps", time.perf_counter()))
    for _ in range(cell.traffic["warm_replays"]):
        system.step()
    sync()
    marks.append(("replays", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    # for a while after a capture the card can launch every graph node about
    # 0.2 us slower (lib/launch.py): a state of the card that ends at a random
    # moment, not work of the program. The window waits for the fast level;
    # the wait is reported apart from the set-up.
    settled = launch.settle(system.step, probe, launch.CAP_S) if probe is not None else None
    if settled is not None:
        print(f"launch mode: {settled['wait_s']:.3f} s and {settled['steps']} steps to the "
              f"{'fast level' if settled['fast'] else 'cap, STILL SLOW'}: probe "
              f"{settled['probe_us']:.4f} us a node against {settled['fast_us']:.4f}",
              file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = window.run(system.step, seconds, device)
    q, h = sorted(win["step_ms"]), sorted(win["host_ms"])
    print(f"window: {win['steps']} steps in {win['seconds']:.4f} s; step ms min {q[0]:.4f} "
          f"median {q[len(q) // 2]:.4f} max {q[-1]:.4f}; the host's call ms median "
          f"{h[len(h) // 2]:.4f} max {h[-1]:.4f}", file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    # a replay allocates nothing: its memory is the graph's pool, reserved
    window_reserved = torch.cuda.max_memory_reserved() if cuda else 0
    ctx = SimpleNamespace(system=system, window=win, setup_s=setup_s, replay=None, spans={},
                          window_reserved=window_reserved)
    if trace:
        ctx.replay = tr.replays(system.step, cell.traffic["profiled_steps"])
        ctx.spans = tr.span_device_ms(system.eager_step, system,
                                      spec.spans(cell.traffic["system"]))
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    replay = ctx.replay
    del ctx
    system.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = system.reference(device)
    if mend is not None:
        mend()
    values = compare.gaps(prog, ref)
    print("step losses, program / reference: " + ", ".join(
        f"{a:.9g} / {b:.9g}" for a, b in zip(prog["losses"], ref["losses"])), file=sys.stderr)
    limits = cell.limits
    correct = compare.judge(values, limits) and win["failed"] == 0
    result = {
        "correct": bool(correct),
        "attempted": win["steps"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "memory_peak_bytes": max(setup_peak, window_peak)},
    }
    if trace:
        result["device"]["busy_s"] = replay["busy_us"] * 1e-6
        result["device"]["window_s"] = replay["window_us"] * 1e-6
        result["breakdown"] = {"device_ops": [list(kv) for kv in replay["device_ops"]],
                               "idle_gaps": replay["idle_gaps"]}
    if settled is not None:
        result["launch"] = settled
    # the numbers compared, each beside its limit, under a key of their own
    # that comes last in the result line (and on standard error's last lines)
    result["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in compare.NAMES}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    _paths()
    from lib import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    result["device"] = {**card(), **result["device"]}
    for k, c in result["checks"].items():
        print(f"{k} {c['value']:.6e} limit {c['limit']:.6e}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
