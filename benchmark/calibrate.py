#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process (no measured window: the readings are taken over the first steps):

- sound: the program's first steps against the plain reference, on every
  seed (the lower readings);
- control: the reference computed with TF32 on (the nearest precision below
  the float32 with TF32 off that the configurations state) against the
  reference as stated, on the first ``--controls`` seeds;
- half_batch: the program with half of each batch left out and the mean
  taken over the rest, against the reference, on the first ``--faults``
  seeds. (A step that leaves its state unchanged reads 1 by the
  ``update_gap``'s measure and needs no run.)

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3 --faults 3

One JSON line a reading, then one with every reading's largest and least.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(BENCH, "reference"), BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

from lib import compare, spec  # noqa: E402

SEED0 = 3_000_000_017  # beyond 32 signed bits: seeds that large must work


def readings(cell, seed, device, fault=None):
    system = spec.system(cell.traffic).build(cell.config, cell.traffic, seed, device)
    mend = system.plant(fault) if fault else None
    prog = system.compared_steps()
    system.free()
    gc.collect()
    torch.cuda.empty_cache()
    if mend is not None:
        mend()
    return system, prog


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args()
    cell = spec.load(args.workload)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = {}

    clock = [time.perf_counter()]

    def note(kind, seed, values):
        now = time.perf_counter()
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, **values,
                          "seconds": now - clock[0]}), flush=True)
        clock[0] = now
        found.setdefault(kind, []).append(values)

    for i in range(args.seeds):
        seed = SEED0 + 7919 * i
        system, prog = readings(cell, seed, device)
        ref = system.reference(device)
        note("sound", seed, compare.gaps(prog, ref))
        if i < args.controls:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            low = system.reference(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            note("control", seed, compare.gaps(low, ref))
        if i < args.faults:
            _, bad = readings(cell, seed, device, fault="half_batch")
            note("half_batch", seed, compare.gaps(bad, ref))
        del system
        gc.collect()
        torch.cuda.empty_cache()
    summary = {kind: {k: {"max": max(v[k] for v in vals), "min": min(v[k] for v in vals)}
                      for k in compare.NAMES} for kind, vals in found.items()}
    print(json.dumps({"cell": cell.name, "summary": summary,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
