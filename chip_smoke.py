#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (qcpinn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. device      the card, nvidia-smi's name and power limit, versions, TF32 off.
2. build       nvcc builds ops/csrc/block_chain.cu from the checkout.
3. kernel_shapes the other sizes ``auto`` sends to the kernels (n = 10, 11,
               12 with 3 layers; B = 37 and B = 1), and uneven block splits
               (a 128-wide block: the backward's matrix cotangent then has
               more 4x4 tiles than the CTA has threads) against the plain
               versions, same limits as below.
4. kernels     every block-chain kernel at the main path's shapes (12 qubits,
               B = 6144 stream rows and B = 682 value rows) against its plain
               PyTorch version on the same inputs: forward <= 2e-5 (unit-norm
               states), backward <= 2e-4 * max|ref| per output, reduction
               <= 1e-6 * max|ref|. Times from CUDA events (median of 20).
5. step_parity one 12-qubit train step through the kernels against the same
               step on the plain block engine: same params, same points; loss
               rtol 2e-5, every grad atol 2e-4 * max(|ref|, 1e-3).
6. train       the bench train step (12 qubits, B = 1024, hidden 50, lr 5e-3,
               seed 42) for 30 steps with the launch counters set to 0 just
               before: every loss finite, each kernel launched exactly twice
               a step (stream batch + value batch), no plain version called.

Then the kernel summary line, the nvidia-smi line, and the result line.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

STEPS = 30
TIME_REPS = 20
FWD_TOL = 2e-5
BWD_RTOL = 2e-4
RED_RTOL = 1e-6
N_QUBITS = 12

# dense FP32 (non-tensor) rate and memory rate from NVIDIA's data sheets
PEAKS = {
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60.0e12, 3.9e12),
    "H200": (67.0e12, 4.8e12),
    "H100": (67.0e12, 3.35e12),  # SXM
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def peaks(name: str):
    for key in ("PCIe", "NVL", "H200", "H100"):
        if key in name:
            return PEAKS[key]
    raise SystemExit(f"no peak table for card {name!r}")


def time_ms(fn, reps=TIME_REPS):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound(flops, nbytes, card_peaks):
    t_ops = flops / card_peaks[0] * 1e3
    t_bytes = nbytes / card_peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qcpinn_tpu_torch  # noqa: F401  (sets TF32 off)
    from qcpinn_tpu_torch import bench
    from qcpinn_tpu_torch.ops import block_kernel as bk
    from qcpinn_tpu_torch.ops.circuit import DVCircuit

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    tf32 = {
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    if tf32["cuda_matmul_allow_tf32"] or tf32["cudnn_allow_tf32"] or (
        tf32["float32_matmul_precision"] != "highest"
    ):
        raise SystemExit(f"TF32 is on: {tf32}")
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": tf32})
    card_peaks = peaks(name)

    # -- 2. build ----------------------------------------------------------
    path, seconds, report = bk.build()
    emit({"phase": "build", "source": "qcpinn_tpu_torch/ops/csrc/block_chain.cu",
          "seconds": seconds, "library": os.path.relpath(path),
          "ptxas": [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # -- 3. the other shapes auto sends to the kernels (10 <= n <= 12) ----
    gen = torch.Generator(device=dev).manual_seed(7)
    shape_errs = {}
    for n, layers, hb, b in ((10, 1, None, 37), (11, 1, None, 37),
                             (12, 3, None, 37), (12, 1, None, 1),
                             (12, 1, 7, 37), (12, 1, 5, 37), (10, 1, 7, 37)):
        eng = bk.BlockKernelCircuit(DVCircuit(n, layers, "cross_mesh", seed=42),
                                    hi_bits=hb)
        p = 0.3 * torch.randn(eng.circuit.num_params, generator=gen, device=dev)
        with torch.no_grad():
            m, ph = eng.kernel_inputs(p)
        hh, ll = 1 << eng.plan.hb, 1 << eng.plan.lb
        x = torch.randn(4, b, hh, ll, generator=gen, device=dev)
        nrm = torch.sqrt((x[0]**2 + x[1]**2).sum(dim=(1, 2), keepdim=True))
        xr, xi, gr, gi = (x[0] / nrm), (x[1] / nrm), x[2], x[3]
        mct = bk.conj_transpose(eng.plan, m)
        got = bk.block_chain_fwd(xr, xi, m, ph, eng.plan)
        want = bk.block_chain_fwd_ref(xr, xi, m, ph, eng.plan)
        e_fwd = max((a - r).abs().max().item() for a, r in zip(got, want))
        got = bk.block_chain_bwd(*got, gr.contiguous(), gi.contiguous(), mct, ph, eng.plan)
        want = bk.block_chain_bwd_ref(*want, gr, gi, mct, ph, eng.plan)
        e_bwd = max((a - r).abs().max().item() / r.abs().max().item()
                    for a, r in zip(got, want))
        tag = f"n{n}_hb{eng.plan.hb}_layers{layers}_B{b}"
        if not (e_fwd <= FWD_TOL and e_bwd <= BWD_RTOL):
            raise SystemExit(f"{tag}: fwd {e_fwd} bwd {e_bwd}")
        shape_errs[tag] = {"fwd_abs": e_fwd, "bwd_rel": e_bwd}
    emit({"phase": "kernel_shapes", "results": shape_errs})

    # -- 4. kernels vs plain versions at the main path's shapes ------------
    circ = DVCircuit(N_QUBITS, 1, "cross_mesh", seed=42)
    eng = bk.BlockKernelCircuit(circ)
    plan = eng.plan
    params = 0.3 * torch.randn(circ.num_params, generator=gen, device=dev)
    with torch.no_grad():
        m, p = eng.kernel_inputs(params)
    mct = bk.conj_transpose(plan, m)
    mats, phases = bk.unpack(plan, m, p)
    h, l = 1 << plan.hb, 1 << plan.lb
    mats_bytes = 4 * m.numel()
    ph_bytes = 4 * p.numel()
    mat_flops = sum(8 * h * l * plan.mat_dim(i) for i in range(plan.n_mats))

    def lib_chain(xc, mats_c, ph_c):
        s = xc
        for st in plan.steps:
            if st.kind == "mat":
                eq = "bkl,km->bml" if st.axis == "hi" else "bhk,km->bhm"
                s = torch.einsum(eq, s, mats_c[st.idx])
            else:
                s = s * ph_c[st.idx]
        return s

    mats_c = [torch.complex(mr, mi) for mr, mi in mats]
    ph_c = [torch.complex(c, s) for c, s in phases]
    per_kernel = {"block_chain_fwd": {}, "block_chain_bwd": {},
                  "block_chain_reduce": {}}
    for b in (6 * 1024, 2 * (1024 // 3)):
        xr = torch.randn(b, h, l, generator=gen, device=dev)
        xi = torch.randn(b, h, l, generator=gen, device=dev)
        nrm = torch.sqrt((xr**2 + xi**2).sum(dim=(1, 2), keepdim=True))
        xr, xi = (xr / nrm).contiguous(), (xi / nrm).contiguous()
        gr = torch.randn(b, h, l, generator=gen, device=dev)
        gi = torch.randn(b, h, l, generator=gen, device=dev)

        # K1 forward
        yr, yi = bk.block_chain_fwd(xr, xi, m, p, plan)
        ryr, ryi = bk.block_chain_fwd_ref(xr, xi, m, p, plan)
        torch.cuda.synchronize()
        err = max((yr - ryr).abs().max().item(), (yi - ryi).abs().max().item())
        if not err <= FWD_TOL:
            raise SystemExit(f"block_chain_fwd B={b}: max abs err {err} > {FWD_TOL}")
        xc = torch.complex(xr, xi)
        state_bytes = 4 * b * h * l
        fb, fby = bound(b * (mat_flops + 6 * h * l * plan.n_diags),
                        4 * state_bytes + mats_bytes + ph_bytes, card_peaks)
        per_kernel["block_chain_fwd"][b] = {
            "max_abs_err": err, "tol": FWD_TOL,
            "ms": time_ms(lambda: bk.block_chain_fwd(xr, xi, m, p, plan)),
            "plain_ms": time_ms(
                lambda: bk.block_chain_fwd_ref(xr, xi, m, p, plan)),
            "library_ms": time_ms(lambda: lib_chain(xc, mats_c, ph_c)),
            "bound_ms": fb, "bound_by": fby,
        }

        # K2 backward (kernel alone) + the reduction
        gxr, gxi, partials = bk.block_chain_bwd_partials(
            yr, yi, gr, gi, mct, p, plan)
        red = bk.block_chain_reduce(partials)
        out = bk.block_chain_bwd_ref(ryr, ryi, gr, gi, mct, p, plan)
        red_ref = bk.block_chain_reduce_ref(partials)
        got = bk.block_chain_bwd(yr, yi, gr, gi, mct, p, plan)
        torch.cuda.synchronize()
        # gx, then each mat's and each phase plane's cotangent on its own
        got_m, got_p = bk.unpack(plan, got[2], got[3])
        out_m, out_p = bk.unpack(plan, out[2], out[3])
        pairs = [(got[0], out[0]), (got[1], out[1])]
        pairs += [(a, r) for ga, ra in zip(got_m + got_p, out_m + out_p)
                  for a, r in zip(ga, ra)]
        worst, err = 0.0, 0.0
        for a, r in pairs:
            e = (a - r).abs().max().item()
            scale = r.abs().max().item()
            if not e <= BWD_RTOL * scale:
                raise SystemExit(
                    f"block_chain_bwd B={b}: err {e} > {BWD_RTOL} * {scale}")
            err = max(err, e)
            worst = max(worst, e / scale)
        red_err = (red - red_ref).abs().max().item()
        red_scale = red_ref.abs().max().item()
        if not red_err <= RED_RTOL * red_scale:
            raise SystemExit(f"block_chain_reduce: err {red_err} vs {red_scale}")
        if not torch.equal(gxr, got[0]):
            raise SystemExit("block_chain_bwd is not deterministic")
        slab = partials.shape[1]
        bb, bby = bound(3 * b * mat_flops + 20 * b * h * l * plan.n_diags,
                        6 * state_bytes + mats_bytes + ph_bytes + 4 * slab,
                        card_peaks)
        xg = xc.clone().requires_grad_(True)
        mg = [m.clone().requires_grad_(True) for m in mats_c]
        pg = [p.clone().requires_grad_(True) for p in ph_c]
        gc = torch.complex(gr, gi)
        # the library's backward alone: its graph is built once, outside
        # the timed calls, as the kernel's forward is outside K2's time
        y_lib = lib_chain(xg, mg, pg)

        def lib_bwd():
            return torch.autograd.grad(y_lib, [xg, *mg, *pg], grad_outputs=gc,
                                       retain_graph=True)

        per_kernel["block_chain_bwd"][b] = {
            "max_abs_err": err, "max_rel_err": worst, "tol": f"{BWD_RTOL}*max|ref|",
            "ms": time_ms(lambda: bk.block_chain_bwd_partials(
                yr, yi, gr, gi, mct, p, plan)),
            "plain_ms": time_ms(lambda: bk.block_chain_bwd_ref(
                ryr, ryi, gr, gi, mct, p, plan)),
            "library_ms": time_ms(lib_bwd),
            "library": "autograd backward alone of the complex einsum chain",
            "bound_ms": bb, "bound_by": bby, "grid": partials.shape[0],
        }
        g = partials.shape[0]
        rb, rby = bound(g * slab, 4 * (g + 1) * slab, card_peaks)
        per_kernel["block_chain_reduce"][b] = {
            "max_abs_err": red_err, "tol": f"{RED_RTOL}*max|ref|",
            "ms": time_ms(lambda: bk.block_chain_reduce(partials)),
            "plain_ms": time_ms(lambda: bk.block_chain_reduce_ref(partials)),
            "library_ms": time_ms(lambda: torch.sum(partials, dim=0)),
            "bound_ms": rb, "bound_by": rby, "shape": [g, slab],
        }
    emit({"phase": "kernels", "n_qubits": N_QUBITS, "card": smi,
          "results": per_kernel})

    # -- 5. one train step: kernels vs the plain block engine --------------
    kern = bench.build(backend="block_kernel")
    plain = bench.build(backend="block")
    plain.model.load_state_dict(kern.model.state_dict())
    points = kern.sample()
    grads = {}
    losses = {}
    for tag, tr in (("kernel", kern), ("plain", plain)):
        tr.model.zero_grad(set_to_none=True)
        loss = bench.bench_loss(tr.model, *points)
        loss.backward()
        losses[tag] = loss.item()
        grads[tag] = {k: p.grad.detach().clone()
                      for k, p in tr.model.named_parameters()}
    if not math.isclose(losses["kernel"], losses["plain"], rel_tol=2e-5):
        raise SystemExit(f"step loss {losses}")
    worst = {}
    for k, ref in grads["plain"].items():
        scale = max(ref.abs().max().item(), 1e-3)
        e = (grads["kernel"][k] - ref).abs().max().item()
        if not e <= 2e-4 * scale:
            raise SystemExit(f"step grad {k}: {e} > 2e-4 * {scale}")
        worst[k] = e / scale
    emit({"phase": "step_parity", "loss_kernel": losses["kernel"],
          "loss_plain": losses["plain"],
          "max_grad_err_over_scale": max(worst.values())})
    del kern, plain, grads

    # -- 6. the main path: the bench train step ----------------------------
    trainer = bench.build()
    if not isinstance(trainer.model._fused, bk.BlockKernelCircuit):
        raise SystemExit(f"auto picked {type(trainer.model._fused).__name__}")
    for _ in range(3):
        trainer.step()
    torch.cuda.synchronize()
    bk.reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.step() for _ in range(STEPS)]
    losses = torch.stack(losses).tolist()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    for k in ("block_chain_fwd", "block_chain_bwd", "block_chain_reduce"):
        if launches[k] != 2 * STEPS:
            raise SystemExit(f"{k}: {launches[k]} launches in {STEPS} steps")
    for k in ("block_chain_fwd_ref", "block_chain_bwd_ref", "block_chain_reduce_ref"):
        if launches[k] != 0:
            raise SystemExit(f"plain version {k} ran {launches[k]} times")
    emit({"phase": "train", "steps": STEPS, "batch": trainer.batch,
          "points_per_sec": trainer.batch * STEPS / dt, "ms_per_step": 1e3 * dt / STEPS,
          "loss_first": losses[0], "loss_last": losses[-1],
          "launches": launches, "card": smi})

    sources = {
        "block_chain_fwd": "qcpinn_tpu/ops/block_pallas.py:189",
        "block_chain_bwd": "qcpinn_tpu/ops/block_pallas.py:222",
        "block_chain_reduce": "qcpinn_tpu/ops/block_pallas.py:241",
    }
    main_b = 6 * 1024
    kernels = []
    for k, by_b in per_kernel.items():
        r = by_b[main_b]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "qcpinn_tpu_torch/ops/csrc/block_chain.cu",
            "replaces": sources[k], "launches": launches[k],
            "max_abs_err": max(v["max_abs_err"] for v in by_b.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "batch": main_b,
            "by_batch": {str(bb): v for bb, v in by_b.items()},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
