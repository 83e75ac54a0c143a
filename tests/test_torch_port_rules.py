"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to the card and raise without CUDA, and its
backend dispatch is a stated rule with no fallback."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import qcpinn_tpu_torch
from qcpinn_tpu_torch import bench, resolve_device
from qcpinn_tpu_torch.ops import backends, block_kernel as bk
from qcpinn_tpu_torch.ops import loop_kernel as lk
from qcpinn_tpu_torch.ops import sv_kernel as sk
from qcpinn_tpu_torch.ops.block_fused import BlockFusedCircuit
from qcpinn_tpu_torch.ops.circuit import DVCircuit

PKG_DIR = os.path.dirname(qcpinn_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="qcpinn_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "qcpinn_tpu_torch.ops.block_kernel" in mods and len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'optax' or k == 'qcpinn_tpu' or k.startswith('qcpinn_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax|import optax|from optax)"
                     r"|qcpinn_tpu\.", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_tf32_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.build(batch=8, n_qubits=4, hidden=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        backends.make_fused_backend(DVCircuit(4, 1, "cross_mesh"))
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.models.dv_fourier import DVFourierSolver

    with pytest.raises(RuntimeError, match="CUDA"):
        DVFourierSolver(QCPINNConfig(num_qubits=4))


def test_auto_rule_and_unported_backends():
    cm12 = DVCircuit(12, 1, "cross_mesh", seed=42)
    # the CPU always takes the plain engine
    assert type(backends.make_fused_backend(cm12, device="cpu")) is BlockFusedCircuit
    eng = backends.make_fused_backend(cm12, "block_kernel", device="cpu")
    assert isinstance(eng, bk.BlockKernelCircuit)
    assert isinstance(backends.make_fused_backend(cm12, "loop", device="cpu"),
                      lk.LoopFusedCircuit)
    assert isinstance(backends.make_fused_backend(cm12, "unrolled", device="cpu"),
                      sk.FusedCircuit)
    with pytest.raises(ValueError):
        backends.make_fused_backend(cm12, "block_pallas", device="cpu")
    with pytest.raises(ValueError):  # a ring ansatz straddles the cut
        backends.make_fused_backend(DVCircuit(6, 1, "cascade"), "block_kernel",
                                    device="cpu")


def test_auto_rule_on_the_card(monkeypatch):
    """Building an engine touches no device, so the rule is checkable here
    with CUDA reported present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for n, want in ((6, BlockFusedCircuit), (7, sk.FusedCircuit), (8, sk.FusedCircuit),
                    (9, sk.FusedCircuit), (10, bk.BlockKernelCircuit),
                    (12, bk.BlockKernelCircuit), (13, lk.LoopFusedCircuit),
                    (16, lk.LoopFusedCircuit)):
        eng = backends.make_fused_backend(DVCircuit(n, 1, "cross_mesh", seed=42))
        assert type(eng) is want, n
    ring = DVCircuit(12, 1, "cascade")
    assert type(backends.make_fused_backend(ring)) is BlockFusedCircuit
    # block_kernel takes 13-16 qubits on the card when asked for (the
    # cluster pair); the limit is 16
    for n in (13, 16):
        eng = backends.make_fused_backend(DVCircuit(n, 1, "cross_mesh", seed=42),
                                          "block_kernel")
        assert type(eng) is bk.BlockKernelCircuit and bk.uses_cluster_pair(eng.plan)
    with pytest.raises(ValueError, match="n <= 16"):
        backends.make_fused_backend(DVCircuit(17, 1, "cross_mesh"), "block_kernel")


def test_kernel_wrappers_refuse_unsupported_cuda_work():
    """The CUDA-side checks run before any library is loaded."""
    plan = bk.KPlan(17, 9, 8, (bk.KStep("mat", "hi", 0),), ((0, "hi"),), ())
    x = torch.zeros(2, 1, 1)
    e = torch.zeros(0)
    with pytest.raises(ValueError, match="n <= 16"):
        bk._check_cuda(plan, (x, x), e, e)
    plan13 = bk.BlockKernelCircuit(DVCircuit(13, 1, "cross_mesh", seed=42)).plan
    with pytest.raises(ValueError, match="CUDA float32"):
        bk._check_cuda(plan13, (torch.zeros(2, 128, 64),) * 2, e, e)
    plan12 = bk.BlockKernelCircuit(DVCircuit(12, 1, "cross_mesh", seed=42)).plan
    with pytest.raises(ValueError, match="CUDA float32"):
        bk._check_cuda(plan12, (torch.zeros(2, 64, 64),) * 2, e, e)
    with pytest.raises(ValueError, match="unsupported device"):
        bk.block_chain_fwd(torch.zeros(1, 64, 64, device="meta"), None, e, e, plan12)


def test_cpu_tensors_take_the_plain_version():
    circ = DVCircuit(10, 1, "cross_mesh", seed=42)
    eng = bk.BlockKernelCircuit(circ)
    params = torch.zeros(circ.num_params, requires_grad=True)
    state = torch.zeros(3, 1 << 10, dtype=torch.complex64)
    state[:, 0] = 1.0
    bk.reset_launches()
    out = eng.evolve(params, state)
    out.abs().sum().backward()
    assert bk.LAUNCHES == {**{k: 0 for k in bk.LAUNCHES},
                           "block_chain_fwd_ref": 1, "block_chain_bwd_ref": 1}
    assert out.shape == (3, 1 << 10) and params.grad is not None


def test_new_entry_points_raise_without_cuda(monkeypatch):
    from qcpinn_tpu_torch import north_star
    from qcpinn_tpu_torch.data import diffusion as dd
    from qcpinn_tpu_torch.utils.evaluation import evaluate_relative_l2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        north_star.run(north_star.parse_args(["--qubits", "4"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_relative_l2(lambda x: x[:, :1], dd.u, num=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        backends.make_fused_backend(DVCircuit(4, 1, "cascade"), "loop")


def test_train_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``cli.main``, ``train`` and the north-star classical run default to
    the card and raise without CUDA, before any run directory is made."""
    from qcpinn_tpu_torch import cli, north_star
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.data import gaussian_pulse_samplers
    from qcpinn_tpu_torch.models import ClassicalSolver
    from qcpinn_tpu_torch.physics import diffusion_operator
    from qcpinn_tpu_torch.train.loop import diffusion_terms, train

    cfg = QCPINNConfig(solver="Classical", classic_network=(3, 4, 1), epochs=1)
    model = ClassicalSolver(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--output-dir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        train(model, cfg, diffusion_terms(gaussian_pulse_samplers(), 6), diffusion_operator)
    with pytest.raises(RuntimeError, match="CUDA"):
        north_star.run(north_star.parse_args(["--solver", "classical"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassicalSolver(cfg)


def test_loop_backend_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = backends.make_fused_backend(DVCircuit(16, 1, "cross_mesh", seed=42), "loop")
    assert isinstance(eng, lk.LoopFusedCircuit) and eng.lp.table.shape == (37, 8)
    with pytest.raises(ValueError, match="n <= 16"):
        backends.make_fused_backend(DVCircuit(17, 1, "cascade"), "loop")


class _FakeCuda:
    """Stands in for a CUDA tensor: the checks read only these fields."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True):
        self.shape, self.dtype, self._c = tuple(shape), dtype, contiguous
        self.device = torch.device("cuda", 0)

    def is_contiguous(self):
        return self._c


def test_loop_wrappers_refuse_unsupported_cuda_work():
    """The CUDA-side checks run before any library is loaded."""
    lp17 = lk.compile_loop_program(DVCircuit(17, 1, "cascade"))
    x = torch.zeros(2, lp17.hi, lp17.lo)
    with pytest.raises(ValueError, match="n <= 16"):
        lk._check_cuda(lp17, (x, x), x, x, x, x)
    lp = lk.compile_loop_program(DVCircuit(10, 1, "cross_mesh", seed=42))
    st = _FakeCuda((3, lp.hi, lp.lo))
    m = _FakeCuda((lp.num_mats, 8))
    u4 = _FakeCuda(lp.u4_bank.shape)
    ph = _FakeCuda((lp.num_phases, lp.hi, lp.lo))
    lk._check_cuda(lp, (st, st), m, u4, ph, ph)  # a well-formed call passes
    with pytest.raises(ValueError, match="CUDA float32"):
        lk._check_cuda(lp, (torch.zeros(3, lp.hi, lp.lo),) * 2, m, u4, ph, ph)
    with pytest.raises(ValueError, match="CUDA float32"):
        lk._check_cuda(lp, (_FakeCuda(st.shape, torch.float64), st), m, u4, ph, ph)
    with pytest.raises(ValueError, match="contiguous"):
        lk._check_cuda(lp, (st, _FakeCuda(st.shape, contiguous=False)), m, u4, ph, ph)
    with pytest.raises(ValueError, match="expected"):
        lk._check_cuda(lp, (st, st), _FakeCuda((lp.num_mats + 1, 8)), u4, ph, ph)
    with pytest.raises(ValueError, match="unsupported device"):
        lk.gate_loop_fwd(torch.zeros(1, lp.hi, lp.lo, device="meta"), None, None,
                         None, None, None, lp)
    assert lk._LIB is None


def test_loop_cpu_tensors_take_the_plain_version():
    circ = DVCircuit(10, 1, "cascade", seed=42)
    eng = lk.LoopFusedCircuit(circ)
    params = torch.zeros(circ.num_params, requires_grad=True)
    state = torch.zeros(3, 1 << 10, dtype=torch.complex64)
    state[:, 0] = 1.0
    lk.reset_launches()
    out = eng.evolve(params, state)
    out.abs().sum().backward()
    assert lk.LAUNCHES == {**{k: 0 for k in lk.LAUNCHES},
                           "gate_loop_fwd_ref": 1, "gate_loop_bwd_ref": 1}
    assert out.shape == (3, 1 << 10) and params.grad is not None


def test_unrolled_backend_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = backends.make_fused_backend(DVCircuit(12, 1, "cascade", seed=11), "unrolled")
    assert isinstance(eng, sk.FusedCircuit) and len(eng.mp.steps) == 40
    with pytest.raises(ValueError, match="n <= 12"):
        backends.make_fused_backend(DVCircuit(13, 1, "cross_mesh"), "unrolled")


def test_unrolled_wrappers_refuse_unsupported_cuda_work():
    """The CUDA-side checks run before any library is loaded."""
    mp13 = sk.compile_circuit(DVCircuit(13, 1, "cross_mesh"))
    x = torch.zeros(2, 1 << 13)
    with pytest.raises(ValueError, match="n <= 12"):
        sk._check_cuda(mp13, (x, x), x, x, x, x, x)
    mp = sk.compile_circuit(DVCircuit(8, 1, "cascade", seed=11))
    d = 1 << 8
    st = _FakeCuda((3, d))
    m = _FakeCuda((3, mp.num_mats, 2, 2))
    ph = _FakeCuda((mp.num_phases, d))
    u4 = _FakeCuda((len(mp.u4s), 32))
    sk._check_cuda(mp, (st, st), m, m, ph, ph, u4)  # a well-formed call passes
    with pytest.raises(ValueError, match="CUDA float32"):
        sk._check_cuda(mp, (torch.zeros(3, d),) * 2, m, m, ph, ph, u4)
    with pytest.raises(ValueError, match="CUDA float32"):
        sk._check_cuda(mp, (_FakeCuda(st.shape, torch.float64), st), m, m, ph, ph, u4)
    with pytest.raises(ValueError, match="contiguous"):
        sk._check_cuda(mp, (st, _FakeCuda(st.shape, contiguous=False)), m, m, ph, ph, u4)
    with pytest.raises(ValueError, match="mre: expected"):
        sk._check_cuda(mp, (st, st), _FakeCuda((3, mp.num_mats + 1, 2, 2)), m, ph, ph, u4)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.unrolled_fwd(torch.zeros(1, d, device="meta"), None, None, None, None,
                        None, None, mp)
    assert sk._LIB is None


def test_unrolled_cpu_tensors_take_the_plain_version():
    circ = DVCircuit(8, 1, "cascade", seed=11)
    eng = sk.FusedCircuit(circ)
    params = torch.zeros(circ.num_params, requires_grad=True)
    x = torch.rand(3, 8, requires_grad=True)
    sk.reset_launches()
    out = eng.apply(params, x)
    out.sum().backward()
    assert sk.LAUNCHES == {**{k: 0 for k in sk.LAUNCHES},
                           "unrolled_fwd_ref": 1, "unrolled_bwd_ref": 1}
    assert out.shape == (3, 8) and params.grad is not None and x.grad is not None


def test_unrolled_bwd_routes_by_qubits(monkeypatch):
    """K4 takes its warp route at n <= 9 and its CTA route above; each
    route's checks run before any library is loaded."""
    seen = []
    for name in ("unrolled_bwd_warp_partials", "unrolled_bwd_cta_partials"):
        monkeypatch.setattr(sk, name, lambda *a, _n=name: seen.append(_n))
    for n in (1, 8, 9, 10, 12):
        mp = sk.compile_circuit(DVCircuit(n, 1, "cross_mesh", seed=42))
        sk.unrolled_bwd_partials(*[None] * 9, mp)
    assert seen == ["unrolled_bwd_warp_partials"] * 3 + ["unrolled_bwd_cta_partials"] * 2
    monkeypatch.undo()
    mp = sk.compile_circuit(DVCircuit(10, 1, "cross_mesh", seed=42))
    d = 1 << 10
    st = _FakeCuda((3, d))
    m = _FakeCuda((3, mp.num_mats, 2, 2))
    ph = _FakeCuda((mp.num_phases, d))
    u4 = _FakeCuda((len(mp.u4s), 32))
    with pytest.raises(ValueError, match="n <= 9"):
        sk.unrolled_bwd_warp_partials(st, st, st, st, m, m, ph, ph, u4, mp)
    # a warp's [2, K, 2, 2] matrix cotangents and matrices and [2, P, 2^n]
    # phase cotangents, the CTA's phase rows and 4x4s, in bytes
    assert sk.warp_smem(8, 25, 2, 2) == (4 * (16 * 25 + 2 * 2 * 256), 4 * (2 * 2 * 256 + 64))
    with pytest.raises(ValueError, match="shared bytes a warp"):
        sk.warp_config(torch.device("cuda", 0), 9, 10, 40, 2, 37)
    assert sk._LIB is None


def test_warp_route_takes_the_cta_size_that_keeps_most_warps(monkeypatch):
    """Of 8, 4 and 2 warps a CTA the warp route takes the one the SM holds
    most warps of (ties to the larger), with a grid that covers the batch
    at most once."""
    resident = {8: 1, 4: 3, 2: 6}  # CTAs an SM: 8, 12, 12 warps

    def blocks(dev, n, warps, smem, bwd):
        assert bwd
        assert smem == warps * sk.warp_smem(n, 25, 2, 2)[0] + sk.warp_smem(n, 25, 2, 2)[1]
        return resident[warps]

    monkeypatch.setattr(sk, "_warp_blocks", blocks)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    dev = torch.device("cuda", 0)
    assert sk.warp_config(dev, 8, 25, 2, 2, 6144)[::2] == (4, 396)
    assert sk.warp_config(dev, 8, 25, 2, 2, 682)[::2] == (4, 171)
    resident.update({8: 2, 4: 4})  # 16 warps either way: the larger CTA
    assert sk.warp_config(dev, 8, 25, 2, 2, 6144)[::2] == (8, 264)


HW_MODULES = ("ops.measure", "train.hardware_grad", "train.spsa", "train.staged",
              "train.lbfgs")


def _public(mod):
    import inspect

    return {k for k, v in vars(mod).items() if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def test_hardware_modules_have_the_jax_names():
    import importlib

    for name in HW_MODULES:
        want = _public(importlib.import_module(f"qcpinn_tpu.{name}"))
        got = _public(importlib.import_module(f"qcpinn_tpu_torch.{name}"))
        assert want <= got, (name, sorted(want - got))
    from qcpinn_tpu import ops as jops, train as jtrain
    from qcpinn_tpu_torch import ops as tops, train as ttrain

    assert set(jops.__all__) <= set(tops.__all__)
    assert set(jtrain.__all__) <= set(ttrain.__all__)


def test_no_refusal_names_the_hardware_modes():
    """Every NotImplementedError of the port names an item still to come;
    none names the hardware-fidelity modes, which are ported."""
    refusal = re.compile(r"NotImplementedError\((?:[^()]|\([^()]*\))*\)", re.S)
    seen = 0
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for m in refusal.finditer(fh.read()):
                        seen += 1
                        assert "hardware-fidelity" not in m.group(0), (f, m.group(0))
    assert seen >= 4  # the CV solver, parallel (train, cz, the Cz model), crystal


def test_hardware_modes_default_to_the_card(monkeypatch, tmp_path):
    from qcpinn_tpu_torch import cli
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.models import DVSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (["--gradient-mode", "spsa"], ["--gradient-mode", "parameter-shift"],
                  ["--noise-per-gate", "0.01", "--shots", "64"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["train", *flags, "--output-dir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        DVSolver(QCPINNConfig(num_qubits=3, noise_depolarizing=0.1))


def test_cz_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``cli cz``, the Cz model, its evaluation and its plots default to the
    card and raise without CUDA, before any run directory is made; they run
    on the CPU only when asked (``device="cpu"``)."""
    import numpy as np

    from qcpinn_tpu_torch import cli
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from qcpinn_tpu_torch.utils.evaluation import evaluate_cz_fields
    from qcpinn_tpu_torch.utils.plotting import plot_cz_diagnostics

    model = Hybrid16QPINN(2, 1, width=4, device="cpu")
    X, Y = np.zeros((3, 2), np.float32), np.zeros((3, 5), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = os.path.join(REPO, "data", "cz_melt_synthetic.txt")
    for phase in ("pretrain", "finetune", "eval"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["cz", "--phase", phase, "--data", data, "--save", str(tmp_path / "c"),
                      "--output-dir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        Hybrid16QPINN(2, 1, width=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_cz_fields(model, X, Y)
    with pytest.raises(RuntimeError, match="CUDA"):
        plot_cz_diagnostics(model, X, Y, str(tmp_path))
    m = evaluate_cz_fields(model, X, Y, batch=2, device="cpu")
    assert set(m) == {"val_mse", "rel_l2_u_r_percent", "rel_l2_u_z_percent",
                      "rel_l2_u_theta_percent", "rel_l2_p_percent", "rel_l2_T_percent"}
