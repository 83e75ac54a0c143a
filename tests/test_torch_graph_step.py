"""The pieces that let the port capture a train step in a CUDA graph, on the
CPU at toy size: the device-count Adam against optax, the static in-place
step against the functional step, the north-star stages' ``run_steps``
against their ``step_fn``, the samplers with cached bounds, the cached
diagonal-run constants against the JAX package, and a step that builds no
tensor from host data once its constants exist."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.overrides import TorchFunctionMode

from qcpinn_tpu.ops import diag_fusion as j_diag
from qcpinn_tpu.ops.program import Op as JOp
from qcpinn_tpu.train import optim as jopt
from qcpinn_tpu_torch import bench, north_star as ns
from qcpinn_tpu_torch.data import diffusion as tdd
from qcpinn_tpu_torch.ops import diag_fusion as t_diag
from qcpinn_tpu_torch.ops.program import Op as TOp
from qcpinn_tpu_torch.physics.operators_fwd import diffusion_operator_fwd
from qcpinn_tpu_torch.physics.streams import dv_diffusion_residual_streams
from qcpinn_tpu_torch.train import optim as topt
from qcpinn_tpu_torch.train.loop import make_train_step, static_step


def test_device_count_adam_with_cosine_matches_optax():
    """50 clipped-Adam steps with a cosine horizon of 30 (so the schedule
    reaches its floor) against the JAX make_optimizer; the count lives on
    the device and the state updates in place."""
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    kw = dict(grad_clip=1.0, schedule="cosine", epochs=30)
    jo, to = jopt.make_optimizer(5e-3, **kw), topt.make_optimizer(5e-3, **kw)
    jp = [jnp.asarray(a) for a in p0]
    js = jo.init(jp)
    tp = [torch.tensor(a) for a in p0]
    ts = to.init(tp)
    mu0 = ts.mu[0]
    for k in range(50):
        g = [(3.0 if k % 3 == 0 else 0.2) * rng.normal(size=a.shape).astype(np.float32)
             for a in p0]
        upd, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts2 = to.update([torch.tensor(a) for a in g], ts, tp)
        assert ts2 is ts and ts.mu[0] is mu0
        topt.apply_updates(tp, tu)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 50


def test_cosine_schedule_on_a_device_count():
    sched = topt.cosine_decay_schedule(5e-3, 7)
    want = optax.cosine_decay_schedule(5e-3, decay_steps=7)
    for k in range(10):
        got = sched(torch.tensor(k, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want(k)), rtol=1e-6, atol=1e-12)


def _toy(scheduler: str):
    args = ns.parse_args(
        "--qubits 4 --batch 12 --hidden 4 --mapping 2 --skip-dim 2 --rbf 2 "
        "--backend loop".split())
    cfg, model, _, backend = ns.build_model(args, "cpu")
    cfg = type(cfg)(**{**cfg.__dict__, "scheduler": scheduler, "plateau_patience": 2})
    ns.set_engine(model, args, backend)
    return args, cfg, model


@pytest.mark.parametrize("scheduler", ["cosine", "plateau"])
def test_static_step_matches_the_functional_step(scheduler):
    """20 steps of the static, in-place step (what a graph captures)
    against 20 of the functional step_fn on a copy of the model: the loss
    trace and the parameters agree within 1e-6."""
    runs = []
    for static in (False, True):
        args, cfg, model = _toy(scheduler)
        opt = topt.make_optimizer(5e-3, grad_clip=1.0, schedule=cfg.scheduler, epochs=20)
        params = [p for p in model.parameters() if p.requires_grad]
        state, sched = opt.init(params), topt.plateau_init("cpu")
        step_fn, _ = make_train_step(
            model, diffusion_operator_fwd, ns.make_terms(args), opt, cfg,
            residual_fn=lambda X, m=model: dv_diffusion_residual_streams(m, X),
            fuse_value_terms=True)
        gen = torch.Generator().manual_seed(3)
        losses = []
        if static:
            step, names = static_step(step_fn, params, state, sched, gen)
            for _ in range(20):
                losses.append(float(step()[names.index("loss")]))
        else:
            for _ in range(20):
                state, sched, m = step_fn(params, state, sched, gen)
                losses.append(float(m["loss"]))
        runs.append((losses, [p.detach().clone() for p in params], sched))
    (l_ref, p_ref, s_ref), (l_got, p_got, s_got) = runs
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(p_got, p_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    for a, b in zip(s_got, s_ref):
        assert float(a) == float(b)
    if scheduler == "plateau":
        assert float(s_got.scale) < 1.0  # the plateau tripped: the copy-in was exercised


@pytest.mark.parametrize("label", ["stage1", "stage2"])
def test_run_steps_matches_step_fn(label):
    """A north-star stage (``make_stage``, as ``north_star.run`` sets it
    up) through ``run_steps`` in two chunks (5 + 8 steps: the second call
    reuses the first's binding) against 13 calls of its ``step_fn`` on a
    model from the same seed: the loss trace and the parameters agree
    within 1e-6, and the state comes back as it was bound."""
    runs = []
    for chunked in (False, True):
        args, cfg, model = _toy("cosine")
        stage = ns.make_stage(model, cfg, args, ns.make_terms(args), label,
                              "loop", use_streams=True)
        if chunked:
            bound = (stage.opt_state, stage.sched)
            trace = [stage.run(5), stage.run(8)]
            assert (stage.opt_state, stage.sched) == bound
            assert stage.run_steps.captured is None  # eager on the CPU
            losses = torch.cat([t["loss"] for t in trace]).tolist()
            assert set(trace[0]) == {"res", "ic", "bcx0", "bcx1", "bcy0", "bcy1",
                                     "loss", "lr_scale"}
        else:
            losses = [float(stage.step()["loss"]) for _ in range(13)]
        runs.append((losses, [p.detach().clone() for p in stage.params]))
    (l_ref, p_ref), (l_got, p_got) = runs
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(p_got, p_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _draw_building_bounds(sampler, gen, n):
    """The draw as it was before the bounds were cached: every bound built
    from the sampler's numpy fields on each call."""
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None, :])  # noqa: E731
    lo, hi = T(sampler.coords[0]), T(sampler.coords[1])
    if isinstance(sampler, tdd.Sampler):
        x = lo + (hi - lo) * torch.rand((n, sampler.dim), generator=gen)
        return x, sampler.func(x)
    x_uni = lo + (hi - lo) * torch.rand((n, sampler.dim), generator=gen)
    mu, sd = T(sampler.focus), T(sampler.sigma)
    x_foc = torch.minimum(torch.maximum(mu + sd * torch.randn((n, sampler.dim), generator=gen),
                                        lo), hi)
    rows = torch.arange(n, dtype=torch.float32)[:, None]
    x = torch.where((rows < sampler.frac * n) & (sd > 0.0), x_foc, x_uni)
    return x, sampler.func(x)


@pytest.mark.parametrize("kind", ["box", "wall", "pulse"])
def test_cached_samplers_draw_bit_equal(kind):
    sampler = {
        "box": tdd.Sampler(tdd._box([[0, 0, 0], [1, 1, 1]]), tdd.r_true),
        "wall": tdd.Sampler(tdd._box([[0, 1, 0], [1, 1, 1]]), tdd.u),
        "pulse": tdd.pulse_residual_sampler(frac=0.5, sigma=0.12),
    }[kind]
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for n in (7, 64, 64):  # the second 64-draw reads the cache
        x, y = sampler.sample(g1, n)
        xw, yw = _draw_building_bounds(sampler, g2, n)
        assert torch.equal(x, xw) and torch.equal(y, yw)
    assert len(sampler.__dict__["_on_device"]) == 1


def _run_pair(ops, n):
    return (t_diag._make_run(n, [TOp(*o) for o in ops]),
            j_diag._make_run(n, [JOp(*o) for o in ops]))


@pytest.mark.parametrize("n", [3, 5])
def test_diag_run_cached_phases_match_jax(n):
    """A run with every term kind (RZ, PhaseShift, CRZ, CZ) on cached
    constants against the JAX DiagRun, unbatched and batched, twice (the
    second call reads the cache)."""
    ops = [("rz", (0,), (0,)), ("ps", (n - 1,), (1,)), ("crz", (1, 2), (2,)),
           ("cz", (0, n - 1)), ("rz", (2,), (0,)), ("crz", (n - 1, 0), (3,))]
    trun, jrun = _run_pair(ops, n)
    rng = np.random.default_rng(n)
    for shape in ((5,), (4, 5)):
        params = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jrun.phases(jnp.asarray(params)))
        for _ in range(2):
            got = trun.phases(torch.as_tensor(params)).numpy()
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-6)
    consts = trun.constants("cpu")
    assert trun.constants("cpu") is consts and set(consts) == {
        "bits_t", "w1", "c1", "pidx", "pair", "ks", "cvec"}


class _HostData(TorchFunctionMode):
    """Records each tensor built from host data: ``torch.tensor`` and
    ``torch.as_tensor`` of anything but a tensor, and indexing with a list
    or an array (both copy from the host on the card)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("tensor", "as_tensor") and not isinstance(args[0], torch.Tensor):
            self.seen.append(name)
        if name in ("__getitem__", "__setitem__"):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, (list, np.ndarray)) for i in idx):
                self.seen.append(f"{name}[{idx}]")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["bench_block_kernel", "bench_unrolled",
                                  "stage1", "stage2_loop", "stage2_block"])
def test_a_step_builds_no_tensor_from_host_data(path):
    """After its first step, a step of every main path copies nothing from
    the host (a capture would refuse the copy): the engines' and samplers'
    constants are built once per device."""
    if path.startswith("bench"):
        backend = "block_kernel" if path == "bench_block_kernel" else "unrolled"
        n = 10 if backend == "block_kernel" else 4
        trainer = bench.build(batch=6, n_qubits=n, hidden=4, backend=backend, device="cpu")
        step = trainer.step
    else:
        args, cfg, model = _toy("cosine")
        label, _, backend = path.partition("_")
        stage = ns.make_stage(model, cfg, args, ns.make_terms(args), label,
                              backend or "block", use_streams=True)
        step = lambda: stage.run(1)  # noqa: E731
    step()
    with _HostData() as mode:
        step()
    assert mode.seen == []
