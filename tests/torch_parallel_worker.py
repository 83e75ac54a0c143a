"""The cases of the port's parallel tests, run in multi-process gloo worlds
(no JAX here: the children import only torch and qcpinn_tpu_torch).

``start_world(world, cases, payload)`` runs ``cases(payload)`` (a function
of this module) in a ``world``-process gloo group through
``qcpinn_tpu_torch.parallel.mesh.run_cpu_world`` (60 s a collective, one
torch thread a process), and returns a future of what each rank returns
(numpy arrays, floats). The ranks fork from a server that imported this
module, so the imports at its top are paid once, not once a rank. The world gets at most 120 s: a hung collective
fails the fixture that started it, not the suite.
"""

from __future__ import annotations

import numpy as np
import scipy.stats  # noqa: F401  (the seeded Haar draws)
import torch  # noqa: F401

# what the cases run, imported once in the fork server the ranks fork from
import qcpinn_tpu_torch.cli  # noqa: F401
import qcpinn_tpu_torch.graft_entry  # noqa: F401
import qcpinn_tpu_torch.multichip  # noqa: F401
import qcpinn_tpu_torch.parallel.sharded_block  # noqa: F401
import qcpinn_tpu_torch.parallel.sharded_sv  # noqa: F401
import qcpinn_tpu_torch.physics.streams  # noqa: F401
import qcpinn_tpu_torch.train.cz_pipeline  # noqa: F401
import qcpinn_tpu_torch.utils.evaluation  # noqa: F401

WORLD_TIMEOUT_S = 120.0


def start_world(world: int, cases, payload, timeout: float = WORLD_TIMEOUT_S):
    """``parallel.mesh.run_cpu_world(world, cases, payload)`` in a background
    thread: a future of the per-rank results, so the caller computes its JAX
    references while the world runs."""
    import concurrent.futures as cf

    from qcpinn_tpu_torch.parallel.mesh import run_cpu_world

    pool = cf.ThreadPoolExecutor(1)
    future = pool.submit(run_cpu_world, world, cases, payload, timeout=timeout)
    pool.shutdown(wait=False)
    return future


# -- helpers the cases share -----------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _gather_rows(t, mesh, n):
    """The full batch of a per-rank ``[rows, ...]`` result (data axis)."""
    from qcpinn_tpu_torch.parallel.collectives import gather_rows

    return gather_rows(t.detach(), mesh.axis("data"), n)


def _gather_amp(t, mesh):
    """The full amplitude axis of a per-rank block ``[B, 2^n / A]``."""
    from qcpinn_tpu_torch.parallel.collectives import all_gather

    return all_gather(t.detach().transpose(0, 1).contiguous(),
                      mesh.axis("amp")).transpose(0, 1)



class Fixed:
    """A sampler that returns preset points (numpy, as torch tensors on the
    CPU), whatever the generator: the same points in both packages."""

    def __init__(self, X, func):
        self.X, self.func = X, func

    def sample(self, _gen, n):
        import torch

        X = torch.tensor(self.X[:n])
        return X, self.func(X)


def fixed_terms(points: dict, b: int):
    """The canonical diffusion terms on the fixed ``points`` (res, bc1,
    ics)."""
    from qcpinn_tpu_torch.data import diffusion as tdd
    from qcpinn_tpu_torch.train.loop import diffusion_terms

    return diffusion_terms({"res": Fixed(points["res"], tdd.r),
                            "bc1": Fixed(points["bc1"], tdd.u),
                            "ics": Fixed(points["ics"], tdd.u)}, b)


def step_grads(model, terms, cfg, op, mesh, fuse, balancer="none"):
    """One ``make_train_step`` step (on ``mesh`` or alone) whose optimizer
    records the gradients it is given (the world's mean under a mesh) and
    moves nothing: (metrics, the gradients in the JAX tree's layout)."""
    import torch

    from qcpinn_tpu_torch.bridge import grads_to_jax_layout
    from qcpinn_tpu_torch.train import optim as topt
    from qcpinn_tpu_torch.train.loop import make_train_step

    seen = {}

    def update(grads, state, params):
        seen["g"] = grads
        return [torch.zeros_like(g) for g in grads], state

    opt = topt.GradientTransformation(lambda p: None, update)
    step, _ = make_train_step(model, op, terms, opt, cfg, mesh=mesh, fuse_value_terms=fuse,
                              balancer=balancer)
    params = [p for p in model.parameters() if p.requires_grad]
    _, _, metrics = step(params, None, topt.plateau_init(), torch.Generator())
    for p, g in zip(params, seen["g"]):
        p.grad = g
    tree = grads_to_jax_layout(model)
    for p in params:
        p.grad = None
    return {k: float(v) for k, v in metrics.items()}, tree


def _train_history(model, cfg, op, mesh):
    from qcpinn_tpu_torch.data import gaussian_pulse_samplers
    from qcpinn_tpu_torch.train import diffusion_terms, train

    terms = diffusion_terms(gaussian_pulse_samplers(), cfg.batch_size)
    _, hist = train(model, cfg, terms, op, mesh=mesh, device="cpu")
    return np.asarray(hist)


# -- parallel/mesh.py and its users: train(), cli train, the Hopfield model --


def parallel_cases(payload):
    import os

    import torch
    import torch.distributed as dist

    from qcpinn_tpu_torch import cli, graft_entry, multichip
    from qcpinn_tpu_torch.bridge import params_from_jax
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.models import ClassicalSolver, DVSolver
    from qcpinn_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from qcpinn_tpu_torch.physics import get_operator
    from qcpinn_tpu_torch.train.loop import inject_balancer_params

    out = {}
    rank = dist.get_rank()
    mesh = make_mesh(device="cpu")
    out["shape"] = dict(mesh.shape)
    try:
        make_mesh(data=3, amp=2, device="cpu")
    except ValueError as e:
        out["shape_error"] = str(e)

    # the DP forward of a replicated model (rank 0's weights, others drawn anew)
    c = payload["forward"]
    m = DVSolver(QCPINNConfig(**c["cfg"]), device="cpu")
    if rank == 0:
        m.load_state_dict(params_from_jax(c["params"]))
    replicate(m, mesh)
    x = torch.tensor(c["x"])
    out["forward"] = _np(_gather_rows(m(shard_batch(x, mesh)), mesh, x.shape[0]))

    # the Hopfield attention spans the global batch inside batch_sharded
    c = payload["hopfield"]
    hm = ClassicalSolver(QCPINNConfig(**c["cfg"]), device="cpu")
    hm.load_state_dict(params_from_jax(c["params"]))
    x = torch.tensor(c["x"])
    with hm.batch_sharded(mesh, x.shape[0]):
        out["hopfield"] = _np(_gather_rows(hm(shard_batch(x, mesh)), mesh, x.shape[0]))

    # one train step's metrics and gradients, against JAX's on the same points
    for tag, c in payload["steps"].items():
        sub = make_mesh(c["data"], c["amp"], device="cpu")
        cfg = QCPINNConfig(**c["cfg"])
        model = (ClassicalSolver if cfg.solver == "Classical" else DVSolver)(cfg, device="cpu")
        terms = fixed_terms(c["points"], c["b"])
        inject_balancer_params(model, terms, c["balancer"])
        model.load_state_dict(params_from_jax(c["params"]))
        if c["amp"] > 1:
            model.use_sharded(sub, backend=c["backend"])
        out[f"step_{tag}"] = step_grads(model, terms, cfg, get_operator("diffusion", c["op"]),
                                        sub, c["fuse"], c["balancer"])

    # training histories on a mesh (the single-device ones come from the test)
    for tag, c in payload["train"].items():
        sub = make_mesh(c["data"], c["amp"], device="cpu")
        cfg = QCPINNConfig(**c["cfg"])
        model = (ClassicalSolver if cfg.solver == "Classical" else DVSolver)(cfg, device="cpu")
        if c["amp"] > 1:
            model.use_sharded(sub)
        out[f"train_{tag}"] = _train_history(model, cfg, get_operator("diffusion", c["op"]),
                                             sub)

    # cli train --data-parallel: rank 0 writes, every rank returns
    c = payload["cli"]
    out["cli_rc"] = cli.main(c["argv"], device="cpu")
    out["cli_dirs"] = sorted(os.listdir(c["out"])) if rank == 0 else None

    # the driver entry's full step and the walkthrough, on this world
    out["dryrun"] = graft_entry._dryrun(mesh.world_size)
    out["multichip"] = multichip.run(multichip.parse_args(payload["multichip"]))
    return out



# -- parallel/sharded_sv.py and parallel/sharded_block.py ---------------------


def _engine(backend, circ, mesh):
    from qcpinn_tpu_torch.parallel.sharded_block import ShardedBlockCircuit
    from qcpinn_tpu_torch.parallel.sharded_sv import ShardedCircuit

    return (ShardedBlockCircuit if backend == "block" else ShardedCircuit)(circ, mesh)


def sharded_cases(payload):
    """The engine ``payload["backend"]`` ('gate' or 'block') at every case:
    forward, evolve, gradients, shots and noise, the streams residual."""
    import torch

    from qcpinn_tpu_torch.bridge import params_from_jax
    from qcpinn_tpu_torch.config import QCPINNConfig
    from qcpinn_tpu_torch.models import DVSolver
    from qcpinn_tpu_torch.ops import DVCircuit, NoiseModel
    from qcpinn_tpu_torch.parallel import make_mesh, shard_batch
    from qcpinn_tpu_torch.physics.streams import dv_diffusion_residual_streams

    backend = payload["backend"]
    out = {}
    meshes = {}

    def mesh_of(data, amp):
        if (data, amp) not in meshes:
            meshes[data, amp] = make_mesh(data, amp, device="cpu")
        return meshes[data, amp]

    for tag, c in payload["circuits"].items():
        mesh = mesh_of(c["data"], c["amp"])
        circ = DVCircuit(c["n"], c["layers"], c["ansatz"], seed=c.get("seed"),
                         encoding=c.get("encoding", "angle"))
        eng = _engine(backend, circ, mesh)
        params = torch.tensor(c["params"], requires_grad=True)
        x = torch.tensor(c["x"])
        b = x.shape[0]
        xl = shard_batch(x, mesh)
        want = c.get("want", ("z",))
        if "z" in want or "grad" in want:
            z = eng.apply(params, xl)
            out[f"{tag}/z"] = _np(_gather_rows(z, mesh, b))
        if "grad" in want:
            (z ** 2).sum().backward()
            # sum(z^2) is split over 'data' and alike over 'amp': the world's
            # mean counts each amp copy once more than the loss holds it
            g = mesh.mean_grads([params.grad])[0] * (mesh.world_size / c["amp"])
            out[f"{tag}/grad"] = _np(g)
            params.grad = None
        if "evolve" in want:
            state = circ.prepare(x)
            blk = eng.evolve(params.detach(), shard_batch(state, mesh))
            out[f"{tag}/evolve"] = _np(_gather_rows(_gather_amp(blk, mesh), mesh, b))
        if "noise" in want:
            noise = NoiseModel(*c["noise"])
            out[f"{tag}/noisy"] = _np(_gather_rows(
                eng.apply(params.detach(), xl, noise=noise), mesh, b))
            gen = torch.Generator().manual_seed(7)
            # every rank draws its rows' shots from the same stream: the
            # stream of a single-device run over these rows alone
            out[f"{tag}/shots"] = _np(eng.apply(params.detach(), xl, shots=c["shots"],
                                                key=gen, noise=noise))
            out[f"{tag}/rows"] = _np(xl)

    c = payload["streams"]
    mesh = mesh_of(c["data"], c["amp"])
    m = DVSolver(QCPINNConfig(**c["cfg"]), device="cpu")
    m.load_state_dict(params_from_jax(c["params"]))
    m.use_sharded(mesh, backend=backend)
    X = torch.tensor(c["X"])
    u, r = dv_diffusion_residual_streams(m, shard_batch(X, mesh))
    out["streams/u"] = _np(_gather_rows(u, mesh, X.shape[0]))
    out["streams/r"] = _np(_gather_rows(r, mesh, X.shape[0]))
    # the residual's loss summed over 'data' (psum): alike on every rank
    from qcpinn_tpu_torch.parallel.collectives import psum

    psum((r ** 2).sum(), mesh.axis("data")).backward()
    params = [p for p in m.parameters() if p.requires_grad]
    grads = mesh.mean_grads([torch.zeros_like(p) if p.grad is None else p.grad
                             for p in params])
    for p, g in zip(params, grads):
        p.grad = g
    from qcpinn_tpu_torch.bridge import grads_to_jax_layout

    out["streams/grads"] = grads_to_jax_layout(m)
    return out


# -- the Czochralski model, pipeline and evaluation on a mesh ----------------


def cz_cases(payload):
    import torch

    from qcpinn_tpu_torch.bridge import params_from_jax
    from qcpinn_tpu_torch.data.cz_loader import DataStats
    from qcpinn_tpu_torch.models.czochralski import Hybrid16QPINN
    from qcpinn_tpu_torch.parallel import make_mesh, shard_batch
    from qcpinn_tpu_torch.train import cz_pipeline as tp
    from qcpinn_tpu_torch.utils.evaluation import evaluate_cz_fields
    from qcpinn_tpu_torch.utils.logger import NullLogging

    out = {}
    mesh = make_mesh(payload["data"], payload["amp"], device="cpu")

    def model(c, sharded=True):
        m = Hybrid16QPINN(c["n"], c["L"], width=c["width"], remat=c.get("remat", False),
                          device="cpu")
        m.load_state_dict(params_from_jax(c["params"]))
        return m.use_sharded(mesh) if sharded else m

    # the sharded forward (data x amp) against JAX's apply, and its grads
    c = payload["forward"]
    m = model(c)
    x = torch.tensor(c["x"])
    pred = m(shard_batch(x, mesh))
    out["forward"] = _np(_gather_rows(pred, mesh, x.shape[0]))
    from qcpinn_tpu_torch.bridge import grads_to_jax_layout
    from qcpinn_tpu_torch.parallel.collectives import psum

    psum((pred ** 2).sum(), mesh.axis("data")).backward()
    params = [p for p in m.parameters() if p.requires_grad]
    for p, g in zip(params, mesh.mean_grads([p.grad for p in params])):
        p.grad = g
    out["forward_grads"] = grads_to_jax_layout(m)

    # the data-parallel, amp-sharded pretrain (the single-device history
    # comes from the test)
    c = payload["pretrain"]
    cfg = tp.CzConfig(**c["cfg"])
    stats = DataStats(**c["stats"])
    m, hist = tp.run_pretrain(model(c), c["X"], c["Y"], stats, cfg, logger=NullLogging(),
                              params=c["params"], mesh=mesh)
    out["pretrain"] = np.asarray(hist)
    try:
        tp.make_pretrain_epoch(m, c["X"], c["Y"], stats,
                               tp.CzConfig(**{**c["cfg"], "batch_size": payload["data"] + 1}),
                               mesh=mesh)
    except ValueError as e:
        out["batch_error"] = str(e)

    # the full-scope finetune (parameter-shift over vmap) through the
    # sharded circuit, its shots from a generator seeded alike
    c = payload["finetune"]
    cfg = tp.CzConfig(**c["cfg"])
    m, hist = tp.run_finetune(model(c), None, c["X"], c["Y"], DataStats(**c["stats"]), cfg,
                              logger=NullLogging())
    out["finetune"] = np.asarray(hist)

    # the evaluation over the mesh: chunks split over 'data', gathered
    c = payload["eval"]
    out["eval"] = evaluate_cz_fields(model(c), c["X"], c["Y"], batch=c["batch"], mesh=mesh)
    return out
