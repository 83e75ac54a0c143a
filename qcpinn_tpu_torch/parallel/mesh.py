"""The ('data', 'amp') device mesh on ``torch.distributed`` (port of
qcpinn_tpu/parallel/mesh.py).

One process per device. ``make_mesh`` lays the world's ranks out as JAX
lays out its devices, ``reshape(data, amp)``: rank r sits at ``(data, amp)
= divmod(r, amp)``. 'data' splits the collocation batch (every rank draws the
same global batch and keeps its rows, ``shard_batch``); 'amp' splits the
2^n amplitudes of the statevector over its leading ``log2(amp)`` wire bits
(``parallel/sharded_sv.py``, ``parallel/sharded_block.py``). Parameters are
replicated (``replicate``); a train step sums each loss term over 'data'
(``collectives.psum``) and averages the gradients over the world
(``Mesh.mean_grads``) before the clip and Adam, so every rank takes the same
step, the single-device one.

The backend follows the device: NCCL for CUDA (``cuda:LOCAL_RANK``), gloo
for the CPU. There is no fallback: a CUDA tensor never goes through gloo,
and a failed NCCL initialisation raises. Launch with ``torchrun
--nproc-per-node N``; a lone process that asks for a mesh forms a world of
one on a local in-process store, as JAX's ``make_mesh()`` takes all local
devices.
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device
from .collectives import CALLS, row_counts


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its process group, the
    global ranks along it in axis order, and this rank's index there."""

    name: str
    group: object
    ranks: tuple
    index: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """The world as a ``data x amp`` grid of ranks. ``shape`` is
    ``{"data": D, "amp": A}`` (JAX's ``mesh.shape``), ``coords`` this rank's
    place in it, ``axis(name)`` the :class:`Axis` of 'data', 'amp' or
    'world', ``device`` this rank's device."""

    def __init__(self, data: int, amp: int, device: torch.device):
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.shape = {"data": data, "amp": amp}
        d, a = divmod(self.rank, amp)
        self.coords = {"data": d, "amp": a}
        axes = {}
        # every rank creates every group, in the same order
        for i in range(amp):
            ranks = tuple(j * amp + i for j in range(data))
            g = dist.new_group(list(ranks))
            if i == a:
                axes["data"] = Axis("data", g, ranks, d, device, self.backend)
        for j in range(data):
            ranks = tuple(j * amp + i for i in range(amp))
            g = dist.new_group(list(ranks))
            if j == d:
                axes["amp"] = Axis("amp", g, ranks, a, device, self.backend)
        axes["world"] = Axis("world", dist.group.WORLD, tuple(range(self.world_size)),
                             self.rank, device, self.backend)
        self._axes = axes

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    @property
    def is_main(self) -> bool:
        """Rank 0: the one process that writes the run's files."""
        return self.rank == 0

    def mean_grads(self, grads: Sequence[torch.Tensor]) -> list:
        """The world's mean of each gradient, in one all-reduce of their
        concatenation (capturable in a CUDA graph). Every rank holds the same
        loss, so each rank's gradient is that loss's gradient summed over the
        ranks' parameter copies (``collectives``): the mean is the
        single-device gradient."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        CALLS["mean_grads"] += 1
        dist.all_reduce(flat, group=dist.group.WORLD)
        flat = flat * (1.0 / self.world_size)
        out, ofs = [], 0
        for g in grads:
            out.append(flat[ofs:ofs + g.numel()].view_as(g))
            ofs += g.numel()
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.device}, {self.backend})"


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_world(device=None) -> torch.device:
    """Join the process group the caller or ``torchrun`` set up, or
    initialise one: from torchrun's environment, else a world of one on an
    in-process store. Returns this rank's device: ``device`` None is the
    card ``cuda:LOCAL_RANK`` (and raises without CUDA), ``"cpu"`` runs on
    gloo. Raises if the group's backend is not the device's."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = _backend_for(device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}; a mesh on "
                         f"{device} needs {backend} (no fallback between them)")
    return device


def make_mesh(data: Optional[int] = None, amp: int = 1, device=None) -> Mesh:
    """Build the ('data', 'amp') mesh over the world (defaults: every rank
    on the data axis), on the group :func:`init_world` joins or sets up."""
    device = init_world(device)
    n = dist.get_world_size()
    if data is None:
        data = n // amp
    if data * amp != n:
        raise ValueError(f"data({data}) * amp({amp}) != device count ({n})")
    return Mesh(data, amp, device)


def replicate(tree, mesh: Mesh):
    """Make rank 0's tensors every rank's, in place: a module's parameters
    and buffers, or the tensors of a list, tuple or dict. Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            buf = torch.view_as_real(t) if t.is_complex() else t
            dist.broadcast(buf, src=0)
    return tree


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch: dim 0 split over ``axis`` as
    ``torch.tensor_split`` splits it (uneven counts allowed, the first parts
    one row longer; ``collectives.row_counts``)."""
    ax = mesh.axis(axis)
    counts = row_counts(x.shape[0], ax.size)
    start = sum(counts[:ax.index])
    return x[start:start + counts[ax.index]]


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The layout of a batch whose leading dimension is split over one mesh
    axis and whose other ``ndim - 1`` dimensions are whole (JAX's
    ``NamedSharding(mesh, P(axis, None, ...))``). Calling it on a global
    batch returns this rank's rows."""

    mesh: Mesh
    ndim: int
    axis: str = "data"

    @property
    def spec(self) -> tuple:
        return (self.axis,) + (None,) * (self.ndim - 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != self.ndim:
            raise ValueError(f"a {x.ndim}-d batch for a {self.ndim}-d sharding")
        return shard_batch(x, self.mesh, self.axis)


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> BatchSharding:
    return BatchSharding(mesh, ndim, axis)


COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _world_child(rank, n, store, fn, args, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=n, timeout=COLLECTIVE_TIMEOUT)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, "error", traceback.format_exc()))


def run_cpu_world(n: int, fn, *args, timeout: float = 600.0) -> list:
    """``fn(*args)`` in ``n`` processes forming a gloo world on the CPU (a
    file store, one torch thread a process, each collective waiting at most
    ``COLLECTIVE_TIMEOUT``), as ``torchrun --nproc-per-node n`` would run
    it; returns every rank's result, in rank order. The ranks fork from a
    fork server that imported torch and ``fn``'s module once, so a world
    starts without n imports of torch. ``fn`` is pickled by name: a
    module-level function of an importable module, not ``__main__``. The
    parent reads the results as they come and waits at most ``timeout``
    seconds for the whole world; then, or if a rank fails, it kills the
    rest and raises."""
    import multiprocessing as mp
    import queue
    import tempfile
    import time

    if fn.__module__ == "__main__":
        raise ValueError("run_cpu_world pickles fn by name: pass a function of an "
                         "importable module, not of __main__")
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed", __name__, fn.__module__])
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_world_child, args=(r, n, store, fn, args, out),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"the CPU world of {n} did not finish in "
                                       f"{timeout:.0f} s; {len(results)} ranks answered")
                try:
                    rank, status, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        codes = [p.exitcode for p in procs]
                        raise RuntimeError(f"a rank of the CPU world died: exit codes {codes}")
                    continue
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
            if errors:
                raise RuntimeError("\n".join(errors))
            return [results[r] for r in range(n)]
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
