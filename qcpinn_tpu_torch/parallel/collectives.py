"""Differentiable collectives over one axis of a :class:`~.mesh.Mesh`.

Each is a ``torch.autograd.Function`` whose backward is its exact linear
transpose and whose forward-mode rule (``jvp``) is the collective itself on
the tangent, so it composes with reverse mode, with the nested
``torch.func.jvp`` operators and with reverse-over-reverse (each backward is
again one of these functions):

- ``psum``: all-reduce (sum); its transpose is ``psum``.
- ``all_gather``: concatenation of every member's rows; its transpose is
  ``reduce_scatter`` (the summed cotangents of this member's rows), and
  back.
- ``exchange``: the tensor of the member whose axis index differs from this
  one's by the XOR ``mask`` (one send/receive pair); its transpose is the
  same exchange.
- ``all_to_all``: split ``split_dim`` into as many chunks as members, send
  chunk j to member j and concatenate what arrives along ``cat_dim``; its
  transpose swaps the two dims.

The rule that makes a step exact: every collective's backward is its
transpose, so a loss that every rank holds alike (summed over the data axis
by ``psum``, read out of the amp axis by ``psum``) back-propagates into each
rank's copy of the parameters the gradient of the SUM of those equal losses;
:meth:`~.mesh.Mesh.mean_grads` divides that by the world size. A
pass-through backward would be right only for the parameters upstream of the
collective and would count the others once a member.

``psum`` and ``exchange`` also carry a ``vmap`` rule (they act on the
batched tensor as on its slices), for the parameter-shift estimator's
batched shifted evaluations. Complex tensors travel as their real views.
The tensors must live on the mesh's device: NCCL for CUDA, gloo for the CPU,
never the other way round.

``CALLS`` counts each collective where Python issues it (as the kernels'
``LAUNCHES`` count launches): a captured step's replays add nothing, so the
counts of a run say how many steps went through Python and which
collectives each step's graph holds.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

CALLS: collections.Counter = collections.Counter()

# the name of the reduce-scatter into one tensor in the PyTorch at hand (it
# was renamed, the old name kept with a warning)
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _check(t: torch.Tensor, axis) -> None:
    if t.device.type != axis.device.type:
        raise ValueError(f"a {t.device.type} tensor on a mesh of {axis.device.type} "
                         f"({axis.backend}) collectives")


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        _check(x, axis)
        out = x.contiguous().clone()
        CALLS["psum"] += 1
        dist.all_reduce(_real(out), group=axis.group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, t, _):
        return _Psum.apply(t, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _Psum.apply(x, axis), in_dims[0]


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, mask):
        _check(x, axis)
        peer = axis.ranks[axis.index ^ mask]
        send = x.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, _real(send), peer, axis.group),
               dist.P2POp(dist.irecv, _real(recv), peer, axis.group)]
        CALLS["exchange"] += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.mask = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Exchange.apply(g, ctx.axis, ctx.mask), None, None

    @staticmethod
    def jvp(ctx, t, _a, _m):
        return _Exchange.apply(t, ctx.axis, ctx.mask)

    @staticmethod
    def vmap(info, in_dims, x, axis, mask):
        return _Exchange.apply(x, axis, mask), in_dims[0]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        _check(x, axis)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        CALLS["all_gather"] += 1
        dist.all_gather([_real(p) for p in parts], _real(x), group=axis.group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, t, _):
        return _AllGather.apply(t, ctx.axis)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        _check(x, axis)
        x = x.contiguous()
        out = torch.empty_like(x[: x.shape[0] // axis.size])
        CALLS["reduce_scatter"] += 1
        _reduce_scatter_into(_real(out), _real(x), group=axis.group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, t, _):
        return _ReduceScatter.apply(t, ctx.axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, split_dim, cat_dim):
        _check(x, axis)
        a = axis.size
        # chunk j of split_dim leads, so that chunk j is the j-th slab sent
        shape = list(x.shape)
        xs = x.reshape(shape[:split_dim] + [a, shape[split_dim] // a] + shape[split_dim + 1:])
        send = xs.movedim(split_dim, 0).contiguous()
        recv = torch.empty_like(send)
        CALLS["all_to_all"] += 1
        dist.all_to_all_single(_real(recv), _real(send), group=axis.group)
        # slab i came from member i: it holds member i's rows of cat_dim
        parts = recv.unbind(0)
        return torch.cat(parts, dim=cat_dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.split_dim, ctx.cat_dim = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.axis, ctx.cat_dim, ctx.split_dim), None, None, None

    @staticmethod
    def jvp(ctx, t, _a, _s, _c):
        return _AllToAll.apply(t, ctx.axis, ctx.split_dim, ctx.cat_dim)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over the members of ``axis``; every member gets it."""
    return _Psum.apply(x, axis)


def exchange(x: torch.Tensor, axis, mask: int) -> torch.Tensor:
    """The ``x`` of the member at axis index ``index ^ mask``."""
    return _Exchange.apply(x, axis, mask)


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """Every member's ``x`` (equal shapes), concatenated along dim 0 in axis
    order."""
    return _AllGather.apply(x, axis)


def reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over members of ``x``'s rows for this member: dim 0 splits in
    ``axis.size`` equal chunks, this member keeps the summed chunk at its
    index."""
    return _ReduceScatter.apply(x, axis)


def all_to_all(x: torch.Tensor, axis, split_dim: int, cat_dim: int) -> torch.Tensor:
    """Chunk j of ``split_dim`` goes to member j; the chunks that arrive are
    concatenated along ``cat_dim`` in axis order (``split_dim`` shrinks and
    ``cat_dim`` grows by the axis size)."""
    return _AllToAll.apply(x, axis, split_dim, cat_dim)


def row_counts(n: int, parts: int) -> list:
    """Rows of each part when ``n`` rows split into ``parts`` (the sizes of
    ``torch.tensor_split``: the first ``n % parts`` parts take one more)."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


def gather_rows(x: torch.Tensor, axis, n: int) -> torch.Tensor:
    """The ``n`` rows of a batch split over ``axis`` by ``row_counts`` (this
    member holds its part, ``x``), in row order on every member: each part
    is padded to the largest, gathered, and the padding dropped. The counts
    are known on the host, so the step stays capturable in a CUDA graph."""
    counts = row_counts(n, axis.size)
    if x.shape[0] != counts[axis.index]:
        raise ValueError(f"{x.shape[0]} rows here, {counts[axis.index]} expected of "
                         f"{n} over {axis.size}")
    top = counts[0]
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    full = all_gather(x, axis)
    if all(c == top for c in counts):
        return full
    return torch.cat([full[i * top:i * top + c] for i, c in enumerate(counts)])
