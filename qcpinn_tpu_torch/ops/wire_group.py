"""The Cz engine's wire-group product: a ``[G, G]`` unitary (G = 2^k, k <= 4)
on the adjacent wires ``[w0, w0 + k)`` of ``[R, 2^n]`` complex64 states.

With the state viewed as ``[R, 2^w0, G, H]`` (H = 2^(n - w0 - k)),
``out[r, l, i, h] = sum_j U[u(r)][i, j] s[r, l, j, h]`` for ``U [Nu, G, G]``
and ``u(r) = r / (R / Nu)``. That one rule, read from U's shape, covers a
shared unitary (Nu = 1: the Rot groups, the jet's 5B rows), one a row (Nu =
R: the RY encode) and one a vmapped evaluation of R / Nu rows (the
parameter-shift rules' shifted Rot weights, by the vmap rule below).

Replaces no TPU kernel: the JAX package leaves the product to XLA's einsum
(``qcpinn_tpu/models/czochralski.py`` ``_apply_wire_group``). It is bound by
bytes: one read and one write of the state forward, a read of the cotangent
and of the state and a write of the state's gradient in reverse. The card's
einsum permuted the state into a copy for a complex GEMM in both
directions; the kernels (``csrc/wire_group.cu``) never permute it. Each
thread multiplies whole columns by U in FP32 FMAs (no tensor cores): read
straight into registers where a group's trailing stride H is 32 or more,
else from a tile of whole columns staged in shared memory. The reverse
writes ``U^H g`` and sums ``g s^H`` into per-CTA partials, added in a fixed
order (``slab_sum.cuh``), so a gradient has the same bits on every run.

On a CUDA tensor forward and reverse launch the kernels or raise; on the
CPU they run the plain versions here (the forward is the einsum the engine
ran before). The reverse is itself a Function whose reverse is built from
these two, so every order of reverse mode works (the "rev" residual's third
order); ``jvp`` (the nested-jvp residual) and ``vmap`` (the shift rules)
have rules of their own.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD

# launches of the two kernels (the reverse's slab sum is part of its launch)
LAUNCHES = {"wire_group_fwd": 0, "wire_group_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _view(t: torch.Tensor, n: int, w0: int, g: int, nu: int) -> torch.Tensor:
    """``[R, 2^n]`` as ``[Nu, R / Nu, 2^w0, G, H]``."""
    k = g.bit_length() - 1
    return t.reshape(nu, t.shape[0] // nu, 1 << w0, g, 1 << (n - w0 - k))


def _rows(s: torch.Tensor, reps: int) -> torch.Tensor:
    """The ``R = reps * Rs`` rows that ``s [Rs, 2^n]`` stands for: row r is
    ``s[r % Rs]``."""
    return s if reps == 1 else s.repeat(reps, 1)


def _fold_reps(t: torch.Tensor, reps: int) -> torch.Tensor:
    """The gradient of ``_rows``: ``[R, 2^n]`` summed onto its ``Rs`` rows."""
    return t if reps == 1 else t.reshape(reps, -1, t.shape[-1]).sum(0)


def product_plain(s: torch.Tensor, u: torch.Tensor, n: int, w0: int,
                  reps: int = 1) -> torch.Tensor:
    """The product by einsum: the shared and per-row forms are the engine's
    einsums as they were, so the CPU results keep their bits."""
    s = _rows(s, reps)
    r, g, nu = s.shape[0], u.shape[-1], u.shape[0]
    st = _view(s, n, w0, g, 1)[0]
    if nu == 1:
        out = torch.einsum("ij,bljh->blih", u[0], st)
    elif nu == r:
        out = torch.einsum("bij,bljh->blih", u, st)
    else:
        out = torch.einsum("uij,ubljh->ublih", u, _view(s, n, w0, g, nu))
    return out.reshape(r, 1 << n)


def vjp_plain(g: torch.Tensor, s: torch.Tensor, u: torch.Tensor, n: int, w0: int,
              reps: int, need_s: bool, need_u: bool):
    """(``U^H g`` summed onto s's rows, ``sum g s^H`` a unitary), each None
    where not needed."""
    nu, gg = u.shape[0], u.shape[-1]
    g5 = _view(g, n, w0, gg, nu)
    grad_s = grad_u = None
    if need_s:
        grad_s = _fold_reps(torch.einsum("uij,ublih->ubljh", u.conj(), g5)
                            .reshape(g.shape), reps)
    if need_u:
        grad_u = torch.einsum("ublih,ubljh->uij", g5,
                              _view(_rows(s, reps), n, w0, gg, nu).conj())
    return grad_s, grad_u


# -- the kernels ------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_PARTIALS = {}  # (R, Rs, n, w0, k, Nu, device) -> the reverse's partials a unitary


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import cuda_build

        lib = ctypes.CDLL(cuda_build.build("wire_group")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qc_wire_group_fwd.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.qc_wire_group_fwd.restype = i
        lib.qc_wire_group_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.qc_wire_group_bwd.restype = i
        lib.qc_wire_group_partials.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.qc_wire_group_partials.restype = i
        lib.qc_wire_group_error_string.argtypes = [i]
        lib.qc_wire_group_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise(lib, what: str, err: int):
    raise RuntimeError(f"qc_wire_group {what} failed: CUDA error {err} "
                       f"({lib.qc_wire_group_error_string(err).decode()})")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: its conjugation and negation applied,
    contiguous, 16-byte aligned."""
    t = t.resolve_conj().resolve_neg().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_cuda(s: torch.Tensor, u: torch.Tensor, n: int, w0: int, reps: int) -> int:
    """Refuses what the kernels do not take; returns R, the output's rows."""
    if s.dtype != torch.complex64 or u.dtype != torch.complex64:
        raise ValueError(f"the wire-group kernels take complex64 states and unitaries, "
                         f"not {s.dtype} and {u.dtype}")
    if u.device != s.device:
        raise ValueError(f"the unitary is on {u.device}, the state on {s.device}")
    g = u.shape[-1]
    if u.ndim != 3 or u.shape[-2] != g or g not in (2, 4, 8, 16):
        raise ValueError(f"the unitary is [Nu, G, G] with G in 2, 4, 8, 16, not "
                         f"{list(u.shape)}")
    k = g.bit_length() - 1
    if s.ndim != 2 or s.shape[1] != 1 << n or not 0 <= w0 <= n - k:
        raise ValueError(f"a [R, 2^{n}] state and wires [{w0}, {w0 + k}) in {n}, not "
                         f"{list(s.shape)}")
    rows = s.shape[0] * reps
    if rows % u.shape[0] or rows >= 1 << 31:
        raise ValueError(f"{rows} rows do not split over {u.shape[0]} unitaries")
    return rows


def _product_cuda(s: torch.Tensor, u: torch.Tensor, n: int, w0: int, reps: int):
    rows = check_cuda(s, u, n, w0, reps)
    s, u = _operand(s), _operand(u)
    out = torch.empty((rows, 1 << n), dtype=s.dtype, device=s.device)
    lib = _lib()
    k = u.shape[-1].bit_length() - 1
    err = lib.qc_wire_group_fwd(s.data_ptr(), u.data_ptr(), out.data_ptr(), rows, s.shape[0],
                                n, w0, k, u.shape[0],
                                torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        _raise(lib, "forward", err)
    LAUNCHES["wire_group_fwd"] += 1
    return out


def _vjp_cuda(g: torch.Tensor, s: torch.Tensor, u: torch.Tensor, n: int, w0: int,
              reps: int, need_s: bool, need_u: bool):
    rows = check_cuda(s, u, n, w0, reps)
    if g.shape != (rows, 1 << n) or g.device != s.device:
        raise ValueError(f"the cotangent is {list(g.shape)} on {g.device}, the output "
                         f"[{rows}, {1 << n}] on {s.device}")
    g, s, u = _operand(g.to(torch.complex64)), _operand(s), _operand(u)
    lib = _lib()
    nu, gg = u.shape[0], u.shape[-1]
    k = gg.bit_length() - 1
    grad_s = torch.empty_like(g) if need_s else None
    grad_u = partials = None
    if need_u:
        key = (rows, s.shape[0], n, w0, k, nu, s.device)
        if key not in _PARTIALS:
            count = ctypes.c_int(0)
            err = lib.qc_wire_group_partials(rows, s.shape[0], n, w0, k, nu,
                                             ctypes.byref(count))
            if err:
                _raise(lib, "plan", err)
            _PARTIALS[key] = count.value
        partials = torch.empty((_PARTIALS[key], nu, gg, gg), dtype=u.dtype, device=u.device)
        grad_u = torch.empty((nu, gg, gg), dtype=u.dtype, device=u.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.qc_wire_group_bwd(g.data_ptr(), s.data_ptr(), u.data_ptr(), ptr(grad_s),
                                ptr(partials), ptr(grad_u), rows, s.shape[0], n, w0, k, nu,
                                int(need_s), int(need_u),
                                torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        _raise(lib, "reverse", err)
    LAUNCHES["wire_group_bwd"] += 1
    return (None if grad_s is None else _fold_reps(grad_s, reps)), grad_u


def _product(s, u, n, w0, reps):
    if s.is_cuda:
        return _product_cuda(s, u, n, w0, reps)
    return product_plain(s, u, n, w0, reps)


def _vjp(g, s, u, n, w0, reps, need_s, need_u):
    if s.is_cuda:
        return _vjp_cuda(g, s, u, n, w0, reps, need_s, need_u)
    return vjp_plain(g, s, u, n, w0, reps, need_s, need_u)


def _adjoint(u: torch.Tensor) -> torch.Tensor:
    return u.conj().transpose(-1, -2)


class WireGroupProduct(torch.autograd.Function):
    """``forward(s [Rs, 2^n], u [Nu, G, G], n, w0, reps) -> [reps Rs, 2^n]``,
    output row r the product on ``s[r % Rs]`` (``reps`` > 1 only where the
    vmap rule folds an unbatched state into batched unitaries)."""

    @staticmethod
    def forward(s, u, n, w0, reps):
        return _product(s, u, n, w0, reps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        s, u, n, w0, reps = inputs
        ctx.save_for_backward(s, u)
        ctx.save_for_forward(s, u)
        ctx.geometry = (n, w0, reps)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None, None
        s, u = ctx.saved_tensors
        need_s, need_u = ctx.needs_input_grad[:2]
        grad_s, grad_u = WireGroupVjp.apply(g, s, u, *ctx.geometry, need_s, need_u)
        return grad_s, grad_u, None, None, None

    @staticmethod
    def jvp(ctx, s_t, u_t, *_):
        # linear in each factor: t_out = U t_s + U_t s
        s, u = ctx.saved_tensors
        n, w0, reps = ctx.geometry
        out = None
        if s_t is not None:
            out = WireGroupProduct.apply(s_t, u, n, w0, reps)
        if u_t is not None:
            t = WireGroupProduct.apply(s, u_t, n, w0, reps)
            out = t if out is None else out + t
        return out

    @staticmethod
    def vmap(info, in_dims, s, u, n, w0, reps):
        # the vmapped dimension joins the rows and the unitaries: evaluation
        # e's rows are rows e R .. e R + R - 1 of the folded state, its
        # unitaries e Nu .. e Nu + Nu - 1
        s_dim, u_dim = in_dims[:2]
        e = info.batch_size
        if u_dim is not None:
            u = u.movedim(u_dim, 0).flatten(0, 1)
        if s_dim is None:
            # folded row e R + r reads s[(e R + r) % Rs] = s[r % Rs]
            rows = s.shape[0] * reps
            reps *= e
        else:
            s = s.movedim(s_dim, 0)
            if reps > 1:
                s = s.repeat(1, reps, 1)
                reps = 1
            rows = s.shape[1]
            s = s.flatten(0, 1)
            if u_dim is None and u.shape[0] > 1:
                u = u.expand(e, *u.shape).flatten(0, 1)
        out = WireGroupProduct.apply(s, u, n, w0, reps)
        return out.reshape(e, rows, out.shape[-1]), 0


class WireGroupVjp(torch.autograd.Function):
    """The product's reverse: ``(g, s, u) -> (U^H g`` summed onto s's rows,
    ``sum g s^H`` a unitary), each None where not needed, in one kernel.
    Its own reverse (the cotangents ``a`` of the first output, ``b`` of the
    second) is made of these two Functions: ``grad_g = U a + b s``,
    ``grad_s = b^H g``, ``grad_U = g a^H``."""

    @staticmethod
    def forward(g, s, u, n, w0, reps, need_s, need_u):
        return _vjp(g, s, u, n, w0, reps, need_s, need_u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, s, u, n, w0, reps, _, _ = inputs
        ctx.save_for_backward(g, s, u)
        ctx.geometry = (n, w0, reps)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, a, b):
        g, s, u = ctx.saved_tensors
        n, w0, reps = ctx.geometry
        need_g, need_s, need_u = ctx.needs_input_grad[:3]
        grad_g = grad_s = grad_u = None
        if need_g:
            if a is not None:
                grad_g = WireGroupProduct.apply(a, u, n, w0, reps)
            if b is not None:
                t = WireGroupProduct.apply(s, b, n, w0, reps)
                grad_g = t if grad_g is None else grad_g + t
        if need_s and b is not None:
            grad_s = _fold_reps(WireGroupProduct.apply(g, _adjoint(b), n, w0, 1), reps)
        if need_u and a is not None:
            grad_u = WireGroupVjp.apply(g, a, u, n, w0, reps, False, True)[1]
        return grad_g, grad_s, grad_u, None, None, None, None, None


def _jvp_levels() -> int:
    """The ``torch.func.jvp`` levels around the call, and whether the
    innermost transform is one of them: ``(count, innermost)``."""
    if torch._C._functorch.maybe_current_level() is None:
        return 0, False
    from torch._C._functorch import TransformType
    from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters

    kinds = [i.key() for i in retrieve_all_functorch_interpreters()]
    return kinds.count(TransformType.Jvp), kinds[-1] == TransformType.Jvp


def product(state: torch.Tensor, u: torch.Tensor, n: int, w0: int) -> torch.Tensor:
    """``U`` on wires ``[w0, w0 + k)`` of ``state [R, 2^n]``; ``u`` is ``[G,
    G]`` (shared), ``[R, G, G]`` (a row each) or ``[Nu, G, G]`` (R / Nu rows
    each), of the state's dtype.

    Inside ``torch.func.jvp`` the innermost level's tangent is formed here,
    ``U t_s + U_t s`` from the duals' parts, and an outer level's by the
    Function's jvp rule. torch runs a jvp rule with forward mode off, so
    what it computes is invisible to any level outside its own; peeling the
    innermost level here is what makes the nested jvps (the "jvp" residual's
    second derivatives) exact. Three levels and more are refused."""
    u = u if u.ndim == 3 else u[None]
    levels, innermost = _jvp_levels()
    if levels > 2:
        raise ValueError(f"the wire-group product takes at most 2 nested jvps, not {levels}")
    if innermost:
        s_p, s_t = fwAD.unpack_dual(state)
        u_p, u_t = fwAD.unpack_dual(u)
        if s_t is not None or u_t is not None:
            tangent = None
            if s_t is not None:
                tangent = product(s_t, u_p, n, w0)
            if u_t is not None:
                t = product(s_p, u_t, n, w0)
                tangent = t if tangent is None else tangent + t
            return fwAD.make_dual(product(s_p, u_p, n, w0), tangent)
    return WireGroupProduct.apply(state, u, n, w0, 1)
