"""The Cz engine's wire-group product (``ops/wire_group.py``) on the CPU: the
Function's forward bit-equal to the einsum the engine ran, its reverse
against autograd of that einsum, its vmap, jvp and checkpoint paths, and
every order of reverse mode.

The test marked ``chip`` holds the CUDA kernels to the plain versions on the
card (``chip_smoke.py --cz-phase`` holds them at the cells' shapes):

    python -m pytest --noconftest tests/test_torch_cz_wire_group.py -m chip
"""

import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from qcpinn_tpu_torch.models import czochralski as cz
from qcpinn_tpu_torch.ops import wire_group as wg

GROUPS = [(n, w0, k) for n in (5, 6, 7, 8) for w0, k in cz._wire_groups(n)]
KINDS = ("shared", "row", "eval")
ROWS, EVALS = 6, 3  # "eval": 3 unitaries of 2 rows each


def _c(gen, *shape, dtype=torch.complex64):
    return torch.randn(*shape, generator=gen, dtype=dtype)


def _operands(n, k, kind, dtype=torch.complex64, seed=0):
    gen = torch.Generator().manual_seed(seed + 31 * n + k)
    nu = {"shared": 1, "row": ROWS, "eval": EVALS}[kind]
    return _c(gen, ROWS, 1 << n, dtype=dtype), _c(gen, nu, 1 << k, 1 << k, dtype=dtype)


def _einsum(s, u, n, w0):
    """The engine's einsum, in the form of each kind of unitary."""
    nu, g = u.shape[0], u.shape[-1]
    k = g.bit_length() - 1
    r, h = s.shape[0], 1 << (n - w0 - k)
    if nu == 1:
        out = torch.einsum("ij,bljh->blih", u[0], s.reshape(r, 1 << w0, g, h))
    elif nu == r:
        out = torch.einsum("bij,bljh->blih", u, s.reshape(r, 1 << w0, g, h))
    else:
        out = torch.einsum("uij,ubljh->ublih", u, s.reshape(nu, r // nu, 1 << w0, g, h))
    return out.reshape(r, 1 << n)


def _rel(a, b):
    return float((a - b).detach().abs().max() / b.detach().abs().max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,w0,k", GROUPS)
def test_product_is_the_einsum_and_its_reverse_autograd_of_it(n, w0, k, kind):
    s, u = _operands(n, k, kind)
    wg.reset_launches()
    s1, u1 = s.clone().requires_grad_(), u.clone().requires_grad_()
    out = wg.product(s1, u1, n, w0)
    assert torch.equal(out, _einsum(s, u, n, w0))
    s2, u2 = s.clone().requires_grad_(), u.clone().requires_grad_()
    ref = _einsum(s2, u2, n, w0)
    g = _c(torch.Generator().manual_seed(7), *out.shape)
    got = torch.autograd.grad(out, (s1, u1), g)
    want = torch.autograd.grad(ref, (s2, u2), g)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-6
    # only the needed gradient: the encode's first group acts on |0...0>
    (gu,) = torch.autograd.grad(wg.product(s, u1, n, w0), (u1,), g)
    assert torch.equal(gu, got[1])
    assert wg.LAUNCHES == {"wire_group_fwd": 0, "wire_group_bwd": 0}


@pytest.mark.parametrize("kind,n,w0,k", [("shared", 3, 0, 2), ("row", 3, 1, 2),
                                         ("eval", 4, 3, 1)])
def test_every_order_of_reverse_mode(kind, n, w0, k):
    """The reverse is a Function too, whose reverse is made of the two:
    the "rev" residual's third order goes through it."""
    s, u = _operands(n, k, kind, dtype=torch.complex128)
    s.requires_grad_()
    u.requires_grad_()

    def f(s, u):
        return wg.product(s, u, n, w0)

    assert torch.autograd.gradcheck(f, (s, u), fast_mode=True)
    assert torch.autograd.gradgradcheck(f, (s, u), fast_mode=True)


@pytest.mark.parametrize("n,w0,k", [(5, 0, 4), (5, 4, 1), (6, 4, 2)])
def test_vmap_rule_as_the_shift_rules_call_it(n, w0, k):
    """Batched unitaries on an unbatched state (the encode's first group),
    on a batched state (the Rot groups), and per-row unitaries batched."""
    gen = torch.Generator().manual_seed(3)
    b, e, g = 4, 3, 1 << k
    s0 = _c(gen, b, 1 << n)
    u_eval = _c(gen, e, g, g)
    u_rows = _c(gen, e, b, g, g)
    s_eval = _c(gen, e, b, 1 << n)

    def plain(s, u):
        return torch.func.vmap(lambda s, u: wg.product_plain(
            s, u if u.ndim == 3 else u[None], n, w0))(s, u)

    cases = [(lambda u: wg.product(s0, u, n, w0), (u_eval,), lambda: torch.stack(
        [_einsum(s0, u_eval[i][None], n, w0) for i in range(e)])),
             (lambda u: wg.product(s0, u, n, w0), (u_rows,), lambda: torch.stack(
                 [_einsum(s0, u_rows[i], n, w0) for i in range(e)])),
             (lambda s, u: wg.product(s, u, n, w0), (s_eval, u_eval),
              lambda: plain(s_eval, u_eval)),
             (lambda s: wg.product(s, u_eval[0], n, w0), (s_eval,), lambda: torch.stack(
                 [_einsum(s_eval[i], u_eval[0][None], n, w0) for i in range(e)]))]
    for fn, args, want in cases:
        got = torch.func.vmap(fn)(*args)
        ref = want()
        assert got.shape == ref.shape and _rel(got, ref) <= 1e-6


def test_vmap_rule_in_the_shift_rules():
    """``_CzShiftRules.vjp``'s vmapped evaluations against one call a row of
    the shift table."""
    from qcpinn_tpu_torch.train.hardware_grad import make_hw_apply_cz

    layer = cz.CzQuantumLayer(5, 1)
    w = layer.init(torch.Generator().manual_seed(0))
    x = torch.rand((3, 5), generator=torch.Generator().manual_seed(1))
    w1, x1 = w.clone().requires_grad_(), x.clone().requires_grad_()
    wg.reset_launches()
    z = make_hw_apply_cz(layer, None, chunk=8)(w1, x1)
    g = torch.rand(z.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(z, (w1, x1), g)
    w2, x2 = w.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad(layer.apply(w2, x2), (w2, x2), g)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4
    assert wg.LAUNCHES == {"wire_group_fwd": 0, "wire_group_bwd": 0}


def _jvp_paths(s_t, u_t, s_tt):
    """(u, tangent) of the product at (s, u) along (s_t, u_t) three ways:
    one ``torch.func.jvp``, the jvp rule alone (a forward-mode dual), and
    the mixed second derivative at a = b = 0 of the product at ``((1 + a) s
    + b s_tt, (1 + b) u + a u_t)`` by nested ``torch.func.jvp``s (the "jvp"
    residual's path: ``U s + U_t s_tt``), each by the Function (``product``)
    or the einsum."""
    from torch.func import jvp

    def one(prod, s, u):
        return jvp(prod, (s, u), (s_t, u_t))

    def dual(prod, s, u):
        with fwAD.dual_level():
            out = prod(fwAD.make_dual(s, s_t), fwAD.make_dual(u, u_t))
            return tuple(fwAD.unpack_dual(out))

    def nested(prod, s, u):
        a0, b0, one_ = torch.zeros(()), torch.zeros(()), torch.ones(())

        def f(a, b):
            return prod((1 + a) * s + b * s_tt, (1 + b) * u + a * u_t)

        def inner(b):
            return jvp(lambda a: f(a, b), (a0,), (one_,))

        (out, _), (_, second) = jvp(inner, (b0,), (one_,))
        return out, second

    return one, dual, nested


@pytest.mark.parametrize("n,w0,k", [(5, 0, 4), (6, 4, 2), (8, 4, 4)])
def test_jvp_rule_and_reverse_over_it(n, w0, k):
    s, u = _operands(n, k, "shared")
    gen = torch.Generator().manual_seed(5)
    tangents = (_c(gen, *s.shape), _c(gen, *u.shape), _c(gen, *s.shape))
    funcs = (lambda s, u: wg.product(s, u, n, w0), lambda s, u: _einsum(s, u, n, w0))
    for path in _jvp_paths(*tangents):
        outs = []
        for fn in funcs:
            s1, u1 = s.clone().requires_grad_(), u.clone().requires_grad_()
            out, tan = path(fn, s1, u1)
            outs.append((out, tan, *torch.autograd.grad((tan.abs() ** 2).sum(), (s1, u1))))
        for a, b in zip(*outs):
            assert _rel(a, b) <= 1e-6
        assert float(outs[0][1].abs().max()) > 0


def test_three_nested_jvps_are_refused():
    from torch.func import jvp

    s, u = _operands(5, 4, "shared")

    def f(a):
        return wg.product(s * a, u, 5, 0).sum()

    one = torch.ones(())
    d1 = lambda a: jvp(f, (a,), (one,))[1]  # noqa: E731
    d2 = lambda a: jvp(d1, (a,), (one,))[1]  # noqa: E731
    with pytest.raises(ValueError, match="at most 2 nested jvps"):
        jvp(d2, (one,), (one,))


def test_inside_a_non_reentrant_checkpoint():
    n = 8
    s, u = _operands(n, 4, "shared")
    _, v = _operands(n, 4, "row", seed=1)

    def segment(s, u, v):
        return wg.product(wg.product(s, u, n, 0), v, n, 4)

    grads = []
    for wrap in (False, True):
        args = [t.clone().requires_grad_() for t in (s, u, v)]
        out = checkpoint(segment, *args, use_reentrant=False) if wrap else segment(*args)
        grads.append(torch.autograd.grad((out.abs() ** 2).sum(), args))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cuda_checks_refuse_what_the_kernels_do_not_take():
    s = torch.zeros(4, 1 << 6, dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        wg.check_cuda(s.to(torch.complex128), torch.zeros(1, 4, 4, dtype=torch.complex128),
                      6, 0, 1)
    with pytest.raises(ValueError, match="G in 2, 4, 8, 16"):
        wg.check_cuda(s, torch.zeros(1, 32, 32, dtype=torch.complex64), 6, 0, 1)
    with pytest.raises(ValueError, match="wires"):
        wg.check_cuda(s, torch.zeros(1, 16, 16, dtype=torch.complex64), 6, 4, 1)
    with pytest.raises(ValueError, match="do not split"):
        wg.check_cuda(s, torch.zeros(3, 4, 4, dtype=torch.complex64), 6, 0, 1)
    assert wg.check_cuda(s, torch.zeros(2, 4, 4, dtype=torch.complex64), 6, 2, 3) == 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,w0,k", GROUPS + [(12, 8, 4), (12, 0, 4), (10, 8, 2)])
def test_kernels_against_the_plain_versions(card, n, w0, k, kind):
    s, u = _operands(n, k, kind)
    g = _c(torch.Generator().manual_seed(9), *s.shape)
    out = wg.product(s.to(card), u.to(card), n, w0).cpu()
    assert _rel(out, wg.product_plain(s, u, n, w0)) <= 1e-6
    got = wg.WireGroupVjp.apply(g.to(card), s.to(card), u.to(card), n, w0, 1, True, True)
    want = wg.vjp_plain(g, s, u, n, w0, 1, True, True)
    for a, b in zip(got, want):
        assert _rel(a.cpu(), b) <= 1e-5
