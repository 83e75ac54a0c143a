"""The port's truncated Fock-space engine (qcpinn_tpu_torch/ops/fock.py)
against the JAX package's (qcpinn_tpu/ops/fock.py) on the same numpy
inputs: every gate matrix and readout at d <= 6 (atol 1e-5, as
tests/test_fock.py), the state reshapes, the capturable matrix exponential
against scipy's (complex64 and complex128, derivatives to second order),
and the complex128 switch."""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch.func import jvp

from qcpinn_tpu.ops import fock as jf
from qcpinn_tpu_torch.ops import fock as tf

D = 5
ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name,args", [
    ("displacement", (0.37, -1.1)), ("displacement", (0.9, 2.3)),
    ("squeezing", (0.37, -1.1)), ("squeezing", (-0.6, 0.4)),
    ("beamsplitter", (0.37, -1.1)), ("beamsplitter", (math.pi / 2, 0.0)),
    ("rotation", (1.1,)), ("kerr", (0.7,)), ("cubic_phase", (0.37,)),
    ("cubic_phase", (-1.3,)), ("cross_kerr_diag", (0.45,)),
])
def test_gate_matrices_match_jax(name, args):
    want = np.asarray(getattr(jf, name)(*[jnp.float32(a) for a in args], D))
    got = _np(getattr(tf, name)(*[torch.tensor(a) for a in args], D))
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_batched_gates_match_jax_per_element():
    """One batched exponential ([B, d, d], the encoding's per-sample
    displacements) equals JAX's vmap of the scalar gate."""
    import jax

    rng = np.random.default_rng(0)
    r = rng.uniform(-1.5, 1.5, 7).astype(np.float32)
    phi = rng.uniform(-3, 3, 7).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b: jf.displacement(a, b, D))(r, phi))
    got = _np(tf.displacement(torch.tensor(r), torch.tensor(phi), D))
    np.testing.assert_allclose(got, want, atol=ATOL)
    t = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.vmap(lambda a: jf.beamsplitter(a, -a, 3)))(t))
    np.testing.assert_allclose(_np(tf.beamsplitter(torch.tensor(t), torch.tensor(-t), 3)),
                               want, atol=ATOL)


def _state(rng, b, m, d):
    s = rng.normal(size=(b, d**m)) + 1j * rng.normal(size=(b, d**m))
    return (s / np.linalg.norm(s, axis=1, keepdims=True)).astype(np.complex64)


def test_readouts_match_jax():
    rng = np.random.default_rng(1)
    m, d = 3, 4
    st = _state(rng, 5, m, d)
    for name in ("mode_marginals", "number_expvals", "quad_x_expvals"):
        want = np.asarray(getattr(jf, name)(jnp.asarray(st), m, d))
        got = _np(getattr(tf, name)(torch.tensor(st), m, d))
        np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(_np(tf.vacuum(2, m, d)), np.asarray(jf.vacuum(2, m, d)))


@pytest.mark.parametrize("modes", [(0, 1), (2, 0), (1, 2)])
def test_state_ops_match_jax(modes):
    rng = np.random.default_rng(2)
    m, d = 3, 3
    st = _state(rng, 4, m, d)
    a, b = modes
    u1 = np.asarray(jf.displacement(jnp.float32(0.4), jnp.float32(0.3), d))
    ub = np.stack([np.asarray(jf.squeezing(jnp.float32(0.1 * i), jnp.float32(0.2), d))
                   for i in range(4)])
    u2 = np.asarray(jf.beamsplitter(jnp.float32(0.7), jnp.float32(-0.2), d))
    table = np.asarray(jf.cross_kerr_diag(jnp.float32(0.3), d))
    cases = [
        (jf.apply_1m(jnp.asarray(st), m, d, a, jnp.asarray(u1)),
         tf.apply_1m(torch.tensor(st), m, d, a, torch.tensor(u1))),
        (jf.apply_1m(jnp.asarray(st), m, d, b, jnp.asarray(ub)),
         tf.apply_1m(torch.tensor(st), m, d, b, torch.tensor(ub))),
        (jf.apply_2m(jnp.asarray(st), m, d, a, b, jnp.asarray(u2)),
         tf.apply_2m(torch.tensor(st), m, d, a, b, torch.tensor(u2))),
        (jf.apply_diag_2m(jnp.asarray(st), m, d, a, b, jnp.asarray(table)),
         tf.apply_diag_2m(torch.tensor(st), m, d, a, b, torch.tensor(table))),
        (jf.apply_1m(jnp.asarray(st), m, d, a, jf.kerr(jnp.float32(0.7), d)),
         tf.apply_diag_1m(torch.tensor(st), m, d, a, tf.kerr_diag(torch.tensor(0.7), d))),
    ]
    for want, got in cases:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _skew(rng, shape, scale):
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return scale[:, None, None] * (a - np.conj(np.swapaxes(a, -1, -2)))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_expm_matches_scipy(dtype):
    """1-norms from about 1e-3 to 1,000 (0 to 9 squarings), the error relative to
    max|ref| of scipy's double-precision exp: in complex64 no more than
    twice the JAX package's own complex64 ``expm`` error on the matrix
    (+2e-7; each squaring doubles a rounding error), in complex128 1e-13."""
    from jax.scipy.linalg import expm as jax_expm

    rng = np.random.default_rng(3)
    scale = np.repeat([1e-3, 0.3, 1.0, 3.0, 30.0, 100.0], 3)
    A = _skew(rng, (len(scale), 6, 6), scale)
    got = _np(tf.expm(torch.tensor(A, dtype=dtype)))
    for a, g in zip(A, got):
        want = scipy.linalg.expm(a)
        err = np.abs(g - want).max() / np.abs(want).max()
        if dtype == torch.complex64:
            jax_err = np.abs(np.asarray(jax_expm(jnp.asarray(a.astype(np.complex64))))
                             - want).max() / np.abs(want).max()
            assert err <= 2.0 * jax_err + 2e-7, (err, jax_err)
        else:
            assert err <= 1e-13, err
    # a non-normal matrix, and the limit of squarings gives NaN as JAX's
    B = np.triu(rng.normal(size=(5, 5)), 1) + np.diag(rng.normal(size=5))
    np.testing.assert_allclose(_np(tf.expm(torch.tensor(B, dtype=torch.complex128))),
                               scipy.linalg.expm(B), rtol=1e-12, atol=1e-12)
    big = torch.tensor(1e6 * np.eye(3), dtype=dtype)
    assert torch.isnan(tf.expm(big)).all()


def test_expm_derivatives_match_matrix_exp():
    """First and second forward derivatives and the reverse gradient of the
    exponential, in complex128, against torch.linalg.matrix_exp's."""
    rng = np.random.default_rng(4)
    A = torch.tensor(_skew(rng, (6, 5, 5), np.array([0.1, 1, 2, 5, 10, 40.0])))
    T = torch.tensor(_skew(rng, (6, 5, 5), np.ones(6)))

    def second(f):
        return jvp(lambda a: jvp(f, (a,), (T,))[1], (A,), (T,))

    (d1, d2), (r1, r2) = second(tf.expm), second(torch.linalg.matrix_exp)
    torch.testing.assert_close(d1, r1, rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(d2, r2, rtol=1e-11, atol=1e-11)
    a1 = A.clone().requires_grad_(True)
    tf.expm(a1).real.sum().backward()
    a2 = A.clone().requires_grad_(True)
    torch.linalg.matrix_exp(a2).real.sum().backward()
    torch.testing.assert_close(a1.grad, a2.grad, rtol=1e-11, atol=1e-11)


def test_quantum_optics_identities():
    """The JAX tests' identities (tests/test_fock.py): a coherent state's
    Poisson statistics and <x> = 2 alpha; <n> = sinh^2 r of a squeezed
    vacuum; the pi/2 beamsplitter swaps |0,1>; Kerr and rotation
    keep the number."""
    d, r = 24, 0.6
    out = tf.apply_1m(tf.vacuum(1, 1, d), 1, d, 0, tf.displacement(torch.tensor(r),
                                                                  torch.tensor(0.0), d))
    assert abs(float(tf.number_expvals(out, 1, d)[0, 0]) - r * r) < 1e-3 * r * r
    marg = _np(tf.mode_marginals(out, 1, d))[0, 0]
    for n in range(4):
        assert abs(marg[n] - math.exp(-r * r) * r ** (2 * n) / math.factorial(n)) < 1e-5
    assert abs(float(tf.quad_x_expvals(out, 1, d)[0, 0]) - 2 * r) < 2e-3 * r
    sq = tf.apply_1m(tf.vacuum(1, 1, 30), 1, 30, 0,
                     tf.squeezing(torch.tensor(0.4), torch.tensor(0.0), 30))
    assert abs(float(tf.number_expvals(sq, 1, 30)[0, 0]) - math.sinh(0.4) ** 2) < 1e-3
    st = torch.zeros(1, 25, dtype=torch.complex64)
    st[0, 1] = 1.0
    bs = tf.beamsplitter(torch.tensor(math.pi / 2), torch.tensor(0.0), 5)
    n = _np(tf.number_expvals(tf.apply_2m(st, 2, 5, 0, 1, bs), 2, 5))[0]
    np.testing.assert_allclose(n, [1.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(_np(bs @ bs.mH), np.eye(25), atol=1e-5)
    three = torch.zeros(1, 6, dtype=torch.complex64)
    three[0, 3] = 1.0
    for diag in (tf.kerr_diag(torch.tensor(0.7), 6), tf.rotation_diag(torch.tensor(1.1), 6)):
        out = tf.apply_diag_1m(three, 1, 6, 0, diag)
        assert abs(float(tf.number_expvals(out, 1, 6)[0, 0]) - 3.0) < 1e-5
    np.testing.assert_allclose(tf.lowering(4), jf.lowering(4), atol=1e-7)


def test_complex128_switch():
    """QCPINN_FOCK_DTYPE=complex128, read at import, puts the engine in
    double."""
    code = ("from qcpinn_tpu_torch.ops import fock; import torch\n"
            "g = fock.displacement(torch.tensor(0.3), torch.tensor(0.1), 4)\n"
            "print(fock.CDTYPE, fock.FDTYPE, g.dtype)\n")
    env = dict(os.environ, PYTHONPATH=REPO, QCPINN_FOCK_DTYPE="complex128")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["torch.complex128", "torch.float64", "torch.complex128"]
