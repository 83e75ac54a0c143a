"""Gate matrix constructors (port of qcpinn_tpu/ops/gates.py).

PennyLane conventions: ``RX(t) = exp(-i t X / 2)`` and likewise RY, RZ;
``Rot(phi, theta, omega) = RZ(omega) RY(theta) RZ(phi)``;
``PhaseShift(phi) = diag(1, e^{i phi})``; controlled 2-qubit matrices in
(control, target) order, ``|0><0| (x) I + |1><1| (x) G``.

Constructors take a float tensor of angles, scalar or batched ``[B]``, and
return ``[..., 2, 2]`` (or ``[..., 4, 4]``) complex64 on the angles' device.
"""

from __future__ import annotations

import numpy as np
import torch

CDTYPE = torch.complex64
RDTYPE = torch.float32

_I2 = np.eye(2, dtype=np.complex64)

# Fixed (non-parametric) gates as numpy constants.
H = np.array([[1.0, 1.0], [1.0, -1.0]], dtype=np.complex64) / np.sqrt(2.0)
X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex64)
Y = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=np.complex64)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=np.complex64)

CNOT = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex64
)
CZ = np.diag(np.array([1, 1, 1, -1], dtype=np.complex64))
SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex64
)


_HOST_CONSTS: dict = {}


def host_const(a: np.ndarray, device, dtype=CDTYPE) -> torch.Tensor:
    """A fixed numpy array (a gate matrix, a mask) as a tensor on
    ``device``, built once per content and device: a call then copies
    nothing from the host, so it can be captured in a CUDA graph."""
    a = np.ascontiguousarray(a)
    key = (a.shape, a.dtype.str, a.tobytes(), dtype, torch.device(device))
    if key not in _HOST_CONSTS:
        _HOST_CONSTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return _HOST_CONSTS[key]


def _half(theta) -> torch.Tensor:
    return torch.as_tensor(theta, dtype=RDTYPE) / 2.0


def _mat2(a, b, c, d) -> torch.Tensor:
    """[[a, b], [c, d]] over any batch shape."""
    return torch.stack(
        [torch.stack([a, b], dim=-1), torch.stack([c, d], dim=-1)], dim=-2
    )


def rx(theta) -> torch.Tensor:
    h = _half(theta)
    zero = torch.zeros_like(h)
    c = torch.complex(torch.cos(h), zero)
    s = torch.complex(zero, -torch.sin(h))
    return _mat2(c, s, s, c)


def ry(theta) -> torch.Tensor:
    h = _half(theta)
    zero = torch.zeros_like(h)
    c = torch.complex(torch.cos(h), zero)
    s = torch.complex(torch.sin(h), zero)
    return _mat2(c, -s, s, c)


def rz(theta) -> torch.Tensor:
    h = _half(theta)
    zero = torch.zeros_like(h)
    em = torch.complex(torch.cos(h), -torch.sin(h))
    ep = torch.complex(torch.cos(h), torch.sin(h))
    z = torch.complex(zero, zero)
    return _mat2(em, z, z, ep)


def phase_shift(phi) -> torch.Tensor:
    phi = torch.as_tensor(phi, dtype=RDTYPE)
    zero = torch.zeros_like(phi)
    one = torch.complex(torch.ones_like(phi), zero)
    e = torch.complex(torch.cos(phi), torch.sin(phi))
    z = torch.complex(zero, zero)
    return _mat2(one, z, z, e)


def rot(phi, theta, omega) -> torch.Tensor:
    """PennyLane Rot = RZ(omega) RY(theta) RZ(phi)."""
    return rz(omega) @ ry(theta) @ rz(phi)


def controlled(gate: torch.Tensor) -> torch.Tensor:
    """Lift a (batched) 1-qubit gate to a controlled 2-qubit gate,
    ``diag(I, gate)`` in (control, target) order."""
    batch_shape = gate.shape[:-2]
    eye = host_const(_I2, gate.device).expand(batch_shape + (2, 2))
    zeros = torch.zeros(batch_shape + (2, 2), dtype=CDTYPE, device=gate.device)
    top = torch.cat([eye, zeros], dim=-1)
    bot = torch.cat([zeros, gate.to(CDTYPE)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crx(theta) -> torch.Tensor:
    return controlled(rx(theta))


def cry(theta) -> torch.Tensor:
    return controlled(ry(theta))


def crz(theta) -> torch.Tensor:
    return controlled(rz(theta))


def haar_2q_pair(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's fixed seeded Haar 4x4 unitaries
    (nn/DVQuantumLayer.py:203-209): two ``unitary_group.rvs(4)`` draws from
    ``np.random.RandomState(seed)`` and ``RandomState(seed + 1)``, the same
    draw as the JAX package."""
    from scipy.stats import unitary_group

    u1 = unitary_group.rvs(4, random_state=np.random.RandomState(seed))
    u2 = unitary_group.rvs(4, random_state=np.random.RandomState(seed + 1))
    return u1.astype(np.complex64), u2.astype(np.complex64)
