"""NN building blocks (port of qcpinn_tpu/models/nn_core.py).

Initialization matches the reference: ``xavier_normal_`` weights and zero
bias (nn/DVPDESolver.py:69-76). Layers are ``nn.Linear`` (weight
``[out, in]``; the JAX package stores ``w[in, out]``, see bridge.py).
Every random draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


def linear_init(
    in_dim: int, out_dim: int, generator: Optional[torch.Generator] = None,
    bias: bool = True,
) -> nn.Linear:
    """Xavier-normal weight (std = sqrt(2/(in+out))), zero bias (none with
    ``bias=False``)."""
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    std = math.sqrt(2.0 / (in_dim + out_dim))
    with torch.no_grad():
        layer.weight.copy_(
            std * torch.randn((out_dim, in_dim), generator=generator)
        )
        if bias:
            layer.bias.zero_()
    return layer


def linear_apply(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight, layer.bias)


def mlp_init(
    dims: Sequence[int], generator: Optional[torch.Generator] = None
) -> nn.ModuleList:
    return nn.ModuleList(
        linear_init(dims[i], dims[i + 1], generator) for i in range(len(dims) - 1)
    )


def mlp_apply(
    layers: nn.ModuleList, x: torch.Tensor, final_activation: bool = False
) -> torch.Tensor:
    """Linear -> Tanh -> ... -> Linear."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = linear_apply(layer, x)
        if i < n - 1 or final_activation:
            x = torch.tanh(x)
    return x


def layernorm_init(dim: int) -> nn.ParameterDict:
    """LayerNorm parameters {gamma: ones, beta: zeros}, ``[dim]`` each."""
    return nn.ParameterDict({"gamma": nn.Parameter(torch.ones(dim)),
                             "beta": nn.Parameter(torch.zeros(dim))})


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis, with the biased variance, as JAX's
    ``layernorm_apply``."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return params["gamma"] * (x - mean) * torch.rsqrt(var + eps) + params["beta"]


def count_params(model: nn.Module) -> int:
    """Every tensor of the model: its parameters and its buffers (the
    Fourier map's ``B``, the EMA balancer's state)."""
    return sum(t.numel() for t in (*model.parameters(), *model.buffers()))


def count_trainable(model: nn.Module) -> int:
    """The trainable tensors only. The Fourier-feature matrix ``B`` is drawn
    once and never updated, so it is a buffer and does not count, as in the
    JAX package's ``count_trainable``; the reference's documented model
    sizes count trainable parameters only."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def fourier_features_init(
    in_dim: int, mapping_size: int, scale: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Random Fourier feature matrix B ~ N(0,1) * scale, ``[in, mapping]``:
    a fixed buffer, never trained."""
    return scale * torch.randn((in_dim, mapping_size), generator=generator)


def fourier_features_apply(B: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    proj = 2.0 * math.pi * (x @ B.detach())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def rbf_init(
    in_dim: int,
    count: int,
    centers: Optional[torch.Tensor] = None,
    width: float = 8.0,
    lo: float = 0.0,
    hi: float = 1.0,
    out_dim: int = 1,
    generator: Optional[torch.Generator] = None,
) -> nn.ParameterDict:
    """Anisotropic Gaussian-RBF head parameters {c, w, v, a}.

    Each unit contributes ``a_k * exp(-sum_d (w_kd (x_d - c_kd))^2
    - sum_d v_kd x_d)`` — an exponential of a learnable quadratic, so a
    single unit can represent separable Gaussian pulses exactly (including
    an exp(-lambda*t) decay factor via the linear term ``v``). ``centers``
    overrides the uniform draw (see :func:`rbf_centers_from_samples`)."""
    if centers is None:
        centers = lo + (hi - lo) * torch.rand((count, in_dim), generator=generator)
    w = width * (1.0 + 0.25 * torch.randn((count, in_dim), generator=generator))
    return nn.ParameterDict({
        "c": nn.Parameter(torch.as_tensor(centers, dtype=torch.float32).detach().cpu().clone()),
        "w": nn.Parameter(w),
        "v": nn.Parameter(torch.zeros((count, in_dim))),
        "a": nn.Parameter(torch.full((count, out_dim), 0.1)),
    })


def rbf_centers_from_samples(
    generator: torch.Generator, X: torch.Tensor, weights: torch.Tensor,
    count: int, jitter: float = 0.02,
) -> torch.Tensor:
    """Draw RBF centers from sample points with probability proportional to
    ``|weights|`` (e.g. |forcing| at collocation points), with replacement,
    plus a Gaussian jitter. Draws on the generator's device."""
    w = torch.abs(weights).reshape(-1)
    idx = torch.multinomial(w / torch.sum(w), count, replacement=True,
                            generator=generator)
    noise = torch.randn((count, X.shape[1]), generator=generator, device=X.device)
    return X[idx] + jitter * noise


def rbf_apply(params, x: torch.Tensor) -> torch.Tensor:
    """[B, in] -> [B, out] additive head value (out from a's trailing dim;
    a 1-D ``a`` yields [B, 1])."""
    d = x[:, None, :] - params["c"][None, :, :]
    q = torch.sum((params["w"][None, :, :] * d) ** 2, dim=-1) + torch.sum(
        params["v"][None, :, :] * x[:, None, :], dim=-1
    )
    # the learnable linear term v.x is unbounded below; clamp the exponent
    # so a few bad optimizer steps on v cannot overflow exp(-q) to inf
    out = torch.exp(-torch.clamp(q, min=-30.0)) @ params["a"]
    return out[:, None] if out.ndim == 1 else out


# -- second-order forward jets --------------------------------------------------
# A jet is a primal [B, k] and its tangents [d + len(cols2), B, k]: the
# derivative along each of the d input columns, then the second derivative
# along each column of ``cols2`` (a range of input columns). Every input
# column moves on its own, so a second-order channel needs only its own
# first-order one.


def input_jet(x: torch.Tensor, cols2: range) -> torch.Tensor:
    """The tangents of the input itself: the unit row e_c along column c,
    0 in the second-order channels."""
    d = x.shape[1]
    eye = torch.eye(d + len(cols2), d, dtype=x.dtype, device=x.device)
    return eye[:, None, :].expand(-1, x.shape[0], d)


def linear_jet(layer: nn.Linear, h: torch.Tensor, th: torch.Tensor,
               weight: Optional[torch.Tensor] = None):
    """``linear_apply`` of a jet: one product over all tangent channels, the
    bias on the primal only. ``weight`` overrides the layer's (a column
    slice of it)."""
    w = layer.weight if weight is None else weight
    return F.linear(h, w, layer.bias), F.linear(th, w)


def tanh_jet(a: torch.Tensor, ta: torch.Tensor, cols2: range):
    """``y = tanh(a)``, ``s = 1 - y^2``: ``y' = s a'``,
    ``y'' = s a'' - 2 y s a'^2``."""
    n1 = ta.shape[0] - len(cols2)
    y = torch.tanh(a)
    s = 1.0 - y * y
    t1 = s * ta[:n1]
    t2 = s * ta[n1:] - 2.0 * y * s * ta[cols2.start:cols2.stop] ** 2
    return y, torch.cat([t1, t2])


def layernorm_jet(params, x: torch.Tensor, tx: torch.Tensor, cols2: range,
                  eps: float = 1e-5):
    """``layernorm_apply`` of a jet. With ``d = x - mean(x)``, ``v`` its
    biased variance and ``s = (v + eps)^(-1/2)``: ``d' = x' - mean(x')``,
    ``v' = 2 mean(d d')``, ``v'' = 2 mean(d'^2 + d d'')``, ``s' = -s^3 v' /
    2``, ``s'' = 3 s^5 v'^2 / 4 - s^3 v'' / 2`` and ``(d s)'' = d'' s + 2 d'
    s' + d s''``."""
    n1 = tx.shape[0] - len(cols2)
    lo, hi = cols2.start, cols2.stop
    d = x - torch.mean(x, dim=-1, keepdim=True)
    td = tx - torch.mean(tx, dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, correction=0)
    v1 = 2.0 * torch.mean(d * td[:n1], dim=-1, keepdim=True)
    v2 = 2.0 * torch.mean(td[lo:hi] ** 2 + d * td[n1:], dim=-1, keepdim=True)
    s = torch.rsqrt(v + eps)
    s3 = s ** 3
    s1 = -0.5 * s3 * v1
    s2 = 0.75 * s3 * s * s * v1[lo:hi] ** 2 - 0.5 * s3 * v2
    t1 = td[:n1] * s + d * s1
    t2 = td[n1:] * s + 2.0 * td[lo:hi] * s1[lo:hi] + d * s2
    g = params["gamma"]
    return g * d * s + params["beta"], g * torch.cat([t1, t2])


def fourier_features_jet(B: torch.Tensor, x: torch.Tensor, cols2: range):
    """``fourier_features_apply`` of the input's jet. ``p = 2 pi x B`` has
    the constant row ``2 pi B[c]`` as its tangent along column c and
    ``p'' = 0``, so ``sin' = cos p'``, ``sin'' = -sin p'^2``, and the same
    for cos."""
    dp = 2.0 * math.pi * B.detach()  # [in, m]: dp/dx_c, one row per column
    p = 2.0 * math.pi * (x @ B.detach())
    sn, cs = torch.sin(p), torch.cos(p)
    dp1, dp2 = dp[:, None, :], (dp[cols2.start:cols2.stop] ** 2)[:, None, :]
    t_sin = torch.cat([cs * dp1, -sn * dp2])
    t_cos = torch.cat([-sn * dp1, -cs * dp2])
    return torch.cat([sn, cs], dim=-1), torch.cat([t_sin, t_cos], dim=-1)


def rbf_jet(params, x: torch.Tensor, cols2: range):
    """``rbf_apply`` of the input's jet: ``g = exp(-clamp(q, -30))``,
    ``q' = 2 w_c^2 (x_c - c_c) + v_c``, ``q'' = 2 w_c^2``, ``g' = -g q'``,
    ``g'' = g (q'^2 - q'')``, and no tangent where the clamp holds (as jvp
    through ``torch.clamp`` gives)."""
    c, w, v, a = params["c"], params["w"], params["v"], params["a"]
    d = x[:, None, :] - c[None, :, :]
    q = torch.sum((w[None, :, :] * d) ** 2, dim=-1) + torch.sum(
        v[None, :, :] * x[:, None, :], dim=-1)
    g = torch.exp(-torch.clamp(q, min=-30.0))  # [B, K]
    w2 = w * w
    dq = 2.0 * w2[None] * d + v[None]  # [B, K, in]: dq/dx_c
    lo, hi = cols2.start, cols2.stop
    gl = (g * (q >= -30.0))[..., None]
    t1 = -gl * dq
    t2 = gl * (dq[..., lo:hi] ** 2 - 2.0 * w2[None, :, lo:hi])
    tg = torch.cat([t1, t2], dim=-1).permute(2, 0, 1)  # [in + len(cols2), B, K]
    out, t_out = g @ a, tg @ a
    if out.ndim == 1:
        return out[:, None], t_out[..., None]
    return out, t_out
