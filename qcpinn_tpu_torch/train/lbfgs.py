"""Full-batch L-BFGS refinement (port of qcpinn_tpu/train/lbfgs.py).

The reference trains with Adam only (nn/DVPDESolver.py:59-64) and plateaus
there; the usual PINN recipe is Adam, then L-BFGS on a FIXED collocation
set (a deterministic full-batch quasi-Newton step that polishes into the
basin). The JAX package runs ``optax.lbfgs(memory_size=20)`` with
``optax.scale_by_zoom_linesearch(max_linesearch_steps=20)`` for exactly
``steps`` iterations; this module is that algorithm written out in torch:

- the two-loop recursion over the last ``memory_size`` differences of
  parameters and gradients (Nocedal and Wright, Algorithm 7.4), the
  identity scaled by (dw.du)/(du.du), and on the first step by
  min(1, 1/|g|) (optax's ``scale_by_lbfgs``);
- the zoom line search (Nocedal and Wright, Algorithms 3.5 and 3.6, with
  Hager and Zhang's approximate decrease test, optax's
  ``zoom_linesearch``): an interval search from the previous step size
  (optax's ``initial_guess_strategy="keep"``), doubling it, then cubic,
  quadratic or bisection steps inside the interval, a step that satisfies
  sufficient decrease kept as the fallback;
- the value and gradient found by the line search reused at the next
  iterate (``optax.value_and_grad_from_state``).

``torch.optim.LBFGS`` is a different algorithm: its tolerances end a run
early and its line search picks other steps. The parameters are one f32
vector inside; the line search's scalar logic runs on the host in double
precision, one read of the device a line-search iteration.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

MAX_LINESEARCH_STEPS = 20
TOL = 0.0
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5  # optax's stepsize_precision


def _flatten(params):
    """(f32 vector, unflatten) of a tensor, a sequence or a dict of
    tensors."""
    if isinstance(params, torch.Tensor):
        leaves, rebuild = [params], lambda ls: ls[0]
    elif isinstance(params, dict):
        keys = list(params)
        leaves, rebuild = [params[k] for k in keys], lambda ls: dict(zip(keys, ls))
    else:
        leaves, rebuild = list(params), lambda ls: type(params)(ls)
    shapes = [tuple(p.shape) for p in leaves]
    sizes = [p.numel() for p in leaves]
    vec = torch.cat([p.detach().reshape(-1).to(torch.float32) for p in leaves])

    def unflatten(v):
        return rebuild([c.reshape(s) for c, s in zip(torch.split(v, sizes), shapes)])

    return vec, unflatten


def _nan_max(a, b):
    return math.nan if (math.isnan(a) or math.isnan(b)) else max(a, b)


def _nan_min(a, b):
    return math.nan if (math.isnan(a) or math.isnan(b)) else min(a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (then it is not used)."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb, c, fc = map(np.float64, (a, fa, fpa, b, fb, c, fc))
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1, r2 = fb - fa - fpa * db, fc - fa - fpa * dc
        A = (dc**2 * r1 - db**2 * r2) / denom
        B = (-(dc**3) * r1 + db**3 * r2) / denom
        return float(a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb = map(np.float64, (a, fa, fpa, b, fb))
        db = b - a
        B = (fb - fa - fpa * db) / (db**2)
        return float(a - fpa / (2.0 * B))


def _decrease_error(stepsize, value, slope, value0, slope0):
    """Sufficient decrease (Armijo), or near a minimum Hager and Zhang's
    approximate decrease, whichever holds better; 0 when it holds, inf for
    NaN."""
    err = value - value0 - SLOPE_RTOL * stepsize * slope0
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope0
    approx = _nan_max(approx, value - value0 - APPROX_DEC_RTOL * abs(value0))
    err = _nan_max(_nan_min(approx, err), 0.0)
    return math.inf if math.isnan(err) else err


def _curvature_error(slope, slope0):
    err = _nan_max(abs(slope) - CURV_RTOL * abs(slope0), 0.0)
    return math.inf if math.isnan(err) else err


def _zoom_linesearch(value_and_grad, x, u, value0_t, grad0, guess):
    """A step size along ``u`` from ``x`` (where the loss is ``value0_t``
    and its gradient ``grad0``) satisfying sufficient decrease and small
    curvature: (step size, value there, gradient there)."""
    value0 = float(value0_t)
    slope0 = float(torch.dot(u, grad0))

    def on_line(t):
        v, g = value_and_grad(x + t * u)
        return float(v), v, g, float(torch.dot(g, u))

    s = dict(count=0, stepsize=0.0, value=value0, vt=value0_t, grad=grad0, slope=slope0,
             dec=math.inf, interval_found=False, done=False, failed=False,
             low=0.0, value_low=value0, slope_low=slope0,
             high=0.0, value_high=value0, slope_high=slope0,
             cubic_ref=0.0, value_cubic_ref=value0,
             safe=0.0, safe_value=value0, safe_vt=value0_t, safe_grad=grad0)
    while not (s["done"] or s["failed"]):
        it = s["count"]
        if not s["interval_found"]:
            # the interval search (Algorithm 3.5)
            t = guess if it == 0 else INCREASE_FACTOR * s["stepsize"]
            value, vt, grad, slope = on_line(t)
            dec = _decrease_error(t, value, slope, value0, slope0)
            err = max(dec, _curvature_error(slope, slope0))
            if dec <= TOL:
                s.update(safe=t, safe_value=value, safe_vt=vt, safe_grad=grad)
            high_new = dec > 0.0 or (value >= s["value"] and it > 0)
            low_new = slope >= 0.0 and not high_new
            prev = (s["stepsize"], s["value"], s["slope"])
            new = (t, value, slope)
            lo, hi = (new, prev) if low_new else (prev, new)
            s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                     high=hi[0], value_high=hi[1], slope_high=hi[2],
                     cubic_ref=lo[0], value_cubic_ref=lo[1],
                     interval_found=high_new or low_new or err <= TOL,
                     done=err <= TOL)
            s["failed"] = it + 1 >= MAX_LINESEARCH_STEPS and not s["done"]
        else:
            # the zoom (Algorithm 3.6)
            low, high = s["low"], s["high"]
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            mc = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                           s["cubic_ref"], s["value_cubic_ref"])
            mq = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
            if left + 0.2 * delta < mc < right - 0.2 * delta:
                t = mc
            elif left + 0.1 * delta < mq < right - 0.1 * delta:
                t = mq
            else:
                t = (low + high) / 2.0
            value, vt, grad, slope = on_line(t)
            dec = _decrease_error(t, value, slope, value0, slope0)
            err = max(dec, _curvature_error(slope, slope0))
            if dec <= TOL and value < s["safe_value"]:
                s.update(safe=t, safe_value=value, safe_vt=vt, safe_grad=grad)
            done = err <= TOL
            high_mid = dec > 0.0 or value >= s["value_low"]
            high_low = slope * (high - low) >= 0.0 and not high_mid
            old_low = (low, s["value_low"], s["slope_low"])
            old_high = (high, s["value_high"], s["slope_high"])
            mid = (t, value, slope)
            hi = old_low if high_low else (mid if high_mid else old_high)
            lo = old_low if high_mid else mid
            ref = old_high if (high_mid or high_low) else old_low
            s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                     high=hi[0], value_high=hi[1], slope_high=hi[2],
                     cubic_ref=ref[0], value_cubic_ref=ref[1], done=done)
            presumably = (it + 1 >= MAX_LINESEARCH_STEPS
                          or (delta <= INTERVAL_THRESHOLD and s["safe"] > 0.0))
            s["failed"] = presumably and not done
        s.update(count=it + 1, stepsize=t, value=value, vt=vt, grad=grad, slope=slope,
                 dec=dec)
        if s["failed"] and (s["safe"] > 0.0 or math.isinf(s["dec"])):
            # fall back on the step with sufficient decrease, if any
            s.update(stepsize=s["safe"], vt=s["safe_vt"], grad=s["safe_grad"])
    return s["stepsize"], s["vt"], s["grad"]


class _LBFGS:
    """optax's ``scale_by_lbfgs`` state and update on a flat vector."""

    def __init__(self, x: torch.Tensor, memory_size: int):
        self.m = memory_size
        self.count = 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dw = torch.zeros((memory_size,) + x.shape, dtype=x.dtype, device=x.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = [0.0] * memory_size

    def direction(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """P_k g: the approximate inverse Hessian times the gradient, after
        storing the newest differences."""
        idx = self.count % self.m
        if self.count > 0:
            dw, du = x - self.params, g - self.updates
            vdot = float(torch.dot(du, dw))
            den = float(torch.dot(du, du))
            self.dw[(self.count - 1) % self.m] = dw
            self.du[(self.count - 1) % self.m] = du
            self.rho[(self.count - 1) % self.m] = 0.0 if vdot == 0.0 else 1.0 / vdot
            scale = vdot / den if den > 0.0 else 1.0
        else:
            norm = float(torch.linalg.vector_norm(g))
            scale = min(1.0, 1.0 / norm) if norm > 0.0 else 1.0
        order = [(idx + j) % self.m for j in range(self.m)]
        vec, alphas = g, {}
        for j in reversed(order):
            alphas[j] = self.rho[j] * float(torch.dot(self.dw[j], vec))
            vec = vec - alphas[j] * self.du[j]
        vec = scale * vec
        for j in order:
            beta = self.rho[j] * float(torch.dot(self.du[j], vec))
            vec = vec + (alphas[j] - beta) * self.dw[j]
        self.params, self.updates = x, g
        self.count += 1
        return vec


def lbfgs_refine(
    loss_fn: Callable,
    params,
    steps: int,
    memory_size: int = 20,
    chunk: Optional[int] = None,
) -> Tuple[object, torch.Tensor]:
    """Minimise the deterministic ``loss_fn(params) -> scalar`` with L-BFGS
    for exactly ``steps`` iterations. ``params`` is a tensor, a sequence or
    a dict of tensors (left unchanged); returns ``(refined params of the
    same structure, losses [steps])``, each loss the value at the start of
    its iteration. ``loss_fn`` must be pure and batch-fixed (sample the
    collocation set ONCE outside). ``chunk`` splits the run into chunks of
    that many iterations (the state carries across, so the result is the
    same), each chunk's losses read once."""
    x, unflatten = _flatten(params)

    def value_and_grad(v):
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            val = loss_fn(unflatten(v))
            (g,) = torch.autograd.grad(val, v, allow_unused=True)
        return val.detach().to(torch.float32), (torch.zeros_like(v) if g is None else g)

    opt = _LBFGS(x, memory_size)
    value_t, grad, stepsize = None, None, 1.0
    chunk = chunk or steps
    losses = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        vals = []
        for _ in range(n):
            if value_t is None or not math.isfinite(float(value_t)):
                value_t, grad = value_and_grad(x)
            vals.append(value_t)
            u = -opt.direction(x, grad)
            stepsize, value_t, grad = _zoom_linesearch(
                value_and_grad, x, u, value_t, grad, stepsize)
            x = x + stepsize * u
        losses.append(torch.stack(vals))
        done += n
    out = torch.cat(losses) if losses else torch.zeros(0)
    return unflatten(x.detach()), out


def make_fixed_batch_loss(
    model_apply: Callable,
    operator: Optional[Callable],
    batches: dict,
    weights: dict,
    kinds: dict,
) -> Callable:
    """The deterministic composite loss over pre-sampled batches:
    ``loss_fn(params)``. ``batches[name] = (X, y)``; ``kinds[name]`` is
    'residual' (the PDE operator through the model) or 'value' (a direct
    MSE), as ``train/loop.py``'s TermSpec; ``model_apply(params, X)``."""

    def loss_fn(params):
        total = 0.0
        for name, (X, y) in batches.items():
            if kinds[name] == "residual":
                _, pred = operator(lambda Xp: model_apply(params, Xp), X)
            else:
                pred = model_apply(params, X)
            total = total + weights[name] * torch.mean((pred - y) ** 2)
        return total

    return loss_fn
