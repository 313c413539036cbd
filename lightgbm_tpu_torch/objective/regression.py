"""Regression objectives — parity with lightgbm_tpu/objective/regression.py
(src/objective/regression_objective.hpp: L2 :11-77, L1 :78-145, Huber
:147-232, Fair :236-295, Poisson :298-357).

Every objective here is row-local: ``gradients_rowwise`` is the plain
version of the CUDA update kernels' objective (csrc/common.cuh
``gradients``), and ``kernel_params()`` hands the kernel its kind and
three float32 constants ``(kind, p0, p1, p2)``:

    L2       -
    L1       p0 = gaussian_eta
    Huber    p0 = gaussian_eta, p1 = huber_delta
    Fair     p0 = fair_c, p1 = fair_c * fair_c (rounded once)
    Poisson  p0 = poisson_max_delta_step

The float32 operations repeat the JAX expressions one for one, in their
order, with their constants rounded to float32 as JAX rounds a Python
float against a float32 array; exp is ``exp_f32`` (correctly rounded).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import ObjectiveFunction, exp_f32

# csrc/common.cuh ObjKind
KIND_L2, KIND_L1, KIND_HUBER, KIND_FAIR, KIND_POISSON = 1, 2, 3, 4, 5


def _f32(x: float) -> float:
    """A Python float rounded to float32 (JAX's weak-typed constant)."""
    return float(np.float32(x))


SQRT_2PI = _f32(math.sqrt(2.0 * math.pi))
MIN_C = _f32(1.0e-10)


def _gaussian_hessian(score, label, grad, eta: float, w=None):
    """Common::ApproximateHessianWithGaussian (utils/common.h:486-496) as
    JAX ``_gaussian_hessian`` writes it: the weight enters twice, once in
    ``a`` and once in front."""
    x = torch.abs(score - label)
    a = 2.0 * torch.abs(grad)
    if w is not None:
        a = a * w
    c = torch.clamp_min((torch.abs(score) + torch.abs(label)) * eta, MIN_C)
    e = exp_f32(-x * x / (2.0 * c * c))
    if w is not None:
        e = w * e
    return e * a / (c * SQRT_2PI)


def _weighted(grad, hess, weight):
    if weight is not None:
        return grad * weight, hess * weight
    return grad, hess


class RegressionL2Loss(ObjectiveFunction):
    """grad = score - label, hess = 1, both times the row weight."""

    name = "regression"
    rowwise = True

    def __init__(self, config):
        pass

    def gradients_rowwise(self, score, label, weight):
        return _weighted(score - label, torch.ones_like(score), weight)

    def kernel_params(self):
        return (KIND_L2, 1.0, 1.0, 1.0)

    @property
    def boost_from_average(self) -> bool:
        return True


class RegressionL1Loss(ObjectiveFunction):
    """grad = sign(diff) * w, hess = the Gaussian approximation scaled by
    gaussian_eta (regression_objective.hpp:96-118)."""

    name = "regression_l1"
    rowwise = True

    def __init__(self, config):
        self.eta = _f32(config.gaussian_eta)

    def gradients_rowwise(self, score, label, weight):
        grad = torch.where(score - label >= 0.0, 1.0, -1.0).to(torch.float32)
        if weight is not None:
            grad = grad * weight
        return grad, _gaussian_hessian(score, label, grad, self.eta, weight)

    def kernel_params(self):
        return (KIND_L1, self.eta, 0.0, 0.0)

    @property
    def boost_from_average(self) -> bool:
        return True


class RegressionHuberLoss(ObjectiveFunction):
    """Quadratic inside huber_delta, linear outside with the Gaussian
    hessian (regression_objective.hpp:169-206)."""

    name = "huber"
    rowwise = True

    def __init__(self, config):
        self.delta = _f32(config.huber_delta)
        self.eta = _f32(config.gaussian_eta)

    def gradients_rowwise(self, score, label, weight):
        diff = score - label
        inside = torch.abs(diff) <= self.delta
        grad_out = torch.where(diff >= 0.0, self.delta, -self.delta).to(torch.float32)
        grad_in, hess_in = diff, torch.ones_like(score)
        if weight is not None:
            grad_out = grad_out * weight
            grad_in, hess_in = grad_in * weight, hess_in * weight
        hess_out = _gaussian_hessian(score, label, grad_out, self.eta, weight)
        return torch.where(inside, grad_in, grad_out), torch.where(inside, hess_in, hess_out)

    def kernel_params(self):
        return (KIND_HUBER, self.eta, self.delta, 0.0)

    @property
    def boost_from_average(self) -> bool:
        return True


class RegressionFairLoss(ObjectiveFunction):
    """grad = c*x/(|x|+c), hess = c^2/(|x|+c)^2
    (regression_objective.hpp:254-272); c*c is taken in double and
    rounded once, as the JAX expression ``self.c * self.c / (...)``
    forms it."""

    name = "fair"
    rowwise = True

    def __init__(self, config):
        self.c = _f32(config.fair_c)
        self.c2 = _f32(float(config.fair_c) * float(config.fair_c))

    def gradients_rowwise(self, score, label, weight):
        x = score - label
        ax_c = torch.abs(x) + self.c
        # a tensor over ax_c^2: ``float / tensor`` multiplies by the
        # reciprocal, one more rounding
        c2 = torch.full_like(ax_c, self.c2)
        return _weighted(self.c * x / ax_c, c2 / (ax_c * ax_c), weight)

    def kernel_params(self):
        return (KIND_FAIR, self.c, self.c2, 0.0)

    @property
    def boost_from_average(self) -> bool:
        return True


class RegressionPoissonLoss(ObjectiveFunction):
    """grad = score - label, hess = score + poisson_max_delta_step — the
    reference's raw-score-space Poisson (regression_objective.hpp:319-337);
    the hessian can be negative, as there."""

    name = "poisson"
    rowwise = True

    def __init__(self, config):
        self.max_delta_step = _f32(config.poisson_max_delta_step)

    def gradients_rowwise(self, score, label, weight):
        return _weighted(score - label, score + self.max_delta_step, weight)

    def kernel_params(self):
        return (KIND_POISSON, self.max_delta_step, 0.0, 0.0)

    @property
    def boost_from_average(self) -> bool:
        return True
