"""Loss functions, their conjugates, and exact 1-D coordinate solvers.

PyTorch counterpart of ``repro/core/duals.py``; conventions follow the
paper exactly:

    primal (1):  P(w) = ½‖w‖² + Σ_i ℓ_i(wᵀx_i),   x_i = y_i · ẋ_i
    dual   (2):  D(α) = ½‖Σ_i α_i x_i‖² + Σ_i ℓ*_i(−α_i)

Each loss provides the *exact* minimizer of the one-variable subproblem

    Δα_i = argmin_δ ½‖w + δ x_i‖² + ℓ*_i(−(α_i + δ))

given ``wx = wᵀx_i`` and ``q = ‖x_i‖²``.  Every method takes float32
tensors of any shape (0-d included) and works elementwise, so the same
code is the per-update δ of the plain engines and the vectorized δ of
the tests.  The CUDA kernels compute the same δ in
``kernels/csrc/dcd_delta.cuh``; ``kernel_params`` hands them the
constants in the float32 rounding this module uses.

Losses are frozen dataclasses: hashable, comparable, safe as cache keys.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-12

# loss ids shared with kernels/csrc/dcd_delta.cuh
HINGE, SQUARED_HINGE, LOGISTIC = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Hinge:
    """SVM hinge loss ℓ(z) = C·max(1−z, 0); dual box α ∈ [0, C] (eq. 10)."""

    C: float = 1.0
    kind = HINGE

    def primal_loss(self, z):
        return self.C * torch.clamp(1.0 - z, min=0.0)

    def conj(self, alpha):
        """ℓ*(−α) on the feasible box (= −α)."""
        return -alpha

    def feasible(self, alpha):
        return torch.clamp(alpha, 0.0, self.C)

    def delta(self, alpha, wx, q):
        """Closed form: project α + (1 − wᵀx)/‖x‖² onto [0, C]."""
        q = torch.clamp(q, min=_EPS)
        new = torch.clamp(alpha + (1.0 - wx) / q, 0.0, self.C)
        return new - alpha

    def dual_grad(self, alpha, wx):
        """∇_i D(α) = wᵀx_i − 1 (within the box)."""
        return wx - 1.0


@dataclasses.dataclass(frozen=True)
class SquaredHinge:
    """ℓ(z) = C·max(1−z, 0)²; conjugate −α + α²/(4C) for α ≥ 0 (eq. 11)."""

    C: float = 1.0
    kind = SQUARED_HINGE

    def primal_loss(self, z):
        return self.C * torch.clamp(1.0 - z, min=0.0) ** 2

    def conj(self, alpha):
        return -alpha + alpha * alpha / (4.0 * self.C)

    def feasible(self, alpha):
        return torch.clamp(alpha, min=0.0)

    def delta(self, alpha, wx, q):
        q = torch.clamp(q, min=_EPS)
        denom = q + 1.0 / (2.0 * self.C)
        new = torch.clamp(
            alpha + (1.0 - wx - alpha / (2.0 * self.C)) / denom, min=0.0)
        return new - alpha

    def dual_grad(self, alpha, wx):
        return wx - 1.0 + alpha / (2.0 * self.C)


@dataclasses.dataclass(frozen=True)
class Logistic:
    """ℓ(z) = C·log(1+e^{−z}); ℓ*(−α) = α·log α + (C−α)·log(C−α) − C·log C
    for α ∈ (0, C).  The subproblem has no closed form: a safeguarded
    Newton iteration (Yu, Huang & Lin, 2011)."""

    C: float = 1.0
    newton_steps: int = 20
    kind = LOGISTIC

    def primal_loss(self, z):
        # log(1+e^{-z}) computed stably, as jnp.logaddexp(0, -z)
        return self.C * torch.logaddexp(torch.zeros_like(z), -z)

    def conj(self, alpha):
        """Entropy terms via the exact x·log x → 0 boundary limit
        (``xlogy``): iterates can sit at exactly 0 or C in float32."""
        a = torch.clamp(alpha, 0.0, self.C)
        return (torch.special.xlogy(a, a)
                + torch.special.xlogy(self.C - a, self.C - a)
                - self.C * torch.log(torch.tensor(self.C, dtype=a.dtype,
                                                  device=a.device)))

    def feasible(self, alpha):
        return torch.clamp(alpha, 1e-8 * self.C, (1.0 - 1e-8) * self.C)

    def delta(self, alpha, wx, q):
        """Safeguarded Newton on g'(δ) = wx + δ·q + log((α+δ)/(C−α−δ)),
        g'' = q + C/((α+δ)(C−α−δ)), over δ ∈ (−α, C−α)."""
        C = self.C
        q = torch.clamp(q, min=_EPS)
        lo = -alpha + _EPS * C
        hi = (C - alpha) - _EPS * C
        delta = torch.zeros_like(alpha)
        for _ in range(self.newton_steps):
            a = alpha + delta
            g1 = wx + delta * q + torch.log(a) - torch.log(C - a)
            g2 = q + C / torch.clamp(a * (C - a), min=_EPS)
            delta = torch.clamp(delta - g1 / g2, lo, hi)
        return delta

    def dual_grad(self, alpha, wx):
        a = torch.clamp(alpha, _EPS, self.C - _EPS)
        return wx + torch.log(a) - torch.log(self.C - a)


LOSSES = {"hinge": Hinge, "squared_hinge": SquaredHinge, "logistic": Logistic}


def make_loss(name: str, C: float = 1.0):
    return LOSSES[name](C=C)


def kernel_params(loss):
    """(kind, C, 1/(2C), ε·C, newton_steps) as the CUDA δ takes them.

    The two derived constants are formed in double and rounded once to
    float32 by the launch, which is how the plain version (and the JAX
    reference) round a Python-float constant into a float32 expression."""
    C = float(loss.C)
    return (int(loss.kind), C, 1.0 / (2.0 * C), _EPS * C,
            int(getattr(loss, "newton_steps", 0)))
