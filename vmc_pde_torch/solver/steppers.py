"""Time integrator for the TDVP parameter flow, the counterpart of the
fixed-step part of vmc_pde_tpu/solver/steppers.py: Heun with the
reference's geometric dt ramp dt <- min(dt * increase_fac, maxStep).
Integration arithmetic happens on the master-precision (f64) flat
parameters. Euler, SSPRK3 and the adaptive steppers are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class StepResult:
    y: torch.Tensor
    dt_used: float
    info: dict


class FixedStepper:
    """Heun with a geometric dt ramp.

    ``pair_fn`` (optional, e.g. ``TDVP.heun_pair``) evaluates the whole
    Heun pair in one call -- (dy, info) = pair_fn(y, t, dt, key) -- instead
    of two f() calls. Observables come from the FIRST stage, the state at
    time t."""

    def __init__(self, timeStep=1e-3, maxStep=1e-2, increase_fac=1.3,
                 pair_fn=None):
        self.dt = float(timeStep)
        self.maxStep = float(maxStep)
        self.increase_fac = float(increase_fac)
        self.pair_fn = pair_fn

    def step(self, t, f, y, key):
        self.dt = dt = min(self.dt * self.increase_fac, self.maxStep)
        if self.pair_fn is not None:
            dy, info = self.pair_fn(y, t, dt, key)
            return StepResult(y + dy, dt, info)
        k0, info = f(y, t, key, intStep=0)
        k1, info1 = f(y + dt * k0, t + dt, key, intStep=1)
        info = dict(info)
        info["nan"] = info["nan"] | info1["nan"]
        return StepResult(y + 0.5 * dt * (k0 + k1), dt, info)
