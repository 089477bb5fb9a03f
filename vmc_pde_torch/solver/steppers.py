"""Time integrators for the TDVP parameter flow, the counterpart of
vmc_pde_tpu/solver/steppers.py:

- ``FixedStepper``: Heun, Euler or Shu-Osher SSPRK3 ("RK3") with the
  reference's geometric dt ramp dt <- min(dt * increase_fac, maxStep);
- ``AdaptiveHeun``: the reference's embedded Heun (a full step against two
  half steps), error in the S metric, dt scale clamp
  [0.2, 2] * 0.9 * fe^(1/3) with fe = tol / err, maxStep cap;
- ``AdaptiveRK23``: the embedded Bogacki-Shampine 3(2) pair under the
  same controller, 4 RHS per attempt instead of 5.

Integration arithmetic happens on the master-precision (f64) flat
parameters. The right-hand side ``f`` is ``TDVP.rhs``-like:
f(theta, t, key, intStep) -> (dtheta, aux). Observables come from the
first stage of a step (of the accepted attempt), the state at time t; the
NaN flag is OR-ed over every stage; stage keys are intStep = 5 * attempt
+ stage, for RK23 too. ``dt_cap`` (the driver's exact_t_end landing)
clamps one step only: the steppers keep the uncapped dt.

Each adaptive attempt reads its error on the host (``float(err)``): one
device synchronization per attempt, which decides accept or retry. The
batched steps (TDVP.adaptive_multi) keep that loop and the controller on
the device instead.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class StepResult:
    y: torch.Tensor
    dt_used: float
    info: dict


def _fold_nan(info, others):
    """``info`` with the NaN flags of ``others`` OR-ed into its own."""
    if "nan" not in info:
        return info
    info = dict(info)
    for other in others:
        if "nan" in other:
            info["nan"] = info["nan"] | other["nan"]
    return info


class FixedStepper:
    """Heun, Euler or SSPRK3 with a geometric dt ramp.

    ``pair_fn`` (optional; ``TDVP.heun_pair`` for Heun, ``TDVP.rk3_triple``
    for RK3) evaluates the whole step in one call -- (dy, info) =
    pair_fn(y, t, dt, key) -- instead of one f() call per stage."""

    def __init__(self, timeStep=1e-3, maxStep=1e-2, increase_fac=1.3,
                 mode="Heun", pair_fn=None):
        self.dt = float(timeStep)
        self.maxStep = float(maxStep)
        self.increase_fac = float(increase_fac)
        if mode not in ("Heun", "Euler", "RK3"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.pair_fn = pair_fn

    def step(self, t, f, y, key, normFunction=None, dt_cap=None):
        self.dt = min(self.dt * self.increase_fac, self.maxStep)
        dt = self.dt if dt_cap is None else min(self.dt, float(dt_cap))
        if self.mode != "Euler" and self.pair_fn is not None:
            dy, info = self.pair_fn(y, t, dt, key)
            return StepResult(y + dy, dt, info)
        k0, info = f(y, t, key, intStep=0)
        if self.mode == "Euler":
            return StepResult(y + dt * k0, dt, info)
        k1, i1 = f(y + dt * k0, t + dt, key, intStep=1)
        if self.mode == "Heun":
            return StepResult(y + 0.5 * dt * (k0 + k1), dt,
                              _fold_nan(info, (i1,)))
        k2, i2 = f(y + 0.25 * dt * (k0 + k1), t + 0.5 * dt, key, intStep=2)
        return StepResult(y + dt / 6.0 * (k0 + k1 + 4.0 * k2), dt,
                          _fold_nan(info, (i1, i2)))


class AdaptiveHeun:
    """Embedded adaptive Heun. The error is ||dy1 - dy0|| in the
    ``normFunction`` metric, normFunction(v, f.SExp) (the driver's: the
    dense S metric, else the matrix-free one, else the 2-norm).

    ``attempt_fn`` (optional, ``TDVP.heun_attempt``) evaluates a whole
    attempt with its error: (dy, err, info) = attempt_fn(y, t, dt, key,
    attempt). The recorded info is the accepted attempt's, with the
    Metropolis counts summed over every attempt and ``attempts`` and
    ``step_error`` (the accepted attempt's error) added."""

    def __init__(self, timeStep=1e-3, tol=1e-8, maxStep=1.0,
                 attempt_fn=None):
        self.dt = float(timeStep)
        self.tolerance = float(tol)
        self.maxStep = float(maxStep)
        self.attempt_fn = attempt_fn

    def _attempt_plain(self, f, y0, t, dt, key, off):
        """One attempt through per-stage f() calls: the full Heun step
        against two half steps. Returns (dy1, dy1 - dy0, stage-0 info with
        every stage's NaN flag)."""
        k0, info = f(y0, t, key, intStep=off + 0)
        k1, i1 = f(y0 + dt * k0, t + dt, key, intStep=off + 1)
        dy0 = 0.5 * dt * (k0 + k1)
        k10, i2 = f(y0 + 0.5 * dt * k0, t + 0.5 * dt, key,
                    intStep=off + 2)
        dy1 = 0.25 * dt * (k0 + k10)
        y2 = y0 + dy1
        k01, i3 = f(y2, t + 0.5 * dt, key, intStep=off + 3)
        y3 = y2 + 0.5 * dt * k01
        k11, i4 = f(y3, t + dt, key, intStep=off + 4)
        dy1 = dy1 + 0.25 * dt * (k01 + k11)
        return dy1, dy1 - dy0, _fold_nan(info, (i1, i2, i3, i4))

    def step(self, t, f, y, key, normFunction=None, dt_cap=None,
             first_attempt=0, counts=None):
        """One step. ``first_attempt``, ``counts``: go on with a step
        whose first attempts ran elsewhere (TDVP.adaptive_multi's host
        finish): the attempt index to start from and their summed
        Metropolis counts (accepted, proposed)."""
        if normFunction is None:
            normFunction = lambda v, S: torch.linalg.norm(v)  # noqa: E731

        fe = 0.5
        dt = self.dt if dt_cap is None else min(self.dt, float(dt_cap))
        attempt = first_attempt
        while fe < 1.0:
            if self.attempt_fn is not None:
                dy, err, info = self.attempt_fn(y, t, dt, key,
                                                attempt=attempt)
            else:
                dy, diff, info = self._attempt_plain(f, y, t, dt, key,
                                                     5 * attempt)
                err = normFunction(diff, getattr(f, "SExp", None))
            err = float(err)  # the attempt's one host synchronization
            if "mcmc_accepted" in info:
                part = (info["mcmc_accepted"], info["mcmc_proposed"])
                counts = part if counts is None else (
                    counts[0] + part[0], counts[1] + part[1])

            # err == 0 (a fully regularized or stationary update) accepts
            # the step and grows dt, as the reference's inf does
            fe = self.tolerance / err if err > 0.0 else float("inf")
            scale = max(0.2, min(2.0, 0.9 * fe ** (1.0 / 3.0)))
            real_dt = dt
            dt_free = min(dt * scale, self.maxStep)
            dt = dt_free if dt_cap is None else min(dt_free, float(dt_cap))
            attempt += 1

        # persist the uncapped suggestion: dt_cap clamps this step only
        self.dt = dt_free
        info = dict(info, attempts=attempt, step_error=err)
        if counts is not None:
            info["mcmc_accepted"], info["mcmc_proposed"] = counts
        return StepResult(y + dy, real_dt, info)


class AdaptiveRK23(AdaptiveHeun):
    """Embedded Bogacki-Shampine 3(2): 4 RHS per attempt, the third-order
    solution accepted, the second-order one for the error. Same
    controller and conventions as AdaptiveHeun; ``attempt_fn`` =
    ``TDVP.rk23_attempt``."""

    def _attempt_plain(self, f, y0, t, dt, key, off):
        k0, info = f(y0, t, key, intStep=off + 0)
        k1, i1 = f(y0 + 0.5 * dt * k0, t + 0.5 * dt, key, intStep=off + 1)
        k2, i2 = f(y0 + 0.75 * dt * k1, t + 0.75 * dt, key,
                   intStep=off + 2)
        dy3 = dt * (2.0 / 9.0 * k0 + 1.0 / 3.0 * k1 + 4.0 / 9.0 * k2)
        k3, i3 = f(y0 + dy3, t + dt, key, intStep=off + 3)
        dy2 = dt * (7.0 / 24.0 * k0 + 0.25 * k1 + 1.0 / 3.0 * k2
                    + 0.125 * k3)
        return dy3, dy3 - dy2, _fold_nan(info, (i1, i2, i3))
