"""Coupling blocks (RealNVP family) with exact inverses and log-Jacobians,
the counterpart of vmc_pde_tpu/models/coupling.py. All four variants:

- ``additive``:    v = u + s(.)            log|J| = 0
- ``affine``:      v = u * exp(s) + t(.)   log|J| = sum s
- ``scale``:       v = u * exp(s)          log|J| = sum s
- ``scale_shift``: v = u * exp(s) + s      log|J| = sum s

Each block transforms the ind_up half conditioned on the ind_down half,
then the ind_down half conditioned on the new ind_up half. With
``global_affine`` the block ends with a learned affine map of all
coordinates, z = g_scale y + g_offset (one scalar scale, log|J| += dim
log g_scale). Functions take batches of shape (..., dim), so the same code
serves a whole batch and a single sample under ``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.dtypes import device_constant
from . import mlp

VARIANTS = ("additive", "affine", "scale", "scale_shift")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static (hashable) block description; same fields as the JAX
    package's BlockSpec."""

    ind_up: Tuple[int, ...]
    ind_down: Tuple[int, ...]
    hidden: Tuple[int, ...] = (3,)
    variant: str = "scale"
    global_affine: bool = False
    alpha: float = 10.0
    out_scale: float = 1e-5

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown coupling variant {self.variant!r}")
        if set(self.ind_up) & set(self.ind_down):
            raise ValueError("ind_up and ind_down overlap")

    @property
    def dim(self) -> int:
        return len(self.ind_up) + len(self.ind_down)

    @property
    def inverse_perm(self) -> Tuple[int, ...]:
        """concat(v_up, v_down)[..., inverse_perm] puts every value back at
        its coordinate."""
        order = list(self.ind_up) + list(self.ind_down)
        inv = [0] * len(order)
        for pos, coord in enumerate(order):
            inv[coord] = pos
        return tuple(inv)

    @property
    def nets(self) -> Tuple[str, ...]:
        """Conditioner nets of the block, in parameter-dict key order."""
        return (("s1", "s2", "t1", "t2") if self.variant == "affine"
                else ("s1", "s2"))

    def net_dims(self, net: str) -> Tuple[int, int]:
        """(in, out) of a conditioner: s1/t1 read the up half and drive the
        down half, s2/t2 the reverse."""
        n_up, n_down = len(self.ind_up), len(self.ind_down)
        return (n_up, n_down) if net in ("s1", "t1") else (n_down, n_up)


def init(rng: np.random.Generator, spec: BlockSpec):
    """Numpy parameter dict {'s1', 's2'[, 't1', 't2'][, 'g_scale' = 1,
    'g_offset' = 0]}."""
    params = {net: mlp.init(rng, *_io(spec, net), spec.out_scale)
              for net in spec.nets}
    if spec.global_affine:
        params["g_scale"] = np.ones((1,))
        params["g_offset"] = np.zeros((spec.dim,))
    return params


def shapes(spec: BlockSpec):
    out = {net: mlp.shapes(*_io(spec, net)) for net in spec.nets}
    if spec.global_affine:
        out["g_scale"] = (1,)
        out["g_offset"] = (spec.dim,)
    return out


def _io(spec, net):
    n_in, n_out = spec.net_dims(net)
    return n_in, spec.hidden, n_out


def _couple_fwd(u, s, t, variant):
    """One half-update in the forward direction; returns (v, logjac terms)."""
    if variant == "additive":
        return u + s, torch.zeros_like(s)
    if variant == "affine":
        return u * s.exp() + t, s
    if variant == "scale":
        return u * s.exp(), s
    return u * s.exp() + s, s  # scale_shift


def _couple_inv(v, s, t, variant):
    if variant == "additive":
        return v - s, torch.zeros_like(s)
    if variant == "affine":
        return (v - t) * (-s).exp(), s
    if variant == "scale":
        return v * (-s).exp(), s
    return (v - s) * (-s).exp(), s  # scale_shift


def _split(spec, x):
    up = device_constant(spec.ind_up, x.device)
    down = device_constant(spec.ind_down, x.device)
    return x[..., up], x[..., down]


def _merge(spec, a, b):
    perm = device_constant(spec.inverse_perm, a.device)
    return torch.cat([a, b], dim=-1)[..., perm]


def forward(params, spec: BlockSpec, x):
    """Real -> latent half-step. x: (..., dim) -> (y, log|det J| (...))."""
    affine = spec.variant == "affine"
    u1, u2 = _split(spec, x)
    s2 = mlp.apply(params["s2"], u2, spec.alpha)
    t2 = mlp.apply(params["t2"], u2, spec.alpha) if affine else None
    v1, lj1 = _couple_fwd(u1, s2, t2, spec.variant)
    s1 = mlp.apply(params["s1"], v1, spec.alpha)
    t1 = mlp.apply(params["t1"], v1, spec.alpha) if affine else None
    v2, lj2 = _couple_fwd(u2, s1, t1, spec.variant)
    y, log_jac = _merge(spec, v1, v2), lj1.sum(-1) + lj2.sum(-1)
    if spec.global_affine:
        y = params["g_scale"] * y + params["g_offset"]
        log_jac = log_jac + spec.dim * params["g_scale"][0].log()
    return y, log_jac


def inverse(params, spec: BlockSpec, y):
    """Latent -> real half-step; exact inverse of ``forward``. The returned
    log-Jacobian is the negative of the forward one."""
    affine = spec.variant == "affine"
    lj_g = 0.0
    if spec.global_affine:
        y = (y - params["g_offset"]) / params["g_scale"]
        lj_g = spec.dim * params["g_scale"][0].log()
    v1, v2 = _split(spec, y)
    s1 = mlp.apply(params["s1"], v1, spec.alpha)
    t1 = mlp.apply(params["t1"], v1, spec.alpha) if affine else None
    u2, lj2 = _couple_inv(v2, s1, t1, spec.variant)
    s2 = mlp.apply(params["s2"], u2, spec.alpha)
    t2 = mlp.apply(params["t2"], u2, spec.alpha) if affine else None
    u1, lj1 = _couple_inv(v1, s2, t2, spec.variant)
    return _merge(spec, u1, u2), -lj_g - (lj1.sum(-1) + lj2.sum(-1))
