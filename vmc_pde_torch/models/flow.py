"""The invertible-flow density model, the counterpart of
vmc_pde_tpu/models/flow.py: a stack of coupling blocks over a learnable
latent base distribution,

    log p(x) = log p_latent(f(x) - offset) + log|det df/dx|,

with f the block stack (real -> latent). Sampling pushes latent draws
through the inverse stack and returns (x, log p(x)) by change of variables.

``Flow`` is a frozen dataclass of python constants; the parameters are a
flat tensor cut into views by ``Flow.layout`` (models/state.py). Every
function takes batches of shape (..., dim).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..utils.dtypes import device_constant
from . import coupling, latent
from .state import Layout


@dataclasses.dataclass(frozen=True)
class Flow:
    """Static (hashable) flow description."""

    dim: int
    blocks: Tuple[coupling.BlockSpec, ...]
    latent_name: str = "Gauss"
    offset: Tuple[float, ...] = None
    # randomized-QMC exact-latent draws (sampling/qmc.py) in every
    # latent_sample and latent_sample_tempered call
    qmc: bool = False

    def __post_init__(self):
        if self.offset is None:
            object.__setattr__(self, "offset", (0.0,) * self.dim)
        if len(self.offset) != self.dim:
            raise ValueError("offset length != dim")
        latent.check_name(self.latent_name)

    @functools.cached_property
    def layout(self) -> Layout:
        return Layout({
            "latent": latent.shapes(self.dim, self.latent_name),
            "blocks": [coupling.shapes(spec) for spec in self.blocks],
        })

    def init(self, rng: np.random.Generator):
        """Initial numpy parameter dict (the JAX package's pytree)."""
        return {
            "latent": latent.init_params(self.dim, self.latent_name),
            "blocks": [coupling.init(rng, spec) for spec in self.blocks],
        }

    def _offset(self, like):
        return device_constant(tuple(float(o) for o in self.offset),
                               like.device, like.dtype)

    # -- coordinate transform ------------------------------------------
    def forward(self, params, x):
        """Real -> latent. x: (..., dim) -> (z, log|det J|)."""
        log_jac = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for p, spec in zip(params["blocks"], self.blocks):
            x, lj = coupling.forward(p, spec, x)
            log_jac = log_jac + lj
        return x, log_jac

    def inverse(self, params, z):
        """Latent -> real, blocks in reverse order."""
        log_jac = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for p, spec in zip(params["blocks"][::-1], self.blocks[::-1]):
            z, lj = coupling.inverse(p, spec, z)
            log_jac = log_jac + lj
        return z, log_jac

    # -- density ---------------------------------------------------------
    def log_prob(self, params, x):
        z, log_jac = self.forward(params, x)
        lp = latent.log_prob(self.latent_name, params["latent"], self.dim,
                             z - self._offset(x))
        return lp + log_jac

    def push(self, params, z):
        """Latent sample (offset included) -> (x, log p(x))."""
        lp_latent = latent.log_prob(self.latent_name, params["latent"],
                                    self.dim, z - self._offset(z))
        x, log_jac_inv = self.inverse(params, z)
        return x, lp_latent - log_jac_inv

    def latent_sample(self, gen: torch.Generator, params, n: int,
                      dtype: torch.dtype):
        """n latent draws with the offset applied, shape (n, dim)."""
        z = latent.sample(self.latent_name, gen, params["latent"], self.dim,
                          n, dtype, qmc=self.qmc)
        return z + self._offset(z)

    def latent_sample_tempered(self, gen: torch.Generator, params, n: int,
                               gamma: float, dtype: torch.dtype):
        """(z, log_w) from the tail-tempered Student-t importance proposal
        (latent.student_t_tempered_sample); the offset shifts target and
        proposal alike, so the weights do not change."""
        if self.latent_name != "Student_t":
            raise ValueError("tempered sampling is a Student_t feature")
        z, log_w = latent.student_t_tempered_sample(
            gen, params["latent"], self.dim, n, gamma, dtype, qmc=self.qmc)
        return z + self._offset(z), log_w


def perturb_theta(flow: Flow, theta: torch.Tensor, rng: np.random.Generator,
                  out_scale: float = 0.3, other: float = 0.05):
    """theta away from the near-identity initialization, for checks that
    must exercise the nonlinear parts of the flow: every conditioner's
    output-layer weights drawn U[-out_scale, out_scale] (instead of the
    init's 1e-5 scale), every other parameter shifted by U[-other, other]."""
    out = np.asarray(theta.detach().cpu(), dtype=np.float64).copy()
    for path, shape, off, size in flow.layout.leaves:
        is_out = (path[0] == "blocks" and path[-2] == "w"
                  and path[-1] == len(flow.blocks[path[1]].hidden))
        if is_out:
            out[off:off + size] = rng.uniform(-out_scale, out_scale, size)
        else:
            out[off:off + size] += rng.uniform(-other, other, size)
    return torch.as_tensor(out, dtype=theta.dtype, device=theta.device)


def random_partitions(rng: np.random.Generator, dim: int, depth: int):
    """Random half/half coordinate partition per block."""
    ups, downs = [], []
    for _ in range(depth):
        up = rng.choice(dim, size=dim // 2, replace=False)
        down = np.setdiff1d(np.arange(dim), up)
        ups.append(tuple(int(i) for i in up))
        downs.append(tuple(int(i) for i in down))
    return ups, downs


def build_flow(
    seed: int,
    dim: int,
    depth: int = 4,
    hidden: Tuple[int, ...] = None,
    variant: str = "scale",
    global_affine: bool = False,
    latent_name: str = "Gauss",
    offset=None,
    alpha: float = 10.0,
    out_scale: float = 1e-5,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    qmc: bool = False,
):
    """(Flow, theta) the way the JAX package's build_flow constructs them.
    Partitions and initial weights come from a numpy generator seeded by
    ``seed``: they match the JAX package in distribution, not in value."""
    hidden = tuple(hidden) if hidden is not None else (max(dim // 2, 1),)
    rng = np.random.default_rng(seed)
    ups, downs = random_partitions(rng, dim, depth)
    blocks = tuple(
        coupling.BlockSpec(ind_up=u, ind_down=d, hidden=hidden,
                           variant=variant, global_affine=global_affine,
                           alpha=alpha, out_scale=out_scale)
        for u, d in zip(ups, downs)
    )
    offset = tuple(float(o) for o in
                   (offset if offset is not None else np.zeros(dim)))
    flow = Flow(dim=dim, blocks=blocks, latent_name=latent_name,
                offset=offset, qmc=qmc)
    theta = torch.as_tensor(flow.layout.ravel(flow.init(rng)), dtype=dtype,
                            device=device)
    return flow, theta
