"""SanityFlow: a one-parameter invertible 'network' with the same interface
as Flow, for isolating the TDVP/sampler stack from model complexity; the
counterpart of vmc_pde_tpu/models/sanity.py.

Parity with the reference's SanityINN test double (vmc_fluids/net.py:220-235,
swappable at var_state.py:120-122): forward multiplies by a learnable scale
with log|J| = dim * log(scale); here extended with the latent machinery so it
is a drop-in Flow replacement (log_prob/push/latent_sample all work).

Its parameters are {"latent", "scale"}, flattened in that (sorted) order
as ``jax.flatten_util.ravel_pytree`` orders the JAX package's, so a theta
carried across by models/convert.from_jax means the same density. It has
no coupling blocks, so the per-sample kernel does not serve it
(kernels/persample.supports) and the TDVP takes the torch.func pipeline.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import latent
from .flow import Flow
from .state import Layout


@dataclasses.dataclass(frozen=True)
class SanityFlow(Flow):
    """dim-dimensional pure-scaling flow: z = s * x."""

    def __init__(self, dim: int, latent_name: str = "Gauss", offset=None):
        object.__setattr__(self, "dim", dim)
        object.__setattr__(self, "blocks", ())
        object.__setattr__(self, "latent_name", latent_name)
        object.__setattr__(
            self, "offset",
            tuple(float(o) for o in offset) if offset is not None
            else (0.0,) * dim)
        object.__setattr__(self, "qmc", False)
        self.__post_init__()

    @functools.cached_property
    def layout(self) -> Layout:
        return Layout({"latent": latent.shapes(self.dim, self.latent_name),
                       "scale": (1,)})

    def init(self, rng: np.random.Generator = None):
        """Initial numpy parameter dict: the latent's init and scale 1
        (nothing is random; ``rng`` is accepted for Flow's signature)."""
        return {"latent": latent.init_params(self.dim, self.latent_name),
                "scale": np.ones((1,))}

    def forward(self, params, x):
        s = params["scale"][0]
        return s * x, (self.dim * torch.log(s)).expand(x.shape[:-1])

    def inverse(self, params, z):
        s = params["scale"][0]
        return z / s, (-self.dim * torch.log(s)).expand(z.shape[:-1])
