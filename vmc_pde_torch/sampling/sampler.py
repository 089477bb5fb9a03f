"""Latent-space sampler, the counterpart of vmc_pde_tpu/sampling/sampler.py
for the exact Gauss latent: draws z = mu + U eps + offset from the flow's
own latent distribution (no Markov chain). The Metropolis path and the
Student-t latent are not ported yet (ROADMAP.md).

Random numbers come from an explicit ``torch.Generator``. They differ from
JAX's threefry streams for the same seed, so tests that compare the two
packages hand both the same latent draws.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import latent as latent_mod


@dataclasses.dataclass
class Sampler:
    dim: int
    name: str = "Gauss"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        latent_mod.check_ported(self.name)
        self.exact = self.name in latent_mod.EXACT_NAMES

    def rounded_budget(self, n: int) -> int:
        """Sample budget as drawn: exact sampling takes any n."""
        return int(n)

    def sample(self, gen: torch.Generator, flow, params, n: int):
        """(z (n, dim), n) latent draws, offset applied."""
        n = self.rounded_budget(n)
        return flow.latent_sample(gen, params, n, self.dtype), n
