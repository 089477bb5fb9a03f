"""Flat parameter vector and variational state, the counterpart of
vmc_pde_tpu/models/state.py.

The port holds the parameters as ONE flat tensor theta; ``Layout.unravel``
cuts it into the JAX package's nested parameter dict as views, so a
function of the dict is a function of theta that ``torch.func`` can
differentiate. The flat order is ``jax.flatten_util.ravel_pytree``'s:
dict keys sorted, lists in order, each leaf raveled row-major. For a flow
that gives ``blocks`` before ``latent``; within a block the global affine
(g_offset, g_scale) where the block has one, then the nets in key order
(s1, s2, t1, t2); within a net all biases, then all weights; and the
latent as L, L_diag, dist_params (Student-t's one raw degrees of freedom,
empty for the other latents), mu.
The per-sample kernel's O rows follow the same order
(kernels/persample.py), and weights carried across from JAX
(models/convert.py) keep their positions.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import ParallelCtx
from ..utils.dtypes import Precision


def _walk(node, path=()):
    """(path, shape) of every leaf in ravel_pytree order. Containers are
    dicts and lists; a leaf is a shape tuple."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], path + (k,))
    elif isinstance(node, list):
        for i, child in enumerate(node):
            yield from _walk(child, path + (i,))
    else:
        yield path, tuple(node)


class Layout:
    """Positions of every parameter leaf in the flat vector."""

    def __init__(self, shapes):
        self.shapes = shapes
        self.leaves = []  # (path, shape, offset, size)
        off = 0
        for path, shape in _walk(shapes):
            size = math.prod(shape)
            self.leaves.append((path, shape, off, size))
            off += size
        self.size = off
        self._offsets = {path: off for path, _, off, _ in self.leaves}

    def offset(self, path) -> int:
        return self._offsets[tuple(path)]

    def unravel(self, theta):
        """Flat (P,) tensor -> nested parameter dict of views into it."""
        leaves = iter(self.leaves)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if isinstance(node, list):
                return [build(child) for child in node]
            _, shape, off, size = next(leaves)
            return theta[off:off + size].view(shape)

        return build(self.shapes)

    def ravel(self, tree) -> np.ndarray:
        """Nested dict of array-likes -> flat float64 numpy vector."""
        parts = []
        for path, shape, _, _ in self.leaves:
            node = tree
            for k in path:
                node = node[k]
            leaf = np.asarray(node, dtype=np.float64)
            if leaf.shape != shape:
                raise ValueError(f"parameter {path} has shape {leaf.shape}, "
                                 f"the flow expects {shape}")
            parts.append(leaf.reshape(-1))
        return np.concatenate(parts)


class VarState:
    """A flow, its flat parameters and its sampler on one rank's device.

    ``theta`` is the compute-dtype flat vector, the same on every rank;
    ``get_parameters`` returns the master-dtype copy the time integrator
    advances. ``ctx``: the rank's place on the mesh (parallel/mesh.py;
    one device if None)."""

    def __init__(self, flow, theta: torch.Tensor, sampler=None,
                 precision: Optional[Precision] = None,
                 ctx: Optional[ParallelCtx] = None):
        self.flow = flow
        self.layout = flow.layout
        self.precision = precision or Precision.f32_only()
        self.sampler = sampler
        self.dim = flow.dim
        self.device = theta.device
        self.ctx = ctx or ParallelCtx.single_device(theta.device)
        self.numParameters = self.layout.size
        self.set_parameters(theta)

    def get_parameters(self) -> torch.Tensor:
        return self.theta.to(self.precision.master)

    def set_parameters(self, theta_flat: torch.Tensor) -> None:
        self.theta = theta_flat.to(device=self.device,
                                   dtype=self.precision.compute)

    @property
    def params(self):
        return self.layout.unravel(self.theta)

    def log_prob(self, coords):
        coords = torch.as_tensor(coords, dtype=self.precision.compute,
                                 device=self.device)
        return self.flow.log_prob(self.params, coords)

    def sample(self, numSamples: int, key: int):
        """Draw from the model density: latent draws (exact, or Metropolis
        chains carried across calls) pushed through the inverse flow.
        Returns this rank's shard (x (n, d), logp (n,)), n the sampler's
        rounded budget over the world (Sampler.sample)."""
        if self.sampler is None:
            raise ValueError("VarState has no sampler")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key)
        params = self.params
        z, _ = self.sampler.sample(gen, self.flow, params, numSamples)
        return self.flow.push(params, z.to(self.precision.compute))

    def integrate(self, grid) -> torch.Tensor:
        """Riemann-sum normalization check on a dense grid."""
        return (self.log_prob(grid.coords).exp() * grid.bin_area).sum()
