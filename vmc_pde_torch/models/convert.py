"""Weights carried across from the JAX package.

``from_jax`` rebuilds a flow of the JAX package in the port: the block
partitions and hyperparameters come over as plain tuples, the parameter
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``). The flat
vector it returns equals ``jax.flatten_util.ravel_pytree(params)[0]``, so
the two packages evaluate the same density with the same theta. Plain
Python and numpy: this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from . import coupling
from .flow import Flow


def from_jax(blocks: Iterable[Tuple], params_np,
             offset: Optional[Tuple[float, ...]] = None,
             dtype: torch.dtype = torch.float64, device="cpu",
             latent_name: str = "Gauss"):
    """(Flow, theta) from the JAX package's per-block
    ``(ind_up, ind_down, variant, hidden, alpha)``, its parameter pytree
    with numpy leaves and its latent family. A block whose parameters hold
    ``g_scale`` carries the learned global affine (``g_scale``,
    ``g_offset``); a Student-t latent carries its raw degrees of freedom in
    ``dist_params`` (empty for the other latents)."""
    specs = tuple(
        coupling.BlockSpec(ind_up=tuple(int(i) for i in up),
                           ind_down=tuple(int(i) for i in down),
                           hidden=tuple(int(h) for h in hidden),
                           variant=variant, alpha=float(alpha),
                           global_affine="g_scale" in p)
        for (up, down, variant, hidden, alpha), p in zip(
            blocks, params_np["blocks"])
    )
    dim = specs[0].dim
    flow = Flow(dim=dim, blocks=specs, latent_name=latent_name,
                offset=None if offset is None
                else tuple(float(o) for o in offset))
    theta = torch.as_tensor(flow.layout.ravel(params_np), dtype=dtype,
                            device=device)
    return flow, theta
