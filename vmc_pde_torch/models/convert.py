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
    with numpy leaves and its latent family (the ported ones: Gauss,
    cos_dist, double_well; the last two have empty ``dist_params``)."""
    specs = tuple(
        coupling.BlockSpec(ind_up=tuple(int(i) for i in up),
                           ind_down=tuple(int(i) for i in down),
                           hidden=tuple(int(h) for h in hidden),
                           variant=variant, alpha=float(alpha))
        for up, down, variant, hidden, alpha in blocks
    )
    dim = specs[0].dim
    flow = Flow(dim=dim, blocks=specs, latent_name=latent_name,
                offset=None if offset is None
                else tuple(float(o) for o in offset))
    theta = torch.as_tensor(flow.layout.ravel(params_np), dtype=dtype,
                            device=device)
    return flow, theta
