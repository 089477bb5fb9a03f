"""Conditioner MLP for coupling layers (counterpart of
vmc_pde_tpu/models/mlp.py): tanh hidden layers and a bounded
``alpha * tanh`` output head. Hidden kernels start U[-1, 1], the output
kernel U[-out_scale, out_scale] -- the near-identity initialization the
TDVP dynamics' stability depends on.

Parameters are a dict {'w': [W0, W1, ...], 'b': [b0, b1, ...]} with W of
shape (in, out), the JAX package's layout, so flat parameter vectors carry
over unchanged (models/state.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def init(rng: np.random.Generator, in_dim: int, hidden: Sequence[int],
         out_dim: int, out_scale: float = 1e-5):
    """Numpy parameters {'w': [...], 'b': [...]}, len(hidden) + 1 layers."""
    dims = [in_dim, *hidden, out_dim]
    n_layers = len(dims) - 1
    ws, bs = [], []
    for i in range(n_layers):
        scale = out_scale if i == n_layers - 1 else 1.0
        ws.append(rng.uniform(-scale, scale, size=(dims[i], dims[i + 1])))
        bs.append(np.zeros((dims[i + 1],)))
    return {"w": ws, "b": bs}


def shapes(in_dim: int, hidden: Sequence[int], out_dim: int):
    """Leaf shapes of ``init``'s output, for the flat parameter layout."""
    dims = [in_dim, *hidden, out_dim]
    return {"w": [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
            "b": [(dims[i + 1],) for i in range(len(dims) - 1)]}


def apply(params, x, alpha: float = 10.0):
    """x: (..., in_dim) -> (..., out_dim); bounded output alpha*tanh(.)"""
    ws, bs = params["w"], params["b"]
    for w, b in zip(ws[:-1], bs[:-1]):
        x = (x @ w + b).tanh()
    return alpha * (x @ ws[-1] + bs[-1]).tanh()
