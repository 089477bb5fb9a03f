"""Sample statistics, the counterpart of vmc_pde_tpu/parallel/stats.py.

Single device for now: every statistic is a plain torch reduction over the
leading sample axis, and the Gram is one ``torch.matmul``. On the card that
matmul runs in full f32 because utils/dtypes.full_f32_matmuls turns TF32
off; this is what the JAX package's ``gram_backend="auto"`` resolves to off
the TPU. The bf16 hi/lo split backends (sym2, tri2) and the int8 cross
term, which emulate f32 on the TPU's bf16 matrix unit, are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import torch


def mean(data, axis: int = 0):
    """E[X] over the sample axis (where a multi-device port will reduce
    across ranks)."""
    return data.mean(dim=axis)


def second_moment_matrix(data, w=None):
    """E[w_i X_i^T X_i] for data of shape (N, P), with optional per-sample
    weights w (N,): the Gram contraction of the TDVP step."""
    n = data.shape[0]
    rhs = data if w is None else data * w[:, None]
    return torch.matmul(data.T, rhs) / n
