"""Per-sample derivatives of the flow's log-density, the counterpart of
vmc_pde_tpu/ops/score.py: value, coordinate score g = grad_x log p,
parameter score (the TDVP O row, grad_theta log p for the FLAT theta), the
Hessian quadratic trace and the Hessian block. Written with
``torch.func``: each function handles one sample and the caller vmaps it
over the batch. This is the plain per-sample pipeline; kernels/persample.py
holds the hand-written CUDA kernel that computes the quantities of the
trace mode.
"""

from __future__ import annotations

import torch
from torch.func import grad, grad_and_value, jacfwd, jvp, vmap

from ..utils.dtypes import device_constant


def make_flat_log_prob(flow, unravel):
    """log p as a function of the FLAT parameter vector (one sample)."""

    def log_prob_flat(theta, x):
        return flow.log_prob(unravel(theta), x)

    return log_prob_flat


def value_score_and_param_grad(log_prob_flat, theta, x):
    """(logp, grad_x logp, grad_theta logp) for one sample, one backward
    pass."""
    (g_theta, g_x), logp = grad_and_value(log_prob_flat, argnums=(0, 1))(
        theta, x)
    return logp, g_x, g_theta


def hessian_block(log_prob_flat, theta, x, idx):
    """Hessian of logp in the coordinates ``idx`` (a tuple; None means all
    of them) for one sample, shape (k, k), forward-over-reverse: jacfwd
    of the coordinate gradient."""
    grad_x = grad(log_prob_flat, argnums=1)
    if idx is None:
        hess = jacfwd(grad_x, argnums=1)(theta, x)
    else:
        # x moves along the selected coordinates only: x + E e at e = 0,
        # E the (d, k) one-hot selection
        ind = device_constant(tuple(idx), x.device)
        E = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)[:, ind]

        def grad_sub(e):
            return grad_x(theta, x + E @ e)[ind]

        hess = jacfwd(grad_sub)(x.new_zeros(len(idx)))
    # the forward-mode promotion hazard of quad_trace
    return hess.to(x.dtype)


def quad_trace(log_prob_flat, theta, x, dirs):
    """sum_j v_j^T H v_j for one sample, H = d^2/dx^2 log p and ``dirs`` a
    (k, d) direction matrix, forward-over-forward:
    v^T H v = d^2/dt^2 log p(x + t v) = jvp(jvp(f, v), v)."""

    def f(xv):
        return log_prob_flat(theta, xv)

    def one(v):
        def inner(y):
            return jvp(f, (y,), (v,))[1]

        return jvp(inner, (x,), (v,))[1]

    # forward-mode AD promotes a 0-dim tangent times a python float to
    # float64; hand back the sample's dtype
    return vmap(one)(dirs).sum().to(x.dtype)


def batched_value_score_and_param_grad(log_prob_flat, theta, x):
    """(logp (N,), g (N, d), O (N, P)) over a batch."""
    return vmap(lambda xs: value_score_and_param_grad(log_prob_flat, theta,
                                                      xs))(x)


def batched_param_jvp(log_prob_flat, theta, x, v):
    """(N,) directional derivatives d/de log p(theta + e v, x_n), that is
    O_n . v, by one forward-mode pass over the batch: the plain version of
    the matrix-free S metric's contraction (solver/tdvp.py _sexp_a)."""

    def batch(th):
        return vmap(lambda xs: log_prob_flat(th, xs))(x)

    # the same promotion hazard as quad_trace: hand back the sample dtype
    return jvp(batch, (theta,), (v.to(theta.dtype),))[1].to(x.dtype)


def batched_quad_trace(log_prob_flat, theta, x, dirs):
    """(N,) Hessian quadratic traces over a batch."""
    dirs = torch.as_tensor(dirs, dtype=x.dtype, device=x.device)
    return vmap(lambda xs: quad_trace(log_prob_flat, theta, xs, dirs))(x)


def batched_hessian_block(log_prob_flat, theta, x, idx):
    """(N, k, k) Hessian blocks over a batch."""
    return vmap(lambda xs: hessian_block(log_prob_flat, theta, xs, idx))(x)
