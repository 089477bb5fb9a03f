"""Supervised pre-training of the flow by maximum likelihood on data
samples, the counterpart of vmc_pde_tpu/pretrain/train.py: synthetic
datasets with an analytic target density, and Adam on -E[log p].

The port keeps the parameters as one flat theta (models/state.py), so
Adam runs on that vector; Adam is elementwise, so it is the JAX package's
optax.adam over the parameter pytree. The checkpoint is one npz,
``<workdir>/pretrain_ckpt.npz`` (theta, Adam's moments and step count,
the epoch), which the driver's ``--init-params`` reads.

    python -m vmc_pde_torch.pretrain.train --dim 2 --epochs 50 \\
        --workdir pre --checkpoint-every 10
    python -m vmc_pde_torch.driver mwe --init-params pre/pretrain_ckpt.npz
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils.checkpoint import _atomic_savez
from ..utils.threefry import normal_f64

CKPT_NAME = "pretrain_ckpt.npz"
# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def gen_data(size, mode: str = "standard_normal", key: int = 0,
             std: float = 1.0, dtype=torch.float64, device="cpu"):
    """(data, target_fun) of a synthetic dataset of ``size`` = (N, dim):
    standard normal draws, or ("normal_superpos") the same with +4 added
    to every even row and -4 to every odd one, a mixture of two Gaussians.
    The draws are jax.random.normal(PRNGKey(key), size) in f64, bit for
    bit (utils/threefry.py), scaled by std and cast to ``dtype``.
    ``target_fun`` maps (M, dim) tensors to the analytic density."""
    dim = size[-1]
    data = std * normal_f64(key, tuple(size))
    norm = 1.0 / math.sqrt(2 * math.pi * std**2) ** dim
    if mode == "standard_normal":
        def target_fun(x):
            return norm * torch.exp(-0.5 * (x**2).sum(-1) / std**2)
    elif mode == "normal_superpos":
        shift = 4.0
        data[::2] += shift
        data[1::2] -= shift

        def target_fun(x):
            return 0.5 * norm * (
                torch.exp(-0.5 * ((x - shift) ** 2).sum(-1) / std**2)
                + torch.exp(-0.5 * ((x + shift) ** 2).sum(-1) / std**2))
    else:
        raise ValueError(f"unknown data mode {mode!r}")
    return torch.as_tensor(data, dtype=dtype, device=device), target_fun


def _adam(theta, grad, mu, nu, count: int, lr: float):
    """One optax.adam step on flat tensors (its operation order), in
    place; ``count`` is the step's 1-based number."""
    mu.mul_(_B1).add_((1 - _B1) * grad)
    nu.mul_(_B2).add_((1 - _B2) * (grad * grad))
    mu_hat = mu / (1 - _B1**count)
    nu_hat = nu / (1 - _B2**count)
    theta.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + _EPS)))


def _shuffle(n: int, key: int, epoch: int, device) -> torch.Tensor:
    """The permutation of epoch ``epoch``: keyed by (key, epoch) alone, so
    a resumed run shuffles as the uninterrupted one did."""
    perm = np.random.default_rng((key, epoch)).permutation(n)
    return torch.as_tensor(perm, device=device)


def train(state, data, batchsize: int = 100, epochs: int = 100,
          key: int = 0, lr: float = 1e-3, verbose: bool = False,
          workdir=None, checkpoint_every: int = 0, resume: bool = False,
          grid=None, check_every: int = 50, target_fun=None):
    """Fit state.flow to ``data`` (N, dim) by minimizing -E[log p] over
    minibatches of ``batchsize`` (the last N mod batchsize rows of each
    shuffle are dropped), one Adam step per batch. Sets the state's
    parameters; returns the loss of each epoch's last batch.

    ``workdir`` + ``checkpoint_every`` write the checkpoint every that many
    epochs and at the end; ``resume`` starts from it when it exists.
    ``grid`` (utils.grid.Grid) records every ``check_every`` epochs the
    grid quadrature of the model density (should approach 1) into
    ``state.pretrain_grid_integrals`` as (epoch, integral) pairs and, when
    ``workdir`` is set, saves the density snapshot fit_epoch{n}.pdf there
    (and, given ``target_fun``, gen_data's, the model-target difference
    fit_diff_epoch{n}.pdf; viz/plots.py, matplotlib)."""
    flow, layout = state.flow, state.layout
    data = torch.as_tensor(data, dtype=state.precision.compute,
                           device=state.device)
    theta = state.theta.detach().clone()
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    count = 0
    epoch0 = 0
    ckpt = None if workdir is None else os.path.join(workdir, CKPT_NAME)
    if resume and ckpt is not None and os.path.exists(ckpt):
        with np.load(ckpt) as z:
            theta, mu, nu = (torch.as_tensor(z[k], dtype=theta.dtype,
                                             device=theta.device)
                             for k in ("theta", "mu", "nu"))
            count, epoch0 = int(z["count"]), int(z["epoch"])
        if verbose:
            print(f"resumed pretraining from epoch {epoch0}")

    def save(epoch):
        os.makedirs(workdir, exist_ok=True)
        _atomic_savez(ckpt, **{k: v.detach().cpu().numpy() for k, v in
                               (("theta", theta), ("mu", mu), ("nu", nu))},
                      count=count, epoch=epoch)

    def loss_and_grad(batch):
        th = theta.detach().requires_grad_(True)
        loss = -flow.log_prob(layout.unravel(th), batch).mean()
        (grad,) = torch.autograd.grad(loss, th)
        return loss.detach(), grad

    grid_integrals = []
    if grid is not None:
        coords = torch.as_tensor(grid.coords, dtype=data.dtype,
                                 device=data.device)

    n_rows = data.shape[0] - data.shape[0] % batchsize
    losses = []
    for epoch in range(epoch0, epochs):
        perm = _shuffle(data.shape[0], key, epoch, data.device)[:n_rows]
        batches = data[perm].reshape(-1, batchsize, data.shape[-1])
        loss = None
        for batch in batches:
            loss, grad = loss_and_grad(batch)
            count += 1
            _adam(theta, grad, mu, nu, count, lr)
        losses.append(float(loss))  # one host read per epoch
        if verbose:
            print(f"epoch {epoch}: loss {losses[-1]:.6f}")
        if grid is not None and (epoch + 1) % max(check_every, 1) == 0:
            with torch.no_grad():
                integral = float((flow.log_prob(layout.unravel(theta), coords)
                                  .exp() * grid.bin_area).sum())
            grid_integrals.append((epoch + 1, integral))
            if verbose:
                print(f"epoch {epoch + 1}: grid integral {integral:.6f}")
            if workdir is not None:
                state.set_parameters(theta)
                _snapshots(state, grid, workdir, epoch + 1, target_fun)
        if ckpt is not None and checkpoint_every and \
                (epoch + 1) % checkpoint_every == 0:
            save(epoch + 1)
    if ckpt is not None and checkpoint_every:
        save(epochs)
    state.set_parameters(theta)
    if grid is not None:
        state.pretrain_grid_integrals = grid_integrals
    return losses


def _snapshots(state, grid, workdir: str, epoch: int, target_fun) -> None:
    """The density snapshot of ``epoch`` and, with ``target_fun``, the
    model-target difference, as PDFs in ``workdir``."""
    from ..viz.plots import plot_density, plot_diff, save_figure

    os.makedirs(workdir, exist_ok=True)
    save_figure(plot_density(state, grid, proj=False),
                os.path.join(workdir, f"fit_epoch{epoch}.pdf"))
    if target_fun is not None:
        save_figure(plot_diff(state, grid, target_fun),
                    os.path.join(workdir, f"fit_diff_epoch{epoch}.pdf"))


def main(argv=None):
    """CLI: fit a fresh flow to a synthetic dataset and report the
    losses; with --workdir and --checkpoint-every the checkpoint feeds the
    driver's --init-params."""
    import argparse

    from ..driver import resolve_device
    from ..models.state import make_var_state
    from ..parallel.mesh import ParallelCtx
    from ..utils.dtypes import resolve

    p = argparse.ArgumentParser(description="supervised flow pre-training "
                                            "(PyTorch port)")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--mode", choices=["standard_normal", "normal_superpos"],
                   default="standard_normal")
    p.add_argument("--std", type=float, default=1.0)
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batchsize", type=int, default=100)
    p.add_argument("--precision", default="f32")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--variant", default="affine",
                   help="coupling variant; must match the evolution flow "
                        "when the checkpoint feeds --init-params (e.g. "
                        "'scale' for the mwe/diffusion presets)")
    p.add_argument("--workdir", default=None,
                   help="write pretrain_ckpt.npz here (read by the "
                        "driver's --init-params)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    prec = resolve(args.precision)
    state = make_var_state(args.seed, args.dim, depth=args.depth,
                           variant=args.variant, device=device,
                           ctx=ParallelCtx.single_device(device),
                           precision=prec)
    data, _ = gen_data((args.n, args.dim), mode=args.mode, std=args.std,
                       dtype=prec.compute, device=device)
    losses = train(state, data, batchsize=args.batchsize,
                   epochs=args.epochs, lr=args.lr, verbose=True,
                   workdir=args.workdir,
                   checkpoint_every=args.checkpoint_every,
                   resume=args.resume)
    if losses:
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
