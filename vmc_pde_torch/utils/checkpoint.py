"""Parameter checkpoints, the counterpart of the npz half of
vmc_pde_tpu/utils/checkpoint.py.

The flat master parameter vector theta, the time, the step counter and
the stepper's dt are written as one npz per checkpoint (``ckpt_%08d.npz``)
and again as ``ckpt_latest.npz``, each to a temporary name and renamed, so
a crash mid-write never leaves a truncated file at a published path. The
files, names and keys are the JAX package's: a checkpoint written by
either package loads in the other. The JAX package's orbax pytree
checkpoints (``save_pytree``/``load_pytree``) have no counterpart here.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez to ``path`` through a temporary file and a rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # a file object: savez adds no ".npz"
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def save_checkpoint(wdir: str, step: int, t: float, theta, dt: float) -> str:
    """Write {step, t, theta, dt}; ``theta`` (a tensor on any device, or
    an array) is taken off the device in its own dtype, the master one."""
    os.makedirs(wdir, exist_ok=True)
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    payload = dict(step=step, t=t, theta=np.asarray(theta), dt=dt)
    path = os.path.join(wdir, f"ckpt_{step:08d}.npz")
    _atomic_savez(path, **payload)
    _atomic_savez(os.path.join(wdir, "ckpt_latest.npz"), **payload)
    return path


def load_checkpoint(path: str) -> dict:
    """{step, t, theta (numpy), dt} of a checkpoint file."""
    with np.load(path) as z:
        return dict(step=int(z["step"]), t=float(z["t"]),
                    theta=np.asarray(z["theta"]), dt=float(z["dt"]))


def latest_checkpoint(wdir: str):
    """The workdir's ``ckpt_latest.npz``, loaded, or None."""
    path = os.path.join(wdir, "ckpt_latest.npz")
    return load_checkpoint(path) if os.path.exists(path) else None
