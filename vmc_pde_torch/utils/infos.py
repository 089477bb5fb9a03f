"""Per-step diagnostics recording and HDF5 persistence.

Schema-compatible with the reference's infos dict -> HDF5 dump
(vmc_fluids/util.py:29-32, main.py:157-190): one dataset per key, rows are
time steps. The shipped paper data (paper_plot/*/infos.hdf5) reads back with
the same keys: times, ev, snr, solver_res, tdvp_error, dist_params, x1,
covar, entropy, x3..x6, max_grad, integral_*sigma.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


class InfoRecorder:
    """Accumulates per-step diagnostics WITHOUT forcing device->host
    synchronization: values are stored as-is (device tensors stay device
    tensors, letting the step loop run ahead of the host) and copied to
    host numpy by ``as_arrays``/``flush``."""

    # The raw parameter update and the adaptive steppers' (P, P) SExp are
    # internal per-step payloads: at P~10^4 recording them would bloat the
    # HDF5 for no diagnostic use.
    SKIP_KEYS = frozenset({"update", "SExp"})

    def __init__(self):
        self.infos = {}  # key -> list of per-step rows

    def append(self, key: str, value):
        self.infos.setdefault(key, []).append(value)

    def append_dict(self, d: dict):
        for k, v in d.items():
            if k.startswith("_") or k in self.SKIP_KEYS:
                continue
            self.append(k, v)

    def flush(self):
        """Materialize everything recorded so far to host numpy."""
        self.infos = {k: [_to_host(e) for e in v]
                      for k, v in self.infos.items()}

    def as_arrays(self):
        self.flush()
        return {k: np.stack([np.asarray(e) for e in v])
                for k, v in self.infos.items()}


def store_infos(wdir: str, infos, name: str = "infos.hdf5"):
    """HDF5 writer (util.py:29-32). ``infos`` is an InfoRecorder or a dict
    of per-key arrays."""
    import h5py

    if isinstance(infos, InfoRecorder):
        infos = infos.as_arrays()
    path = wdir + name if wdir.endswith("/") else f"{wdir}/{name}"
    with h5py.File(path, "w") as f:
        for key, value in infos.items():
            f.create_dataset(key, data=np.asarray(value))
    return path
