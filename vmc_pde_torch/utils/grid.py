"""Dense quadrature grid for normalization checks and 2D plotting.

Same contract as the reference Grid (vmc_fluids/grid.py:7-28): ``coords`` is
the flat (n^dim, dim) array of cell anchor points, ``bin_area`` the Riemann
cell volume, ``range`` the per-axis bounds. Built here from exact linspace
bin edges (the left edge of each of n equal bins), which avoids the
float-accumulation endpoint drift of arange-with-float-step.
"""

from __future__ import annotations

import numpy as np


class Grid:
    """Regular box grid: ``sym=True`` spans [-b, b) per axis, else [0, b).

    n_gridpoints equal bins per axis; a density integrates as
    ``sum(p(coords)) * bin_area``.
    """

    def __init__(self, bounds, n_gridpoints: int, sym: bool = True):
        bounds = np.atleast_1d(np.asarray(bounds, dtype=np.float64))
        n = int(n_gridpoints)
        self.sym = sym
        self.dim = bounds.shape[0]
        self.bounds = bounds
        self.n_gridpoints = n

        lo = -bounds if sym else np.zeros_like(bounds)
        hi = bounds
        self.range = np.stack([lo, hi], axis=1).tolist()
        self.widths = (hi - lo) / n
        self.bin_area = float(np.prod(self.widths))

        # Left bin edges: n points per axis, excluding the right endpoint.
        edges = [np.linspace(l, h, n, endpoint=False) for l, h in zip(lo, hi)]
        self.vals = edges
        self.meshgrid = np.meshgrid(*edges)
        self.coords = np.stack(
            [m.reshape(-1) for m in self.meshgrid], axis=-1
        )
