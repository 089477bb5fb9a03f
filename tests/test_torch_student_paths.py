"""The port's plain per-sample pipeline on the Student-t latent and the
learned global affine against the JAX kernel's reference functions, the
presets that use them against the JAX package's, and the d=8 Student-t
diffusion preset through the CLI, on the CPU in f64. The rest of the
Student-t slice is in tests/test_torch_student.py; the two files are kept
apart so that each holds fewer tests than tests/test_oracle_and_e2e.py,
which pytest-xdist's loadfile scheduling then starts among the first
files.

Tolerances: the per-sample pipeline 1e-10 of the largest value, as
tests/test_torch_persample.py holds the O rows (see
tests/test_torch_student.py); the presets' shared fields equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import normal, parity_flow, rel_err, t64
from vmc_pde_torch import config, driver
from vmc_pde_torch.kernels import persample
from vmc_pde_tpu import config as jconfig
from vmc_pde_tpu.kernels import persample as jpersample

torch.set_num_threads(1)


CASES = [(v, ga, lat) for lat in ("Gauss", "Student_t")
         for ga in (False, True) for v in ("scale", "affine")]


@pytest.mark.parametrize("variant,ga,lat", CASES)
def test_plain_per_sample_matches_jax_reference(variant, ga, lat):
    """The port's plain per-sample pipeline (the CUDA kernel's plain
    version) against the JAX kernel's own reference functions,
    tile_value_and_grads (logp, g, O with the nu row and the global-affine
    rows) and tile_quad(impl="jet") along non-axis directions, d=4,
    depth 2, N=16: 1e-10."""
    jflow, jparams, flow, theta = parity_flow(
        variant, seed=11, latent_name=lat, global_affine=ga)
    x = normal((16, 4), 12)
    dirs = normal((3, 4), 13)
    lp_j, g_j, O_j = jpersample.tile_value_and_grads(jflow, jparams,
                                                     jnp.asarray(x))
    q_j = jpersample.tile_quad(jflow, jparams, jnp.asarray(x),
                               jnp.asarray(dirs), impl="jet")
    got = persample.per_sample_plain(flow, theta, t64(x), t64(dirs))
    for name, g_, w_ in zip(("logp", "g", "quad", "O"), got,
                            (lp_j, g_j, q_j, O_j)):
        assert g_.shape == tuple(w_.shape), name
        assert rel_err(g_, w_) < 1e-10, name
    assert persample.supports(flow, dirs, None)


NEW_PRESETS = ("diffusion", "diffusion_anisotropic", "harmonicOsc",
               "harmonicOsc_diff")


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_presets_match_jax(name):
    """Every field the two RunConfigs share has the JAX preset's value."""
    ours, theirs = config.PRESETS[name], jconfig.PRESETS[name]
    shared = ({f.name for f in dataclasses.fields(ours)}
              & {f.name for f in dataclasses.fields(theirs)})
    assert {"eloc_clip", "is_gamma", "latent_name", "equation"} <= shared
    for field in sorted(shared):
        assert getattr(ours, field) == getattr(theirs, field), field


@pytest.mark.parametrize("args", [[], ["--is-gamma", "0.5"]])
def test_driver_diffusion_cpu(args):
    """Two steps of the d=8 Student-t diffusion preset through the CLI on
    the CPU in f64, with and without the tempered importance sampling:
    finite, nu recorded per step, and the solver residual below 1e-3 (at
    N=256 < P=365 the Gram is singular, and the regularized solve leaves
    ~1e-6 of the force unmatched)."""
    _, rec = driver.main(["diffusion", "--device", "cpu", "--precision",
                          "f64", "--samples", "256", "--max-steps", "2",
                          *args])
    a = rec.as_arrays()
    assert a["times"].shape == (2,) and not a["nan"].any()
    assert a["solver_res"].max() < 1e-3
    assert a["dist_params"].shape == (2, 1)
    assert np.isfinite(a["entropy"]).all()
    if args:
        assert ((0 < a["is_ess_share"]) & (a["is_ess_share"] <= 1)).all()
