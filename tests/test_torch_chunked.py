"""The port's chunked statistics (solver/tdvp.py ``_chunked_stats``) against
the JAX package's on the same samples, on the CPU in f32: d=2, N=2048 in
chunks of 512, the JAX side with its Pallas per-sample kernel in interpret
mode (the split-emitting variant on the sym2/tri2 pair path, and quant8's
kernel with the int8 cross term), the port with per_sample_backend="cuda",
whose wrappers take the plain versions for CPU tensors. Then the direct
statistics with a split Gram, one chunked fixed-Heun pair at tri2 + int8,
and the driver's new flags.

Tolerances:
- S0, F0 and A: 1e-4 of each one's largest value, the bar the JAX package
  holds its split path to against its plain one (tests/test_persample.py):
  both sides sum f32 chunk moments in other orders, and the bf16 split
  drops its lo*lo term (~2^-16 relative) in both;
- logp and E_loc: 1e-6 of the largest value: the same f32 formulas in
  another order (the interpreted kernel's hand-written derivatives);
- the Heun step: 1e-4 relative (see the test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_models import normal, parity_flow, rel_err
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import persample, quant8
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops import evolution
from vmc_pde_torch.sampling.sampler import Sampler
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
from vmc_pde_torch.utils.dtypes import resolve
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel.mesh import ParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import resolve as jresolve

torch.set_num_threads(1)

DIM, N, C = 2, 2048, 512
EQ = ("advection_hamiltonian_wDiss", {"T": 3.0})


def _problem(precision="tpu", **cfg):
    """The same f32 chunked TDVP problem in both packages: a perturbed
    affine flow, the Fokker-Planck equation, N samples in chunks of C.
    Output weights of +-0.05 keep the f32 per-sample values of the two
    packages within ~3e-7 of each other (at +-0.3 far-out samples reach
    2e-5, the f32 pipelines' own rounding)."""
    cfg.update(chunk_size=C, gram_precision="high")
    jflow, jparams, flow, theta = parity_flow("affine", dim=DIM, seed=21,
                                              out_scale=0.05)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    ctx = ParallelCtx.single_device()
    jprec = jresolve(precision)
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=DIM, ctx=ctx, name="Gauss",
                                        dtype=jnp.float32))
    jtdvp = JTDVP(jstate, jevolution.make_equation(EQ[0], DIM, **EQ[1]),
                  JTDVPConfig(per_sample_backend="pallas", **cfg),
                  n_samples=N, n_samples_obs=N, precision=jprec)
    prec = resolve(precision)
    state = VarState(flow, theta.float(),
                     sampler=Sampler(DIM, dtype=torch.float32),
                     precision=prec)
    tdvp = TDVP(state, evolution.make_equation(EQ[0], DIM, **EQ[1]),
                TDVPConfig(per_sample_backend="cuda", **cfg), n_samples=N,
                n_samples_obs=N, precision=prec)
    return jtdvp, tdvp, theta, ravel_pytree(jparams)[0]


def _samples(tdvp, theta, seed):
    params = tdvp.flow.layout.unravel(theta.float())
    z = torch.from_numpy(normal((N, DIM), seed).astype(np.float32))
    return tdvp.flow.push(params, z)[0]


@pytest.mark.parametrize("backend,cross", [
    ("xla", "auto"), ("tri2", "bf16"), ("tri2", "int8"), ("sym2", "bf16"),
    ("sym2", "int8")])
def test_chunked_stats_match_jax(backend, cross):
    jtdvp, tdvp, theta, jflat = _problem(gram_backend=backend,
                                         gram_cross=cross)
    split = backend != "xla"
    assert (jtdvp._ps_split is not None) == split
    assert (tdvp._ps_split is not None) == split
    assert tdvp._cross_int8 == jtdvp._cross_int8 == (cross == "int8")
    x = _samples(tdvp, theta, 51)
    launches = (persample.per_sample_cuda.launches,
                persample.per_sample_split_cuda.launches,
                quant8.quant_force_cuda.launches)
    st = tdvp._chunked_stats(theta.float(), 0.25, x)
    jst = jtdvp._chunked_stats(jflat, 0.25, jnp.asarray(x.numpy()))
    assert launches == (persample.per_sample_cuda.launches,
                        persample.per_sample_split_cuda.launches,
                        quant8.quant_force_cuda.launches)
    for key in ("S0", "F0", "A"):
        assert st[key].dtype == torch.float32
        assert rel_err(st[key], jst[key]) < 1e-4, key
    for key in ("logp", "eloc"):
        assert st[key].shape == (N,)
        assert rel_err(st[key], jst[key]) < 1e-6, key
    for key in ("eloc_mean", "eloc_var", "eloc_abs_mean", "eloc_sq_mean"):
        assert rel_err(st[key], jst[key]) < 1e-5, key


@pytest.mark.parametrize("backend,cross", [("tri2", "int8"),
                                           ("sym2", "bf16")])
def test_direct_stats_split_gram_matches_jax(backend, cross):
    """The direct (unchunked) statistics take the configured split Gram
    too, as the JAX package's do."""
    jtdvp, tdvp, theta, jflat = _problem(gram_backend=backend,
                                         gram_cross=cross)
    x = _samples(tdvp, theta, 52)
    st = tdvp._direct_stats(theta.float(), 0.25, x)
    jst = jax.jit(jtdvp._direct_stats)(jflat, 0.25, jnp.asarray(x.numpy()))
    for key in ("S0", "F0", "A"):
        assert rel_err(st[key], jst[key]) < 1e-4, key


def test_chunked_heun_pair_matches_jax():
    """One fixed-Heun step dy = dt/2 (k0 + k1) through the chunked tri2 +
    int8 statistics, each stage on its own shared latent draws, against
    the same composition of two JAX RHS evaluations. f32 statistics with
    an f64 solve and svd_tol=1e-3: the two packages' statistics differ by
    f32 summation order (~1e-6 relative), which a well-regularized solve
    passes on to the update within 1e-4."""
    jtdvp, tdvp, theta, _ = _problem(
        precision="tpu_f64stats", gram_backend="tri2", gram_cross="int8",
        svd_tol=1e-3)
    z0, z1 = (normal((N, DIM), s).astype(np.float32) for s in (61, 62))
    t, dt = 0.1, 1e-3

    def jrhs(th, tt, z):
        return jtdvp._fused(jnp.asarray(th, jnp.float32), tt,
                            jax.random.PRNGKey(0), jnp.asarray(z), None,
                            None, None, n=N, n_obs=N, with_obs=True)

    th32 = theta.float().numpy()
    jaux = jrhs(th32, t, z0)
    k0 = np.asarray(jaux["update"], np.float32)
    k1 = np.asarray(jrhs(th32 + np.float32(dt) * k0, t + dt, z1)["update"])
    dy, aux = tdvp.heun_pair(theta, t, dt, key=3,
                             z_ext=(torch.from_numpy(z0),
                                    torch.from_numpy(z1)))
    assert dy.dtype == torch.float64
    assert rel_err(dy, 0.5 * dt * (k0 + k1)) < 1e-4
    assert not bool(aux["nan"])
    # the regularized solve leaves a residual; both packages leave the same
    for key in ("solver_res", "tdvp_error", "entropy"):
        assert rel_err(aux[key], jaux[key]) < 1e-4, key


def test_driver_chunk_and_gram_flags():
    """--chunk-size, --gram-backend and --gram-cross reach the solver; on
    the CPU the run takes the plain versions and launches no kernel; the
    budget rounds up to whole chunks; the syrk Gram runs chunked; the
    adaptive stepper, refused before it was ported, runs chunked with the
    dense SExp (eigh at mwe's P) and a finite error."""
    launches = (persample.per_sample_cuda.launches,
                persample.per_sample_split_cuda.launches,
                quant8.quant_force_cuda.launches)
    args = ["mwe", "--device", "cpu", "--samples", "1000", "--chunk-size",
            "256", "--gram-backend", "tri2", "--gram-cross", "int8",
            "--per-sample-backend", "cuda", "--max-steps", "2"]
    _, rec = driver.main(args)
    a = rec.as_arrays()
    assert a["times"].shape == (2,) and not a["nan"].any()
    assert (a["solver_res"] < 1e-4).all()
    assert launches == (persample.per_sample_cuda.launches,
                        persample.per_sample_split_cuda.launches,
                        quant8.quant_force_cuda.launches)
    cfg = preset("mwe", device="cpu", n_samples_tdvp=1000, chunk_size=256,
                 gram_backend="tri2", gram_cross="int8")
    tdvp = driver.build_problem(cfg)[1]
    assert tdvp.n_samples == 1024 and tdvp._use_tri2 and tdvp._cross_int8
    assert tdvp.cfg.chunk_size == 256
    _, rec = driver.main(args[:7] + ["--gram-backend", "syrk",
                                     "--max-steps", "1"])
    assert (rec.as_arrays()["solver_res"] < 1e-4).all()
    _, rec = driver.run(dataclasses.replace(cfg, stepper="adaptive_heun",
                                            verbose=False), max_steps=1)
    a = rec.as_arrays()
    assert a["attempts"][0] >= 1 and np.isfinite(a["step_error"]).all()
    assert not a["nan"].any()
    with pytest.raises(ValueError, match="cross term"):
        driver.main(args[:7] + ["--gram-cross", "int8"])
