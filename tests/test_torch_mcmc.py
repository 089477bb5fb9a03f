"""The port's Metropolis path against the JAX package, on the CPU: the
cos_dist and double_well latents, AdvectionPaper, the Metropolis kernel's
plain version against the JAX kernel in interpret mode on the same
uniforms, the torch chain against the JAX chain on statistics, one RHS and
one Heun pair of the fluidpaper and doubleWell flows on shared latent
draws, the MCMC bookkeeping of the TDVP and the sampler, and short drives.
The kernel's launch plan, bound, constants and probe builds are in
tests/test_torch_metropolis_plan.py.

Tolerances (relative to the largest value unless stated):
- log-densities and E_loc: 1e-12, the same closed-form f64 arithmetic in
  another operation order;
- the Metropolis kernel's plain version against the JAX kernel: the same
  accept count and samples within 2e-6 absolute (f32 transcendentals of
  two libraries, the JAX test's bar);
- chain statistics: acceptance within 0.03, mean radius within 5% of the
  analytic value, radial-histogram L1 below 0.15 (tests/test_kernels.py);
- RHS and Heun pair: 1e-8, as tests/test_torch_tdvp.py (svd_tol=1e-6).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import normal, parity_flow, rel_err, t64
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import metropolis
from vmc_pde_torch.models import latent
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops import evolution
from vmc_pde_torch.sampling import sampler as sampling
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_torch.utils.grid import Grid
from vmc_pde_tpu.kernels import metropolis as jmetropolis
from vmc_pde_tpu.models import latent as jlatent
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel.mesh import ParallelCtx
from vmc_pde_tpu.sampling import sampler as jsampling
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision

torch.set_num_threads(1)

OFF = (0.25, 0.25)
N, CHAINS = 64, 32
# fluidpaper and doubleWell at a small width: latent, offset, equation,
# proposal mode and ball bound of each preset
CASES = {
    "fluidpaper": ("cos_dist", OFF, ("advection_paper", {}),
                   "independence", 0.25),
    "doubleWell": ("double_well", (0.0, 0.0),
                   ("advection_hamiltonian_wDiss",
                    {"v2": -4.0, "lam": 1.0, "T": 0.5}), "rw", 2.5),
}


def _bump_draws(n, seed, radius=0.24):
    """n points uniform in the disk of ``radius`` < 0.25 around OFF: inside
    the cosine bump's support, where its log-density is finite."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.uniform(size=n))
    a = rng.uniform(0.0, 2.0 * np.pi, size=n)
    return np.stack([OFF[0] + r * np.cos(a), OFF[1] + r * np.sin(a)], -1)


@pytest.mark.parametrize("name", ["cos_dist", "double_well"])
def test_latent_log_prob_matches_jax_and_normalized(name):
    x = _bump_draws(64, 1) - np.asarray(OFF) if name == "cos_dist" \
        else normal((64, 2), 1)
    fn = {"cos_dist": jlatent.cos_bump_log_prob,
          "double_well": jlatent.double_well_log_prob}[name]
    want = jax.vmap(lambda v: fn(None, 2, v))(jnp.asarray(x))
    assert rel_err(latent.log_prob(name, None, 2, t64(x)), want) < 1e-12
    bound, points = (0.5, 200) if name == "cos_dist" else (6.0, 400)
    g = Grid(np.ones(2) * bound, points)
    integral = float((latent.log_prob(name, None, 2, t64(g.coords)).exp()
                      * g.bin_area).sum())
    assert abs(integral - 1.0) < 1e-3, integral
    assert latent._DW_LOG_Z == pytest.approx(jlatent._DW_LOG_Z, rel=1e-15)
    with pytest.raises(ValueError, match="dim=2"):
        latent.log_prob(name, None, 3, torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="closed-form"):
        latent.sample(name, torch.Generator(), None, 2, 4, torch.float64)


def test_advection_paper_eloc_matches_jax():
    eq = evolution.make_equation("advection_paper", 2, T=4.0)
    jeq = jevolution.make_equation("advection_paper", 2, T=4.0)
    assert eq.hessian_coords(2) is None and eq.hessian_trace_dirs(2) is None
    x, g = normal((10, 2), 1), normal((10, 2), 2)
    want = jeq.eloc(jnp.asarray(x), jnp.asarray(g), None, 0.7)
    assert rel_err(eq.eloc(t64(x), t64(g), None, 0.7), want) < 1e-12


@pytest.mark.parametrize("latent_name", ["cos_dist", "double_well"])
def test_flows_carried_across(latent_name):
    """from_jax keeps ravel_pytree's flat order for the Metropolis latents
    (empty dist_params), and both packages give the same log-density and
    push-forward."""
    from jax.flatten_util import ravel_pytree

    jflow, jparams, flow, theta = parity_flow(
        "affine", dim=2, offset=OFF, latent_name=latent_name)
    assert flow.latent_name == latent_name
    np.testing.assert_array_equal(theta.numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))
    z = _bump_draws(16, 2)
    params = flow.layout.unravel(theta)
    xp, lpp = flow.push(params, t64(z))
    xj, lpj = jax.vmap(jflow.push, in_axes=(None, 0))(jparams,
                                                      jnp.asarray(z))
    assert rel_err(xp, xj) < 1e-10 and rel_err(lpp, lpj) < 1e-10
    assert rel_err(flow.log_prob(params, xp), lpp) < 1e-10


def test_metropolis_plain_matches_jax_kernel():
    """The same uniforms through the port's plain version and the JAX
    kernel in interpret mode: the same chains, order and accept count."""
    C, d, n_steps = 128, 2, 3 * metropolis.SWEEPS_PER_BLOCK
    u = np.random.default_rng(123).uniform(
        1e-7, 1.0 - 1e-7, (2 * d + 2, n_steps * C)).astype(np.float32)
    init = np.tile(np.asarray(OFF, np.float32), (C, 1))
    samples, final, n_acc = metropolis.metropolis_chain(
        0, torch.from_numpy(init), n_steps, 0.25, OFF,
        uniforms=torch.from_numpy(u))
    js, jf, jacc = jmetropolis.metropolis_chain_pallas(
        0, init, jmetropolis.cos_bump_log_prob, n_steps, 0.25, OFF,
        interpret=True, uniforms=jnp.asarray(u))
    assert samples.shape == (n_steps * C, d) and samples.dtype == torch.float32
    np.testing.assert_allclose(samples.numpy(), np.asarray(js), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(final.numpy(), np.asarray(jf), rtol=0,
                               atol=2e-6)
    assert int(n_acc) == jacc and 0 < jacc < n_steps * C


def test_metropolis_kernel_contract_and_philox():
    """Rounding, the ValueErrors of the JAX kernel's contract, the CUDA
    wrapper's refusal of CPU tensors, and the Philox stream: Random123's
    known answers, the uniforms the plain version draws without external
    ones, and reproducibility by seed."""
    C, d = 128, 2
    init = torch.full((C, d), 0.25)
    u = torch.rand((2 * d + 2, 16 * C), generator=torch.Generator()
                   .manual_seed(5)) * 0.999 + 1e-4
    samples, _, _ = metropolis.metropolis_chain(0, init, 11, 0.25, OFF,
                                                uniforms=u)
    assert samples.shape == (16 * C, d)
    with pytest.raises(ValueError, match="uniforms"):
        metropolis.metropolis_chain(0, init, 11, 0.25, OFF,
                                    uniforms=u[:, :11 * C])
    with pytest.raises(ValueError, match="multiple of 128"):
        metropolis.metropolis_chain(0, torch.full((64, d), 0.25), 8, 0.25,
                                    OFF)
    with pytest.raises(ValueError, match="2-D"):
        metropolis.metropolis_chain(0, torch.full((C, 3), 0.25), 8, 0.25,
                                    (0.25,) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        metropolis.metropolis_chain_cuda(0, init, 8, 0.25, OFF)
    kat = metropolis.philox4x32_10((0x243F6A88, 0x85A308D3, 0x13198A2E,
                                    0x03707344), (0xA4093822, 0x299F31D0))
    assert [int(w) for w in kat] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420,
                                     0x24126EA1]
    kat = metropolis.philox4x32_10((0,) * 4, (0, 0))
    assert [int(w) for w in kat] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    pu = metropolis.philox_uniforms(7, C, 8, d)
    assert pu.shape == (2 * d + 2, 8 * C) and pu.min() > 0 and pu.max() < 1
    a = metropolis.metropolis_chain(7, init, 8, 0.25, OFF)
    b = metropolis.metropolis_chain(7, init, 8, 0.25, OFF,
                                    uniforms=torch.from_numpy(pu))
    c = metropolis.metropolis_chain(8, init, 8, 0.25, OFF)
    assert torch.equal(a[0], b[0]) and int(a[2]) == int(b[2])
    assert not torch.equal(a[0], c[0])


def _radii_stats(samples, burn):
    r = np.linalg.norm(np.asarray(samples)[burn:] - np.asarray(OFF), axis=1)
    return r, r.mean()


def test_chain_statistics_match_jax():
    """The torch chain, the Metropolis kernel's plain version (Philox) and
    the JAX chain sample the cosine bump alike; the random-walk chains on
    the double well accept alike and reach the latent's momentum variance
    T0."""
    C, n_steps, bound = 128, 400, 0.25
    burn = 100 * C
    info = {"offset": np.asarray(OFF), "bound": bound}
    init = np.tile(np.asarray(OFF), (C, 1))
    gen = torch.Generator().manual_seed(10)
    t_s, _, t_acc = sampling.metropolis_chain(
        gen, t64(init), lambda x: sampling.cos_dist_log_prob(x, t64(OFF)),
        sampling.radial_proposal, n_steps, info)
    k_s, _, k_acc = metropolis.metropolis_chain(
        3, torch.as_tensor(init, dtype=torch.float32), n_steps, bound, OFF)
    j_s, _, j_acc = jsampling.metropolis_chain(
        jax.random.PRNGKey(10), jnp.asarray(init),
        partial(jsampling.cos_dist_log_prob, offset=jnp.asarray(OFF)),
        jsampling.radial_proposal, n_steps,
        {"offset": jnp.asarray(OFF), "bound": bound})
    total = n_steps * C
    rates = [int(a) / total for a in (t_acc, k_acc, j_acc)]
    assert max(rates) - min(rates) < 0.03, rates
    s_grid = np.linspace(0, bound, 20001)
    w = s_grid * (1 + np.cos(4 * np.pi * s_grid))
    mean_r = np.trapezoid(s_grid * w, s_grid) / np.trapezoid(w, s_grid)
    rj, _ = _radii_stats(j_s, burn)
    hj, edges = np.histogram(rj, bins=25, range=(0, bound), density=True)
    for s in (t_s, k_s):
        r, m = _radii_stats(s, burn)
        assert abs(m / mean_r - 1) < 0.05, m
        h, _ = np.histogram(r, bins=edges, density=True)
        assert np.abs(h - hj).mean() / hj.mean() < 0.15

    # random walk on the double well (the doubleWell preset's proposals)
    dw = {"offset": np.zeros(2), "bound": 2.5}
    init = np.zeros((C, 2))
    t_s, _, t_acc = sampling.metropolis_chain(
        torch.Generator().manual_seed(4), t64(init),
        lambda x: latent.double_well_log_prob(None, 2, x),
        sampling.radial_proposal, n_steps, dw, rw_scale=0.8)
    j_s, _, j_acc = jsampling.metropolis_chain(
        jax.random.PRNGKey(4), jnp.asarray(init),
        lambda x: jlatent.double_well_log_prob(None, 2, x),
        jsampling.radial_proposal, n_steps, dw, rw_scale=0.8)
    assert abs(int(t_acc) - int(j_acc)) / total < 0.03
    for s in (t_s, j_s):
        p2 = float((np.asarray(s)[burn:, 1] ** 2).mean())
        assert abs(p2 / latent.DW_T0 - 1) < 0.1, p2


def test_sampler_kernel_gate_and_budgets(monkeypatch):
    """The kernel route's gate (a CUDA device, the cos_dist target,
    independence proposals, n_chains % 128 == 0), the budget rounding to
    whole chains, and the kernel route's sweep rounding, trimming and
    proposal count, through its plain version on the CPU (the gate opened
    for the CPU by hand)."""
    s = sampling.Sampler(2, "cos_dist", n_chains=128,
                         mcmc_info={"offset": np.asarray(OFF), "bound": 0.25})
    assert s.uses_kernel("cuda") and not s.uses_kernel("cpu")
    assert s.rounded_budget(1000) == 1024
    for kw in (dict(name="cos_dist", n_chains=30),
               dict(name="cos_dist", n_chains=128, proposal_mode="rw"),
               dict(name="double_well", n_chains=128)):
        other = sampling.Sampler(2, **kw)
        assert not other.uses_kernel("cuda")
    assert sampling.Sampler(2, "double_well").rounded_budget(10000) == 10020
    with pytest.raises(ValueError, match="proposal_mode"):
        sampling.Sampler(2, "cos_dist", proposal_mode="mala")

    _, _, flow, theta = parity_flow("affine", dim=2, offset=OFF,
                                    latent_name="cos_dist")
    k = sampling.Sampler(2, "cos_dist", dtype=torch.float64, n_chains=128,
                         mcmc_info={"offset": np.asarray(OFF),
                                    "bound": 0.25})
    monkeypatch.setattr(k, "uses_kernel", lambda device: True)
    state = VarState(flow, theta, sampler=k,
                     precision=Precision.f64_everywhere())
    x, logp = state.sample(1500, key=3)  # 12 sweeps, rounded to 16
    assert x.shape == (1536, 2) and x.dtype == torch.float64
    assert k.last_info.num_proposed == 16 * 128
    assert 0.05 < k.last_info.acceptance_rate < 0.95
    params = flow.layout.unravel(theta)
    assert rel_err(flow.log_prob(params, x), logp) < 1e-10
    assert k._states.shape == (128, 2)


def _problem(case, n_obs=N):
    """The same f64 MCMC TDVP problem in both packages (svd_tol=1e-6)."""
    name, offset, (eq_name, eq_kw), mode, bound = CASES[case]
    jflow, jparams, flow, theta = parity_flow(
        "affine", dim=2, seed=21, offset=offset, latent_name=name)
    info = {"offset": np.asarray(offset), "bound": bound}
    ctx = ParallelCtx.single_device()
    jprec = JPrecision.f64_everywhere()
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=jsampling.Sampler(
                           dim=2, ctx=ctx, name=name, n_chains=CHAINS,
                           mcmc_info=info, proposal_mode=mode,
                           dtype=jnp.float64))
    jtdvp = JTDVP(jstate, jevolution.make_equation(eq_name, 2, **eq_kw),
                  JTDVPConfig(svd_tol=1e-6), n_samples=N, n_samples_obs=N,
                  precision=jprec)
    prec = Precision.f64_everywhere()
    state = VarState(flow, theta, precision=prec,
                     sampler=sampling.Sampler(2, name, dtype=torch.float64,
                                              n_chains=CHAINS,
                                              mcmc_info=info,
                                              proposal_mode=mode))
    tdvp = TDVP(state, evolution.make_equation(eq_name, 2, **eq_kw),
                TDVPConfig(svd_tol=1e-6), n_samples=N, n_samples_obs=n_obs,
                precision=prec)
    return jtdvp, tdvp, theta


def _draws(case, seed):
    return _bump_draws(N, seed) if case == "fluidpaper" else normal((N, 2),
                                                                    seed)


def _jax_rhs(jtdvp, theta, t, z):
    aux = jtdvp._fused(jnp.asarray(np.asarray(theta)), t,
                       jax.random.PRNGKey(0), jnp.asarray(z), None, None,
                       None, n=N, n_obs=N, with_obs=True)
    return {k: np.asarray(v) for k, v in aux.items()}


OBS = ("x1", "covar", "entropy", "x3", "x4", "eloc_mean", "eloc_var",
       "tdvp_error")


@pytest.mark.parametrize("case", list(CASES))
def test_rhs_and_heun_pair_match_jax(case):
    jtdvp, tdvp, theta = _problem(case)
    assert tdvp.solver_method == jtdvp.solver_method == "eigh"
    z = _draws(case, 31)
    jaux = _jax_rhs(jtdvp, theta, 0.25, z)
    aux = tdvp._rhs_impl(theta, 0.25, 0, t64(z))
    for k in ("update", "ev", "solver_res") + OBS:
        assert rel_err(aux[k], jaux[k]) < 1e-8, k
    z0, z1 = _draws(case, 41), _draws(case, 42)
    t = 0.1
    k0 = _jax_rhs(jtdvp, theta, t, z0)["update"]
    # the perturbed flows' updates reach 1e10: a step that moves theta by
    # 1e-4 keeps stage 1 on a finite density
    dt = 1e-4 / max(1.0, np.abs(k0).max())
    k1 = _jax_rhs(jtdvp, theta.numpy() + dt * k0, t + dt, z1)["update"]
    dy, aux = tdvp.heun_pair(theta, t, dt, key=3, z_ext=(t64(z0), t64(z1)))
    assert rel_err(dy, 0.5 * dt * (k0 + k1)) < 1e-8
    assert "mcmc_accepted" not in aux  # shared draws: no chain ran


def test_fused_chain_bookkeeping():
    """A Heun pair on the chains: stage 0 runs n / n_chains sweeps and
    continues the chains for the larger observables budget, stage 1 runs
    n / n_chains more from where stage 0 left them; the counts stay
    tensors and sum over the stages; the staged rhs() path carries the
    chains the same way; the random-walk scale adapts on the device."""
    _, tdvp, theta = _problem("doubleWell", n_obs=2 * N)
    s = tdvp.sampler
    assert s._states is None
    dy, aux = tdvp.heun_pair(theta, 0.0, 1e-14, key=5)
    assert aux["mcmc_proposed"] == 2 * N + 2 * N
    assert isinstance(aux["mcmc_accepted"], torch.Tensor)
    assert 0 < int(aux["mcmc_accepted"]) < aux["mcmc_proposed"]
    assert s.last_info.num_accepted is aux["mcmc_accepted"]
    assert isinstance(s.rw_scale, torch.Tensor) and float(s.rw_scale) != 0.8
    first = s._states.clone()
    _, aux1 = tdvp.rhs(theta, 0.0, 6, intStep=1)
    assert aux1["mcmc_proposed"] == N and not torch.equal(first, s._states)
    assert torch.isfinite(dy).all() and not bool(aux["nan"])


def test_driver_fluidpaper_and_doublewell():
    """fluidpaper through the port's driver on the CPU (f64, 100 chains,
    N=3000): mass stays on the [0, 1]^2 grid, entropy and residual are
    finite, the acceptance counts are recorded and the rate is sane; a
    short doubleWell drive adapts its random-walk scale."""
    cfg = preset("fluidpaper", device="cpu", n_samples_tdvp=3000,
                 n_samples_obs=3000, n_chains=100, dt0=1e-3, max_step=1e-3,
                 precision="f64", verbose=False, grid_points=100)
    state, rec = driver.run(cfg, max_steps=8)
    a = rec.as_arrays()
    assert np.isfinite(a["entropy"]).all() and (a["solver_res"] < 1e-6).all()
    assert (a["mcmc_proposed"] == 2 * 3000).all()
    rate = a["mcmc_accepted"].sum() / a["mcmc_proposed"].sum()
    assert 0.05 < rate < 0.95, rate
    g = Grid(np.ones(2) * 1.0, 150, sym=False)
    assert abs(float(state.integrate(g)) - 1.0) < 0.05

    _, rec = driver.main(["doubleWell", "--device", "cpu", "--samples",
                          "800", "--max-steps", "3", "--precision", "f64"])
    a = rec.as_arrays()
    assert (a["mcmc_proposed"] == 2 * 810).all() and not a["nan"].any()
