"""The port's ground-truth oracles (vmc_pde_torch/oracle/) against the JAX
package's vmc_pde_tpu/oracle/, on the CPU in f64, and the infos files
both ways.

Tolerances:
- the drifts and one rk4_sde_step: 1e-12 of the largest value, on the
  same cloud and the same standard normals in both packages (the JAX
  oracle's draws replaced by them), noise-free (T = 0) and noisy; the
  same closed-form arithmetic in another operation order;
- evolve under advection_paper (deterministic) on a shared 512-particle
  cloud: every infos key within 1e-11 of its largest value after 40
  steps (rounding compounds over the steps);
- the noisy oracle against closed forms, within 5 standard errors of the
  estimate: a variance estimate at n particles has SE sqrt(2/n) times
  the variance, a mean SE sqrt(var / n); the two packages draw
  different noise (the port one torch.randn per step, the JAX package a
  key per particle and stage), so only statistics compare;
- the radial oracle: every function and every output of evolve_radial
  within 1e-12 (elementwise f64 arithmetic in the JAX order; the sums
  of the diagnostics in another order);
- the Metropolis cloud's mean radius within 5 batch-means standard
  errors (one batch per chain) of the cosine bump's; the double-well x
  marginal within a Kolmogorov-Smirnov distance of 2 / sqrt(n) of the
  quadrature CDF (p ~ 7e-4 for a correct sampler).
"""

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import normal, rel_err, t64
from vmc_pde_torch.oracle import radial, sde
from vmc_pde_torch.oracle.__main__ import CASES
from vmc_pde_torch.oracle.__main__ import main as oracle_main
from vmc_pde_torch.utils import infos as tinfos
from vmc_pde_tpu.oracle import radial as jradial
from vmc_pde_tpu.oracle import sde as jsde
from vmc_pde_tpu.oracle.__main__ import CASES as JCASES
from vmc_pde_tpu.oracle.__main__ import main as joracle_main
from vmc_pde_tpu.utils import infos as jinfos

torch.set_num_threads(1)

# tests/test_oracle_and_e2e.py's heat-transport chain
# (scripts/make_paper_figures.py HEAT_CHAIN)
HEAT_CHAIN = dict(m=1.0, omega=1.0, gamma=1.0, lam=0.0,
                  T=(10.0, 5.0, 2.5), coupled=True, onsite=1.0)

DRIFT_CASES = [
    ("advection_paper", {"T": 5.0}, 2),
    ("diffusion", {"D": 0.7}, 4),
    ("phase_space", {"T": (0.0, 0.0, 0.0), "coupled": True,
                     "onsite": 0.5}, 6),
    ("phase_space", {"T": 0.0, "lam": 1.0, "v2": -4.0, "gamma": 0.5,
                     "m": 1.5}, 2),
    ("phase_space", dict(HEAT_CHAIN), 6),
]


@pytest.fixture(scope="module")
def jax_drifts():
    """For every case, on a 64-particle cloud: the JAX drift and one JAX
    RK4 step, each fed the standard normals also handed to the port. The
    JAX oracle draws them as jax.random.normal(key, ...) from a key per
    particle (split in four for the RK4 stages); here its key is the
    normals themselves, with jax.random.normal and split patched to pass
    them through (so no threefry is compiled). One jitted program for all
    cases."""
    n, t, dt = 64, 0.3, 1e-2
    xs = [normal((n, d), 5) for _, _, d in DRIFT_CASES]
    noises = [normal((n, 5, d), 6 + i)
              for i, (_, _, d) in enumerate(DRIFT_CASES)]

    def run(xs, noises):
        out = []
        for (name, params, d), x, z in zip(DRIFT_CASES, xs, noises):
            jdrift = jsde.DRIFTS[name]
            out.append(jax.vmap(lambda c, k: (
                jdrift(c, t, dt, k[0], **params),
                jsde.rk4_sde_step(c, t, dt, k[1:], jdrift, params)))(x, z))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: key)
        mp.setattr(jax.random, "split", lambda key, num=2: key)
        outs = jax.jit(run)([jnp.asarray(x) for x in xs],
                            [jnp.asarray(z) for z in noises])
    return t, dt, xs, noises, [[np.asarray(a) for a in o] for o in outs]


@pytest.mark.parametrize("case", range(len(DRIFT_CASES)),
                         ids=[f"{n}-{i}" for i, (n, _, _)
                              in enumerate(DRIFT_CASES)])
def test_drift_and_rk4_step_match_jax(jax_drifts, case):
    """Each drift, then one RK4 step: the port on the JAX package's
    normals against the JAX oracle, noise-free (T = 0) and noisy."""
    name, params, _ = DRIFT_CASES[case]
    t, dt, xs, noises, outs = jax_drifts
    x, normals = t64(xs[case]), noises[case]
    want_drift, want_step = outs[case]
    drift = sde.DRIFTS[name]
    got = drift(x, t, dt, t64(normals[:, 0]), **params)
    assert rel_err(got, want_drift) < 1e-12
    noise = t64(normals[:, 1:].transpose(1, 0, 2))  # (stage, particle, d)
    got = sde.rk4_sde_step(x, t, dt, noise, drift, params)
    assert rel_err(got, want_step) < 1e-12


def test_evolve_advection_matches_jax():
    """Deterministic advection of a shared cloud: the observables recorded
    before each step, and the final cloud."""
    x = 0.25 + 0.1 * normal((512, 2), 7)
    kw = dict(drift_name="advection_paper", params={"T": 5.0},
              integral_T=5.0)
    jc, jinf = jsde.evolve(jnp.asarray(x), 0.1, 2e-2, 40, **kw)
    c, inf = sde.evolve(t64(x), 0.1, 2e-2, 40, **kw)
    assert sorted(inf) == sorted(jinf)
    for key in inf:
        assert inf[key].shape == np.asarray(jinf[key]).shape, key
        assert rel_err(inf[key], jinf[key]) < 1e-11, key
    assert rel_err(c, jc) < 1e-11


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_diffusion_covariance_growth():
    """Pure diffusion from N(0, I): Cov(t) = (1 + 2 D t) I
    (tests/test_oracle_and_e2e.py:18), and the recorded pairing: record i
    is the cloud at t0 + i dt, before step i."""
    n, d, dt, steps = 20000, 2, 1e-2, 100
    x0 = torch.randn((n, d), generator=_gen(0), dtype=torch.float64)
    c, inf = sde.evolve(x0, 0.0, dt, steps, drift_name="diffusion",
                        params={"D": 1.0}, gen=_gen(1))
    np.testing.assert_allclose(inf["times"], np.arange(steps) * dt)
    np.testing.assert_allclose(inf["covar"][0], np.cov(x0.numpy().T,
                                                       ddof=0), rtol=1e-12)
    var = 1 + 2 * steps * dt
    cov = np.cov(c.numpy().T, ddof=0)
    se_diag, se_off = math.sqrt(2 / n) * var, var / math.sqrt(n)
    assert np.abs(np.diag(cov) - var).max() < 5 * se_diag
    assert abs(cov[0, 1]) < 5 * se_off


def test_phase_space_stationary_variance():
    """The damped harmonic phase space relaxes to Var = T in x and p
    (tests/test_oracle_and_e2e.py:32): after t = 6 the start's offset
    from it has decayed as e^-t, to ~2e-3 of T."""
    n, T = 4000, 4.0
    x0 = torch.randn((n, 2), generator=_gen(0), dtype=torch.float64)
    c, _ = sde.evolve(x0, 0.0, 1e-2, 600, drift_name="phase_space",
                      params={"m": 1.0, "omega": 1.0, "gamma": 1.0,
                              "T": T, "lam": 0.0}, gen=_gen(1))
    var = c.var(dim=0, unbiased=False).numpy()
    assert np.abs(var - T).max() < 5 * math.sqrt(2 / n) * T


def test_heat_chain_vs_lyapunov():
    """Per-site bath temperatures (the heat-transport chain) against the
    exact covariance flow dS/dt = A S + S A^T + B from S(0) = I
    (tests/test_oracle_and_e2e.py:819), at every record."""
    from scipy.integrate import solve_ivp

    p = dict(HEAT_CHAIN)
    n, dt, steps = 5000, 1e-2, 51
    x0 = torch.randn((n, 6), generator=_gen(3), dtype=torch.float64)
    _, inf = sde.evolve(x0, 0.0, dt, steps, drift_name="phase_space",
                        params=p, gen=_gen(4))
    K = np.zeros((3, 3))
    for i in range(3):
        K[i, i] = 2.0 + p["onsite"]
        K[i, (i - 1) % 3] -= 1.0
        K[i, (i + 1) % 3] -= 1.0
    A, B = np.zeros((6, 6)), np.zeros((6, 6))
    for i in range(3):
        A[2 * i, 2 * i + 1] = 1.0
        A[2 * i + 1, 0::2] = -K[i]
        A[2 * i + 1, 2 * i + 1] = -p["gamma"]
        B[2 * i + 1, 2 * i + 1] = 2.0 * p["gamma"] * p["T"][i]
    t = inf["times"]
    sol = solve_ivp(lambda _, y: (A @ y.reshape(6, 6) + y.reshape(6, 6)
                                  @ A.T + B).ravel(),
                    (0, t[-1]), np.eye(6).ravel(), t_eval=t, rtol=1e-10,
                    atol=1e-12)
    exact = np.diagonal(sol.y.reshape(6, 6, -1), axis1=0, axis2=1)
    mc = np.diagonal(inf["covar"], axis1=1, axis2=2)
    # the start's own sampling error persists along the flow: 5 SE of
    # both, relative to the variance
    assert (np.abs(mc - exact) < 5 * math.sqrt(2 / n) * exact).all()


def _bump_mean_radius(bound=0.25):
    """Mean radius of the 2-D cosine bump, p(s) ~ s (1 + cos(pi s /
    bound)) on [0, bound], by quadrature."""
    s = np.linspace(0.0, bound, 200001)
    w = s * (1.0 + np.cos(math.pi * s / bound))
    return float(np.trapezoid(s * w, s) / np.trapezoid(w, s))


def test_mcmc_init_cloud_plain_path():
    """The fluidpaper cloud through the Metropolis kernel's plain version
    (a CPU generator): its shape and dtype, the first rows after burn-in,
    and the mean radius against the bump's."""
    n, C = 4096, 256
    cloud = sde.mcmc_init_cloud(_gen(0), n, (0.25, 0.25))
    assert cloud.shape == (n, 2) and cloud.dtype == torch.float64
    r = torch.linalg.vector_norm(cloud - 0.25, dim=-1).numpy()
    assert r.max() < 0.25
    per_chain = r.reshape(-1, C).mean(axis=0)  # row s * C + c: chain c
    se = per_chain.std(ddof=1) / math.sqrt(C)
    assert abs(r.mean() - _bump_mean_radius()) < 5 * se
    # the same generator state gives the same cloud
    assert torch.equal(cloud, sde.mcmc_init_cloud(_gen(0), n, (0.25, 0.25)))


def test_double_well_init_cloud():
    """x against the quadrature CDF (Kolmogorov-Smirnov), p ~ N(0, DW_T0)
    within 5 SE of its variance."""
    from vmc_pde_torch.models.latent import DW_T0, dw_x_quadrature

    n = 20000
    cloud = sde.double_well_init_cloud(_gen(2), n).numpy()
    xs, pdf = dw_x_quadrature()
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    x = np.sort(cloud[:, 0])
    F = np.interp(x, xs, cdf)
    ks = max((np.arange(1, n + 1) / n - F).max(),
             (F - np.arange(n) / n).max())
    assert ks < 2 / math.sqrt(n)
    assert abs(cloud[:, 1].var() - DW_T0) < 5 * math.sqrt(2 / n) * DW_T0
    assert abs(cloud[:, 1].mean()) < 5 * math.sqrt(DW_T0 / n)


def test_radial_functions_match_jax():
    r = np.linspace(0.0, 40.0, 101)
    for d in (2, 3, 8):
        assert radial.sphere_area(d) == jradial.sphere_area(d)
        assert rel_err(radial.gauss_radial(r, d, 1.5),
                       jradial.gauss_radial(r, d, 1.5)) < 1e-12
        for nu in (2.0, 5.5):
            assert rel_err(radial.student_t_radial(r, nu, d),
                           jradial.student_t_radial(r, nu, d)) < 1e-12
            assert abs(radial.student_t_entropy(nu, d)
                       - jradial.student_t_entropy(nu, d)) < 1e-12
    np.testing.assert_array_equal(
        radial.radial_faces(100.0, 0.1, r_core=5.0, growth=1.05),
        jradial.radial_faces(100.0, 0.1, r_core=5.0, growth=1.05))


@pytest.mark.parametrize("grid", [
    {"r_max": 30.0, "n_r": 200},
    {"faces": jradial.radial_faces(100.0, 0.1, r_core=5.0, growth=1.05)},
])
def test_evolve_radial_matches_jax(grid):
    """A coarse uniform grid (Gaussian start) and a graded one (Student-t
    start) to t_end 0.05: every output."""
    f0 = (partial(jradial.gauss_radial, d=8) if "n_r" in grid
          else partial(jradial.student_t_radial, nu=2.0, d=8))
    want = jradial.evolve_radial(f0, d=8, t_end=0.05, n_record=5, **grid)
    got = radial.evolve_radial(f0, d=8, t_end=0.05, n_record=5,
                               device="cpu", **grid)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert rel_err(got[key], want[key]) < 1e-12, key
    assert np.abs(got["mass"] - got["mass"][0]).max() < 1e-13


@pytest.mark.parametrize("block", [7, 10**6])
def test_graphed_chunk_split_matches_eager(monkeypatch, block):
    """The CUDA-graph path's split of each recording chunk (replays of a
    block of steps, then the remaining steps with the diagnostics; one
    block of the whole chunk when it is shorter), with the capture
    replaced by a direct call: every output equal to the eager run's."""
    monkeypatch.setattr(radial, "_capture", lambda fn, device: fn)
    monkeypatch.setattr(radial, "_GRAPH_STEPS", block)
    f0 = partial(radial.gauss_radial, d=8)
    kw = dict(d=8, r_max=30.0, n_r=200, t_end=0.05, n_record=3,
              device="cpu")
    want = radial.evolve_radial(f0, cuda_graph=False, **kw)
    got = radial.evolve_radial(f0, cuda_graph=True, **kw)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_oracle_cli_keys_and_shapes(tmp_path, capsys):
    """The port's CLI on diffusion2d on the CPU writes infos.hdf5 with the
    JAX CLI's keys and shapes (tests/test_diagnostics.py:119), prints the
    same lines, and its covariance grows as 1 + 2t within 5 SE."""
    assert CASES == JCASES
    n, wdir = 10000, str(tmp_path)
    args = ["diffusion2d", "--t-end", "0.5", "--workdir", wdir]
    joracle_main(["--particles", "2000"] + args)
    jout = capsys.readouterr().out
    want = jinfos.load_infos(os.path.join(wdir, "infos.hdf5"))
    oracle_main(["--particles", str(n), "--device", "cpu"] + args)
    out = capsys.readouterr().out
    assert ([line.split(":")[0] for line in out.splitlines()]
            == [line.split(":")[0] for line in jout.splitlines()])
    got = tinfos.load_infos(os.path.join(wdir, "infos.hdf5"))
    assert sorted(got) == sorted(want) == sorted(
        ["times", "x1", "covar", "integral_1sigma", "integral_0.5sigma",
         "integral_0.1sigma"])
    for key in want:
        assert got[key].shape == want[key].shape, key
    np.testing.assert_allclose(got["times"], want["times"], rtol=1e-12)
    var = 1 + 2 * got["times"][-1]
    assert (np.abs(np.diag(got["covar"][-1]) - var)
            < 5 * math.sqrt(2 / n) * var).all()


def test_load_infos_both_ways(tmp_path):
    """Each package reads the other's infos.hdf5, every dataset exactly."""
    infos = {"times": np.arange(4) * 0.1,
             "covar": normal((4, 3, 3), 1),
             "integral_0.5sigma": normal((4,), 2),
             "nan": np.zeros(4, dtype=bool)}
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    tinfos.store_infos(str(tmp_path / "a"), infos)
    jinfos.store_infos(str(tmp_path / "b"), infos)
    for got in (jinfos.load_infos(str(tmp_path / "a" / "infos.hdf5")),
                tinfos.load_infos(str(tmp_path / "b" / "infos.hdf5"))):
        assert sorted(got) == sorted(infos)
        for key, value in infos.items():
            np.testing.assert_array_equal(got[key], value)
            assert got[key].dtype == value.dtype
