"""The port's randomized QMC (vmc_pde_torch/sampling/qmc.py) against the
JAX package's sampling/qmc.py and scipy, on the CPU, and the --qmc path
through the latent, the flow and the driver.

Tolerances:
- Sobol and scrambled bits: bit for bit (the same integer operations);
  the scrambled nets on JAX's own words (jax.random.bits of its split
  keys, masked to the 30 bits both packages use).
- _mirrored_ndtri in f64: 1e-13 relative (the same 30-bit uniforms; only
  the two ndtri implementations differ, by ~1 ulp).
- chi2_from_bits: 1e-10 relative of JAX's plus the inversion's own
  conditioning, 16 eps u / (x pdf(x)), the relative change of x when
  P(k, x) moves by 16 ulp of u (it dominates at the 30-bit top extreme,
  where P = 1 - 4.7e-10 and both packages' lower gammainc carry only
  ~1e-7 of 1 - P: JAX itself misses scipy there by 2.7e-9 at nu = 1.05),
  for every nu, 50 included (the port's last Newton steps run on its own
  P(k, x), not on torch.special.gammainc, which errs 1.8e-9 relative at
  a = 25). Against scipy.stats.chi2.ppf: 1e-6 relative at both 30-bit
  extremes, as the JAX test holds.
- gammainc_f64 against scipy.special.gammainc: 16 eps (1 + s) relative,
  s = k |log x| + x + |lgamma k|, the size of the terms whose sum both
  exponentiate away from x ~ k (the density x^k e^-x / Gamma(k)); near
  x ~ k both take the Lanczos form and agree to a few ulps (scipy itself
  lies up to 5e-15 from a 40-digit mpmath value at k = 1/2).
- the latent draws on shared words: 1e-12 relative (f64; the same bits,
  then a triangular product and, for Student-t, the chi^2 above).
- the variance-reduction and moment gates are the JAX tests' own
  (tests/test_sampling.py:225-310).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special
from scipy.stats import chi2 as schi2
from scipy.stats import qmc as sqmc

from test_torch_models import rel_err
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.models import latent
from vmc_pde_torch.models.flow import build_flow
from vmc_pde_torch.sampling import qmc
from vmc_pde_tpu.models import latent as jlatent
from vmc_pde_tpu.sampling import qmc as jqmc

torch.set_num_threads(1)

MASK = (1 << 30) - 1
EXTREMES = np.array([0, 1, 2, 2**29 - 1, 2**29, 2**30 - 2, 2**30 - 1],
                    np.uint32)


def jax_words(key, dim):
    """The LMS words and the shift JAX's scrambled_bits(key, dim, n)
    draws, masked to 30 bits, as int32 tensors."""
    k_lms, k_shift = jax.random.split(key)
    lms = np.asarray(jax.random.bits(k_lms, (30, dim), dtype=jnp.uint32))
    shift = np.asarray(jax.random.bits(k_shift, (dim,), dtype=jnp.uint32))
    return (torch.from_numpy((lms & MASK).astype(np.int32)),
            torch.from_numpy((shift & MASK).astype(np.int32)))


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dim,n", [(16, 512), (33, 65)])
def test_sobol_bits_match_jax_and_scipy(dim, n):
    bits = qmc.sobol_bits(dim, n)
    assert bits.dtype == torch.int32 and bits.shape == (n, dim)
    assert np.array_equal(bits.numpy(),
                          np.asarray(jqmc.sobol_bits(dim, n)).astype(np.int32))
    ref = sqmc.Sobol(d=dim, scramble=False).random(n)
    assert np.array_equal(bits.numpy() / 2.0**30, ref)
    with pytest.raises(ValueError, match="2\\^30"):
        qmc._net(qmc._directions(dim, "cpu"), (1 << 30) + 1)


@pytest.mark.parametrize("dim,n", [(33, 4096), (5, 1000), (1, 64)])
def test_scrambled_bits_match_jax_on_its_words(dim, n):
    key = jax.random.PRNGKey(dim)
    got = qmc.scrambled_bits_from_words(n, *jax_words(key, dim))
    want = np.asarray(jqmc.scrambled_bits(key, dim, n)).astype(np.int32)
    assert np.array_equal(got.numpy(), want)


def test_scrambled_net_property_on_the_ports_generator():
    """The LMS + shift keeps the (0, m, 1)-net property of every 1-D
    projection: the first 2^m points fill each dyadic cell of width 2^-m
    once, at every level j <= m; a generator state fixes the net, a fresh
    one draws another."""
    b1 = qmc.scrambled_bits(gen(0), 4, 64)
    assert torch.equal(b1, qmc.scrambled_bits(gen(0), 4, 64))
    assert not torch.equal(b1, qmc.scrambled_bits(gen(1), 4, 64))
    assert int(b1.min()) >= 0 and int(b1.max()) < 2**30
    for seed in range(4):
        b = qmc.scrambled_bits(gen(seed), 6, 64).numpy()
        for j in (1, 2, 3, 6):
            for col in (b >> (30 - j)).T:
                np.testing.assert_array_equal(
                    np.bincount(col, minlength=2**j), 64 // 2**j)


def test_mirrored_ndtri_matches_jax():
    bits = np.concatenate([np.asarray(jqmc.scrambled_bits(
        jax.random.PRNGKey(3), 8, 4096)).reshape(-1), EXTREMES])
    want = np.asarray(jqmc._mirrored_ndtri(jnp.asarray(bits), jnp.float64))
    got = qmc._mirrored_ndtri(torch.from_numpy(bits.astype(np.int32)),
                              torch.float64)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()
    assert (np.abs(got.numpy() - want) <= 1e-13 * np.abs(want)).all()
    # both tails reach |z| ~ 6.1 sigma, symmetric on the mirrored grid
    assert got[-7] == -got[-1] and float(got[-1]) > 6.0


@pytest.mark.parametrize("nu", [1.05, 2.0, 2.5, 8.0, 50.0])
def test_chi2_from_bits_matches_jax_and_scipy(nu):
    bits = np.concatenate([np.asarray(jqmc.scrambled_bits(
        jax.random.PRNGKey(4), 1, 4096))[:, 0], EXTREMES])
    want = np.asarray(jqmc.chi2_from_bits(jnp.asarray(bits), nu,
                                          dtype=jnp.float64))
    got = qmc.chi2_from_bits(torch.from_numpy(bits.astype(np.int32)), nu,
                             dtype=torch.float64).numpy()
    u = (bits.astype(np.float64) + 0.5) * 2.0**-30
    cond = 16 * np.finfo(np.float64).eps * u / (want * schi2.pdf(want, nu))
    tol = 1e-10 + cond
    err = np.abs(got - want) / want
    assert (err <= tol).all(), (err.max(), bits[np.argmax(err / tol)])
    exact = schi2.ppf((EXTREMES.astype(np.float64) + 0.5) * 2.0**-30, nu)
    np.testing.assert_allclose(got[-7:], exact, rtol=1e-6)
    # the f32 draws are the f64 inversion cast
    got32 = qmc.chi2_from_bits(torch.from_numpy(bits.astype(np.int32)), nu)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, torch.from_numpy(got).float())


@pytest.mark.parametrize("k", [0.5, 1.25, 25.0, 50.0])
def test_gammainc_f64_matches_scipy(k):
    """P(k, x) at 2000 points across [1e-3 k, 5 k] plus the switch at
    x = k + 1, for a number and a 0-dim tensor k: within 16 eps (1 + s)
    of scipy (module docstring)."""
    x = np.concatenate([np.geomspace(1e-3 * k, 5 * k, 2000),
                        k + 1 + np.array([-1e-12, 0.0, 1e-12])])
    want = special.gammainc(k, x)
    s = k * np.abs(np.log(x)) + x + abs(math.lgamma(k))
    tol = 16 * np.finfo(np.float64).eps * (1 + s)
    for kk in (k, torch.tensor(k, dtype=torch.float64)):
        got = qmc.gammainc_f64(kk, torch.from_numpy(x)).numpy()
        err = np.abs(got - want) / want
        assert (err <= tol).all(), (err.max(), x[np.argmax(err / tol)])
    # near the mode both use the Lanczos form: a few ulps
    near = np.abs(x - k) <= 0.4 * k
    assert (np.abs(got - want)[near] <= 8e-15 * want[near]).all()


@pytest.mark.parametrize("nu", [1.05, 8.0])
def test_chi2_draws_equidistribute(nu):
    """The 1-D net's chi^2 draws: KS distance at the 1/n floor (the JAX
    test's gate)."""
    w = qmc.chi2(gen(3), nu, 4000, dtype=torch.float64).numpy()
    cdf = np.sort(schi2.cdf(w, nu))
    assert np.abs(cdf - (np.arange(4000) + 0.5) / 4000).max() < 2e-3


def test_qmc_normal_variance_reduction():
    """RQMC beats MC by a wide margin on a smooth latent expectation
    (d=8, n=2048, 16 randomizations each); the JAX test's 3x gate."""
    d, n = 8, 2048

    def stat(z):
        z = z.numpy()
        return float(np.mean(np.exp(-0.5 * np.sum(z**2, axis=1) / d)
                             * (1.0 + np.sum(z, axis=1) / d)))

    qs = [stat(qmc.normal(gen(100 + s), n, d, torch.float64))
          for s in range(16)]
    ms = [stat(torch.randn((n, d), generator=gen(200 + s),
                           dtype=torch.float64)) for s in range(16)]
    assert np.std(qs) < np.std(ms) / 3.0
    u = qmc.uniform(gen(5), n, d, torch.float64)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0


def _latent_params(name, dim, seed=0, nu=6.0):
    rng = np.random.default_rng(seed)
    lp = {"L": 0.3 * rng.standard_normal(dim * (dim - 1) // 2),
          "L_diag": 0.2 * rng.standard_normal(dim),
          "mu": rng.standard_normal(dim),
          "dist_params": (np.array([np.log(nu - 1.0)])
                          if name == "Student_t" else np.zeros(0))}
    return ({k: torch.from_numpy(v) for k, v in lp.items()},
            {k: jnp.asarray(v) for k, v in lp.items()})


def test_qmc_gauss_latent_matches_target_tightly():
    """latent.sample(qmc=True) draws from N(mu, S), its moments far inside
    the MC noise band at the same budget (the JAX test's gates)."""
    dim, n = 4, 4096
    lp, _ = _latent_params("Gauss", dim)
    U = latent.chol_factor(lp, dim)
    z = latent.sample("Gauss", gen(0), lp, dim, n, torch.float64,
                      qmc=True).numpy()
    assert np.abs(z.mean(0) - lp["mu"].numpy()).max() < 5e-3
    assert np.abs(np.cov(z.T, ddof=0) - (U @ U.T).numpy()).max() < 8e-3


def test_qmc_student_t_latent():
    """Student-t on the joint (dim + 1)-column net: covariance S nu /
    (nu - 2), heavy tails (kurtosis above the Gaussian's)."""
    dim, n, nu = 4, 8192, 6.0
    lp = {k: torch.from_numpy(v) for k, v in
          latent.init_params(dim, "Student_t").items()}
    lp["dist_params"] = torch.tensor([np.log(nu - 1.0)])
    z = latent.sample("Student_t", gen(1), lp, dim, n, torch.float64,
                      qmc=True).numpy()
    assert np.isfinite(z).all()
    np.testing.assert_allclose(np.cov(z.T, ddof=0),
                               np.eye(dim) * nu / (nu - 2.0), atol=0.2)
    assert ((z**4).mean(0) / (z**2).mean(0) ** 2 > 4.0).all()


@pytest.mark.parametrize("name", ["Gauss", "Student_t"])
def test_latent_sample_matches_jax_on_shared_words(name, monkeypatch):
    """latent.sample(qmc=True) and, for Student-t, the tempered proposal
    (z and log_w) on the words JAX's key gives: 1e-12 relative."""
    dim, n = 5, 1024
    lp, jlp = _latent_params(name, dim, seed=2, nu=2.5)
    key = jax.random.PRNGKey(11)
    k_eps = jax.random.split(key)[0]
    monkeypatch.setattr(qmc, "draw_words",
                        lambda g, d, device=None: jax_words(k_eps, d))
    want = np.asarray(jlatent.sample(name, key, jlp, dim, n,
                                     dtype=jnp.float64, qmc=True))
    got = latent.sample(name, gen(0), lp, dim, n, torch.float64, qmc=True)
    assert rel_err(got, want) < 1e-12, rel_err(got, want)
    if name == "Student_t":
        jz, jlw = jlatent.student_t_tempered_sample(
            key, jlp, dim, n, 0.6, dtype=jnp.float64, qmc=True)
        z, log_w = latent.student_t_tempered_sample(
            gen(0), lp, dim, n, 0.6, torch.float64, qmc=True)
        assert rel_err(z, jz) < 1e-12 and rel_err(log_w, jlw) < 1e-12
        assert float(log_w.max()) < 2.0  # the proposal dominates


def test_qmc_flow_flag_and_driver(tmp_path):
    """Flow(qmc=True) changes the draw and the tempered draw inherits it;
    --qmc through driver.main on the CPU sets it for the exact latents
    only, and the QMC entropy of mwe sits nearer its closed form
    log(2 pi e) than the PRNG run's at the same budget."""
    flow_mc, theta = build_flow(0, 2, latent_name="Student_t",
                                dtype=torch.float64)
    flow_q = build_flow(0, 2, latent_name="Student_t", dtype=torch.float64,
                        qmc=True)[0]
    params = flow_mc.layout.unravel(theta)
    z_mc = flow_mc.latent_sample(gen(2), params, 256, torch.float64)
    z_q = flow_q.latent_sample(gen(2), params, 256, torch.float64)
    assert not torch.allclose(z_mc, z_q)
    z, log_w = flow_q.latent_sample_tempered(gen(2), params, 256, 0.6,
                                             torch.float64)
    assert torch.isfinite(log_w).all() and float(log_w.max()) < 2.0

    entropy = {}
    for flag in ([], ["--qmc"]):
        state, rec = driver.main(["mwe", "--device", "cpu", "--precision",
                                  "f64", "--samples", "1024",
                                  "--max-steps", "2"] + flag)
        assert state.flow.qmc == bool(flag)
        entropy[bool(flag)] = rec.as_arrays()["entropy"][0]
    exact = np.log(2 * np.pi * np.e)
    assert abs(entropy[True] - exact) < abs(entropy[False] - exact)
    assert abs(entropy[True] - exact) < 2e-3
    cfg = preset("fluidpaper", device="cpu", qmc=True)
    assert not driver.build_problem(cfg)[0].flow.qmc
