"""The port's solvers and Gram precisions against the JAX package, on the
CPU: matrix-free CG, direct and streaming minSR, the host f64 solve, the
gram_precision modes and their refusals, and the CLI's --solver,
--gram-precision and --host-solve flags end to end.

The problems are test_torch_tdvp.py's (DIM=4, N=64, f64, svd_tol=1e-6,
shared latent draws). Tolerances (relative to the largest value):
- 1e-8 for the update and the diagnostics of the same solver in both
  packages: the statistics agree to ~1e-13 and the solves take different
  LAPACK paths (test_torch_tdvp.py). CG runs the same iteration step for
  step (1e-12 after 3 iterations); converged, its results agree to 1e-8.
- CG against the port's Cholesky: the JAX test's setting and gates
  (tests/test_tdvp.py:215-239): cosine > 0.999, 2e-2 on the update, 3e-2
  on lambda_max (power iteration against the Ritz value).
- streaming minSR against direct minSR: the JAX test's rtol 2e-4 on the
  update (the regularized kernel inverse amplifies the last bits of T up
  to ~1/svd_tol on threshold modes) and 1e-7 on the spectrum.
- f64 and f64acc statistics of an f32 compute path: 1e-5, the f32
  rounding of the O rows the two packages compute (their f64 products
  then add nothing).
- sym2_outer_sum: test_torch_stats.py's 1e-6 for sums of exact bf16
  products.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import normal, parity_flow, rel_err, t64
from test_torch_tdvp import DIM, N, _problem
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops import evolution
from vmc_pde_torch.parallel import stats
from vmc_pde_torch.sampling.sampler import Sampler
from vmc_pde_torch.solver import tdvp as tdvp_mod
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel import stats as jstats
from vmc_pde_tpu.parallel.mesh import ParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision

torch.set_num_threads(1)


def _jax_aux(jtdvp, theta, t, z):
    """One fused JAX RHS on the latent draws z, as numpy (None stays)."""
    aux = jtdvp._fused(jnp.asarray(np.asarray(theta)), t,
                       jax.random.PRNGKey(0), jnp.asarray(z), None, None,
                       None, n=N, n_obs=N, with_obs=True)
    return {k: None if v is None else np.asarray(v) for k, v in aux.items()}


def _compare(aux, jaux, keys, tol=1e-8):
    for k in keys:
        assert rel_err(aux[k], jaux[k]) < tol, (k, rel_err(aux[k], jaux[k]))


def _cos_rel(u, ref):
    u, ref = np.asarray(u, np.float64), np.asarray(ref, np.float64)
    cos = u @ ref / (np.linalg.norm(u) * np.linalg.norm(ref))
    return cos, np.linalg.norm(u - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("cfg,tol", [
    (dict(cg_maxiter=3), 1e-12),
    (dict(svd_tol=1e-4, cg_maxiter=600, cg_tol=1e-10), 1e-8)])
def test_cg_rhs_matches_jax(cfg, tol):
    """The cg RHS: the same Jacobi-preconditioned iteration, the power-
    iteration lambda_max and the residual against the unregularized S.
    After 3 iterations step for step; then converged (254 iterations).
    Unconverged at svd_tol 1e-6 (condition ~1e6, E_loc ~1e5) the two
    packages' iterates part at ~1e-5 after 20 iterations: CG's rounding
    grows with the iteration count there."""
    jtdvp, tdvp, theta = _problem("affine", solver_method="cg", **cfg)
    assert tdvp.solver_method == "cg" and not tdvp.cfg.compute_snr
    z = normal((N, DIM), 51)
    jaux = _jax_aux(jtdvp, theta, 0.2, z)
    aux = tdvp._rhs_impl(theta, 0.2, 0, t64(z))
    _compare(aux, jaux, ("update", "lambda_max", "solver_res", "tdvp_error",
                         "eloc_mean", "eloc_var", "entropy"), tol)
    assert "ev" not in aux
    assert 0 < int(aux["_cg_iters"]) <= cfg["cg_maxiter"]


def test_cg_matches_cholesky():
    """CG against the port's Tikhonov-Cholesky on the same draws, on the
    JAX test's problem and setting (mwe in f64, N=4096, svd_tol 1e-5, 600
    iterations, cg_tol 1e-10)."""
    out = {}
    for method, extra in (("cholesky", {}), ("cg", dict(cg_maxiter=600,
                                                        cg_tol=1e-10))):
        state, t = driver.build_problem(preset(
            "mwe", device="cpu", precision="f64", solver_method=method,
            svd_tol=1e-5, n_samples_tdvp=4096, n_samples_obs=4096,
            **extra))[:2]
        out[method] = t.rhs(state.get_parameters(), 0.0, 31)
    (u_c, a_c), (u_g, a_g) = out["cholesky"], out["cg"]
    cos, rel = _cos_rel(u_g, u_c)
    assert cos > 0.999 and rel < 2e-2, (cos, rel)
    assert float(a_g["solver_res"]) < 1e-3
    assert rel_err(a_g["lambda_max"], a_c["lambda_max"]) < 3e-2


def test_cg_stops_on_the_device():
    """The iteration freezes once r.r <= tol^2 b.b, so reading the flag
    once per block of iterations gives what stopping at once gives; the
    host reads it once per CG_CHECK_EVERY iterations."""
    rng = np.random.default_rng(4)
    B = torch.from_numpy(rng.standard_normal((40, 40)))
    A = B @ B.T + 40 * torch.eye(40, dtype=torch.float64)
    b = torch.from_numpy(rng.standard_normal(40))
    x1, k1 = tdvp_mod._cg(lambda v: A @ v, b, lambda r: r / A.diagonal(),
                          1e-10, 200, check_every=1)
    x16, k16 = tdvp_mod._cg(lambda v: A @ v, b, lambda r: r / A.diagonal(),
                            1e-10, 200)
    assert torch.equal(x1, x16) and int(k1) == int(k16) < 200
    assert float(torch.linalg.norm(A @ x16 - b) / torch.linalg.norm(b)) \
        < 1e-9


def test_minsr_direct_matches_jax():
    """Direct minSR in the underdetermined case (P = 150 > N = 64): the
    update, the full N-long spectrum, the SNR of the live modes, the
    kernel-space residual and TDVP error."""
    jtdvp, tdvp, theta = _problem("affine", solver_method="minsr")
    assert tdvp.n_params > N
    z = normal((N, DIM), 52)
    jaux = _jax_aux(jtdvp, theta, 0.1, z)
    aux = tdvp._rhs_impl(theta, 0.1, 0, t64(z))
    assert aux["ev"].shape == (N,)
    _compare(aux, jaux, ("update", "ev", "solver_res", "tdvp_error",
                         "eloc_mean", "entropy"))
    live = jaux["ev"] > 1e-8 * jaux["ev"][-1]
    assert rel_err(aux["snr"].numpy()[live], jaux["snr"][live]) < 1e-8


def test_minsr_streaming_matches_jax_and_direct():
    """Streaming minSR (4 chunks of 16) against JAX's streaming minSR on
    the same draws, and against the port's direct minSR."""
    jtdvp, tdvp, theta = _problem("affine", solver_method="minsr",
                                  chunk_size=16)
    direct = _problem("affine", solver_method="minsr")[1]
    z = normal((N, DIM), 53)
    jaux = _jax_aux(jtdvp, theta, 0.1, z)
    aux = tdvp._rhs_impl(theta, 0.1, 0, t64(z))
    _compare(aux, jaux, ("update", "ev", "solver_res", "tdvp_error"))
    ref = direct._rhs_impl(theta, 0.1, 0, t64(z))
    u, u_d = aux["update"].numpy(), ref["update"].numpy()
    assert np.abs(u - u_d).max() <= 2e-4 * np.abs(u_d).max() + 1e-7
    assert np.abs(aux["ev"].numpy() - ref["ev"].numpy()).max() <= \
        1e-7 * float(ref["ev"].abs().max()) + 1e-12


def test_sym2_outer_sum_matches_jax():
    """minSR's two-pass T on the same f32 data (256 x 130), and its
    symmetry."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((256, 130)).astype(np.float32)
    got = stats.sym2_outer_sum(torch.from_numpy(X)).numpy()
    want = np.asarray(jstats.sym2_outer_sum(jnp.asarray(X)))
    assert got.shape == (256, 256)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(got - X.astype(np.float64) @ X.T.astype(np.float64)) \
        .max() <= 2e-3 * np.abs(want).max()


def _f32_problems(mode, chunk=0, n=N):
    """A port and a JAX TDVP with f32 compute (the 'tpu' policy) and
    gram_precision ``mode`` on the JAX package's f64acc test problem: the
    near-initial d=4 flow of depth 4 (output weights 1e-5) and diffusion."""
    jflow, jparams, flow, theta = parity_flow("scale", dim=DIM, depth=4,
                                              hidden=(2,), seed=1,
                                              out_scale=1e-5)
    ctx = ParallelCtx.single_device()
    jprec = JPrecision.tpu_default()
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=DIM, ctx=ctx, name="Gauss",
                                        dtype=jnp.float32))
    jt = JTDVP(jstate, jevolution.make_equation("diffusion", DIM),
               JTDVPConfig(gram_precision=mode, chunk_size=chunk),
               n_samples=n, precision=jprec)
    prec = Precision.tpu_default()
    state = VarState(flow, theta.float(),
                     sampler=Sampler(DIM, dtype=torch.float32),
                     precision=prec)
    t = TDVP(state, evolution.make_equation("diffusion", DIM),
             TDVPConfig(gram_precision=mode, chunk_size=chunk),
             n_samples=n, precision=prec)
    return jt, t, theta.float()


@pytest.mark.parametrize("mode,chunk", [
    ("highest", 0), ("high", 0), ("default", 0), ("f64", 0), ("f64acc", 16),
    ("high", 16)])
def test_tolerance_floors_match_jax(mode, chunk):
    """auto_tol_floor takes eps of the statistics' dtype: f32 for
    highest/high/default, f64 for f64, f32's / sqrt(n / chunk) for
    f64acc."""
    jt, t, _ = _f32_problems(mode, chunk)
    assert t.cfg.svd_tol == jt.cfg.svd_tol
    assert t.cfg.eig_cutoff == jt.cfg.eig_cutoff
    eps = {"f64": np.finfo(np.float64).eps,
           "f64acc": np.finfo(np.float32).eps / 2.0}.get(
               mode, np.finfo(np.float32).eps)
    assert t.cfg.svd_tol == max(1e-11, 64 * eps)


@pytest.mark.parametrize("mode,chunk", [("f64", 0), ("f64acc", 16)])
def test_f64_statistics_match_jax(mode, chunk):
    """S0 and F0 of the f64 precisions on an f32 compute path, direct and
    chunked, against the JAX package's on the same samples, in f64."""
    jt, t, theta32 = _f32_problems(mode, chunk)
    params = t.flow.layout.unravel(theta32)
    x = t.flow.push(params, torch.from_numpy(
        normal((N, DIM), 54).astype(np.float32)))[0].numpy()
    fn, jfn = ((t._chunked_stats, jt._chunked_stats) if chunk
               else (t._direct_stats, jt._direct_stats))
    st = fn(theta32, 0.0, torch.from_numpy(x))
    jst = jax.jit(jfn)(jnp.asarray(theta32.numpy()), 0.0, jnp.asarray(x))
    for k in ("S0", "F0"):
        assert st[k].dtype == torch.float64, k
        assert rel_err(st[k], jst[k]) < 1e-5, (k, rel_err(st[k], jst[k]))


def _chunked_S0_on_shared_rows(chunk, n=8192, jax_too=False):
    """S0 of the chunked statistics under f64acc, high and f64 on one
    batch (the JAX package's f64acc test problem), every mode contracting
    the same O rows, made once: each chunk's call reads its rows of one
    evaluation. Returns (S0 by mode, the JAX package's S0 by mode on the
    same samples if ``jax_too``, the rows, the svd_tols)."""
    probs = {mode: _f32_problems(mode, chunk, n=n)
             for mode in ("f64acc", "high", "f64")}
    t_acc = probs["f64acc"][1]
    theta = t_acc.state.theta
    params = t_acc.flow.layout.unravel(theta)
    z = t_acc.flow.latent_sample(torch.Generator().manual_seed(3), params,
                                 n, torch.float32)
    x, _ = t_acc.flow.push(params, z)
    rows = t_acc._per_sample_batch(theta, x, 0.0)

    def per_sample(theta_c, xc, t):
        i = (xc.data_ptr() - x.data_ptr()) // (x.stride(0) * x.element_size())
        return tuple(v[i:i + xc.shape[0]] for v in rows)

    S, JS = {}, {}
    for mode, (jt, t, _) in probs.items():
        t._per_sample_batch = per_sample
        S[mode] = t._chunked_stats(theta, 0.0, x)["S0"]
        del t._per_sample_batch
        if jax_too:
            JS[mode] = torch.from_numpy(np.array(jax.jit(jt._chunked_stats)(
                jnp.asarray(theta.numpy()), 0.0, jnp.asarray(x.numpy()))[
                    "S0"], np.float64))
    tols = {mode: t.cfg.svd_tol for mode, (_, t, _) in probs.items()}
    return S, JS, rows, tols


def _s0_errors(S):
    """(err f64acc, err high): max |S0 - S0_f64| of each."""
    ref = S["f64"].double()
    return (float((S["f64acc"].double() - ref).abs().max()),
            float((S["high"].double() - ref).abs().max()))


def test_f64acc_between_high_and_f64():
    """The JAX package's ordering test on its problem at n = 8192, in
    chunks of 64: the f64-accumulated statistics sit at least 4x closer to
    the f64 ones than the f32-accumulated ones do, at the same per-chunk
    numerics (an RHS on them: test_split_backends_admit_high_and_f64acc).
    The JAX test's chunks of 256: test_f64acc_chunks_of_256."""
    S, _, _, tols = _chunked_S0_on_shared_rows(64)
    assert tols["f64acc"] < tols["high"]
    assert S["f64acc"].dtype == S["f64"].dtype == torch.float64
    err_acc, err_hi = _s0_errors(S)
    assert err_acc < err_hi / 4, (err_acc, err_hi)
    assert err_acc < 1e-6 * float(S["f64"].abs().max())


def test_f64acc_chunks_of_256():
    """The JAX test's shape, chunks of 256, measures where the port's
    f64acc error comes from. On the same samples and O rows:

    - the cross-chunk f32 accumulation is the JAX package's: the 'high'
      statistics miss the f64 ones by the same amount in both packages
      (4.48e-5 against 4.51e-5, within 20% here), so the chunk loop is
      not at fault;
    - torch's f32 product on the CPU errs more per chunk than XLA's on
      identical f32 operands, against their f64 product (3.0x in the mean
      of the 32 chunks, 0.032 against 0.011 of a largest entry of 5.1e4;
      more than 1.5x here);
    - so f64acc, which keeps only the per-chunk error, misses f64 by 2.0e-5
      in the port against 6.9e-6 in the JAX package, and sits 2.2x closer
      to f64 than 'high' (the JAX package 6.6x). The gate here is 1.5x;
      the 4x of chunks of 64 (above) stands, where the cross-chunk sum
      weighs more."""
    n, chunk = 8192, 256
    S, JS, rows, _ = _chunked_S0_on_shared_rows(chunk, n, jax_too=True)
    err_acc, err_hi = _s0_errors(S)
    jerr_acc, jerr_hi = _s0_errors(JS)
    assert 0.8 < err_hi / jerr_hi < 1.25, (err_hi, jerr_hi)
    O = rows[2]
    Os = O - O[:chunk].mean(0)
    e_torch, e_xla = [], []
    for i in range(0, n, chunk):
        A = Os[i:i + chunk]
        ref = A.double().T @ A.double()
        xla = np.array(jnp.matmul(jnp.asarray(A.numpy()).T,
                                  jnp.asarray(A.numpy()),
                                  precision=jax.lax.Precision.HIGHEST))
        e_torch.append(float(((A.T @ A).double() - ref).abs().max()))
        e_xla.append(float((torch.from_numpy(xla).double() - ref).abs()
                           .max()))
    assert np.mean(e_torch) > 1.5 * np.mean(e_xla), (e_torch, e_xla)
    assert err_acc > jerr_acc, (err_acc, jerr_acc)
    assert err_acc < err_hi / 1.5, (err_acc, err_hi)
    assert jerr_acc < jerr_hi / 4, (jerr_acc, jerr_hi)


def test_default_is_high_on_the_cpu():
    """gram_precision='default' is the f32 product on the CPU, as the JAX
    package's DEFAULT is on its CPU backend: the RHS equals 'high''s bit
    for bit."""
    _, t_def, theta = _f32_problems("default")
    theta = theta.double()
    _, t_hi, _ = _f32_problems("high")
    a = t_def.rhs(theta, 0.0, 7)[0]
    b = t_hi.rhs(theta, 0.0, 7)[0]
    assert torch.equal(a, b)
    x = torch.randn(5, 3, dtype=torch.float32)
    assert torch.equal(stats.contract(x.T, x, "default"), x.T @ x)


@pytest.mark.parametrize("method", ["eigh", "cholesky"])
def test_host_solve_matches_jax_and_device(method):
    """The host f64 solve (numpy eigh with the regularizers, or Tikhonov
    by np.linalg.solve with lambda_max = ||S||_2 at P <= 512) against the
    JAX package's host solve on the same draws, and against the port's
    device solve of the same statistics (the Cholesky one at the host's
    lambda_max)."""
    cfg = dict(solver_method=method, solve_on_device=False)
    jtdvp, tdvp, theta = _problem("affine", **cfg)
    assert not tdvp.fused_steps_available
    z = normal((N, DIM), 55)
    jaux = _jax_aux(jtdvp, theta, 0.3, z)
    jout = jtdvp._host_solve(dict(jaux))
    aux = tdvp._rhs_impl(theta, 0.3, 0, t64(z))
    assert aux["S"].shape == (tdvp.n_params,) * 2
    aux.update(tdvp._host_solve(aux))
    assert "S" not in aux and not bool(aux["nan"])
    keys = ("update", "solver_res", "tdvp_error") + (
        ("ev",) if method == "eigh" else ("lambda_max",))
    _compare(aux, jout, keys)
    # the device solve of the port's own statistics on the same samples,
    # the Cholesky one at the host's lambda_max
    x = tdvp.flow.push(tdvp.flow.layout.unravel(theta), t64(z))[0]
    st = tdvp._direct_stats(theta, 0.3, x)
    if method == "eigh":
        u = tdvp_mod._solve_regularized(st["S0"], st["F0"], tdvp.cfg, N,
                                        A=st["A"])[0]
    else:
        u = tdvp_mod._solve_cholesky(st["S0"], st["F0"], tdvp.cfg,
                                     lam_max=aux["lambda_max"])[0]
    assert rel_err(aux["update"], u) < 1e-8
    with pytest.raises(ValueError, match="fused_steps_available"):
        tdvp.heun_pair(theta, 0.0, 1e-4, 3)


def _port_state(latent_name="Gauss", dtype=torch.float64):
    _, _, flow, theta = parity_flow("affine", dim=DIM, seed=21,
                                    latent_name=latent_name)
    return VarState(flow, theta, sampler=Sampler(DIM, latent_name,
                                                 dtype=dtype),
                    precision=Precision.f64_everywhere())


@pytest.mark.parametrize("latent,cfg,match", [
    ("Gauss", dict(solver_method="cg", chunk_size=16), "materialized"),
    ("Gauss", dict(solver_method="cg", solve_on_device=False),
     "device only"),
    ("Gauss", dict(solver_method="minsr", solve_on_device=False),
     "device only"),
    ("Gauss", dict(solver_method="minsr", compute_sexp=True), "SExp"),
    ("Gauss", dict(solver_method="minsr", sexp_mode="dense"), "SExp"),
    ("Gauss", dict(solver_method="minsr", diagonal_shift=0.01),
     "diagonal_shift"),
    ("Gauss", dict(gram_precision="f64acc"), "CHUNKED"),
    ("Gauss", dict(gram_precision="f64acc", chunk_size=16,
                   solver_method="minsr"), "Gram-based"),
    ("Gauss", dict(gram_precision="fp8"), "unknown gram_precision"),
    ("Gauss", dict(solver_method="lsqr"), "unknown solver_method"),
    ("Gauss", dict(solver_method="cholesky", use_snr=True,
                   solve_on_device=False), "Ritz"),
    ("Student_t", dict(is_gamma=0.5, solver_method="cg"), "direct"),
    ("Student_t", dict(is_gamma=0.5, solver_method="minsr"), "direct"),
])
def test_new_refusals(latent, cfg, match):
    """The JAX package's ValueErrors of the cg, minsr, host-solve and
    precision paths."""
    with pytest.raises(ValueError, match=match):
        TDVP(_port_state(latent), evolution.make_equation("diffusion", DIM),
             TDVPConfig(**cfg), n_samples=N)


@pytest.mark.parametrize("backend,mode,ok", [
    ("tri2", "f64acc", True), ("sym2", "f64acc", True),
    ("syrk", "f64acc", True), ("tri2", "default", False),
    ("sym2", "f64", False), ("syrk", "highest", False)])
def test_split_backends_admit_high_and_f64acc(backend, mode, ok):
    """The split backends implement the f32 statistics at 'high' numerics
    and admit f64acc (their chunks add into f64); any other precision is
    refused, as in the JAX package."""
    state = _port_state(dtype=torch.float32)
    state = VarState(state.flow, state.theta, sampler=state.sampler,
                     precision=Precision.tpu_default())
    cfg = TDVPConfig(gram_backend=backend, gram_precision=mode,
                     chunk_size=16)
    eq = evolution.make_equation("diffusion", DIM)
    if ok:
        t = TDVP(state, eq, cfg, n_samples=N)
        _, aux = t.rhs(state.get_parameters(), 0.0, 3)
        assert not bool(aux["nan"])
    else:
        with pytest.raises(ValueError, match="gram_precision='high'"):
            TDVP(state, eq, cfg, n_samples=N)


def test_cg_warnings():
    """cg turns the SNR and the SExp off, with the JAX package's two
    warnings."""
    state = _port_state()
    eq = evolution.make_equation("diffusion", DIM)
    with pytest.warns(UserWarning, match="SExp matrix"):
        t = TDVP(state, eq, TDVPConfig(solver_method="cg",
                                       compute_sexp=True), n_samples=N)
    assert not (t.cfg.compute_sexp or t.cfg.compute_snr)
    with pytest.warns(UserWarning, match="DISABLED"):
        t = TDVP(state, eq, TDVPConfig(solver_method="cg", use_snr=True),
                 n_samples=N)
    assert not t.cfg.use_snr


@pytest.mark.parametrize("flags,tol", [
    (["--solver", "cg"], 1e-6), (["--solver", "minsr"], 1e-12),
    (["--solver", "minsr", "--chunk-size", "256"], 1e-12),
    (["--host-solve"], 1e-12), (["--gram-precision", "f64"], 1e-12)])
def test_cli_solver_flags(tmp_path, flags, tol):
    """The CLI on mwe in f64 with 512 samples: the residual, and
    infos.hdf5 with lambda_max and no SExp/ev for cg, the N-long ev and
    snr for minsr (when h5py is there)."""
    _, rec = driver.main(["mwe", "--device", "cpu", "--precision", "f64",
                          "--samples", "512", "--max-steps", "3",
                          "--workdir", str(tmp_path)] + flags)
    a = rec.as_arrays()
    assert a["solver_res"].max() < tol and not a["nan"].any()
    assert 2.8 < a["entropy"][-1] < 2.9
    if flags[-1] == "cg":
        assert "lambda_max" in a and "ev" not in a
    if "minsr" in flags:
        assert a["ev"].shape == (3, 512) and a["snr"].shape == (3, 512)
    try:
        import h5py
    except ImportError:
        return
    with h5py.File(tmp_path / "infos.hdf5") as f:
        assert "solver_res" in f and "SExp" not in f
        assert ("lambda_max" in f) == (flags[-1] == "cg")


@pytest.mark.parametrize("solver", ["cg", "minsr"])
def test_adaptive_heun_with_gram_free_solvers(solver):
    """Adaptive Heun with cg and minsr takes the matrix-free S metric and
    grows dt past dt0 (the JAX package's test_adaptive_stepper_large_p_
    solvers, cut to 256 samples and 5 steps)."""
    cfg = preset("mwe", device="cpu", precision="f64", stepper="adaptive_heun",
                 solver_method=solver, n_samples_tdvp=256,
                 n_samples_obs=256, dt0=1e-4, tol=1e-2, max_step=5e-2,
                 verbose=False)
    tdvp = driver.build_problem(cfg)[1]
    assert tdvp._sexp_matfree and not tdvp.cfg.compute_sexp
    _, rec = driver.run(cfg, max_steps=5)
    a = rec.as_arrays()
    assert a["dt"][-1] > 1e-3 and math.isfinite(a["step_error"].max())
    assert not a["nan"].any()
