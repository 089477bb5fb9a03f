"""TDVP right-hand side, the counterpart of vmc_pde_tpu/solver/tdvp.py:
exact latent sampling (with the tail-tempered Student-t importance
proposal of ``is_gamma``) or Metropolis chains carried across right-hand
sides, direct statistics (self-normalized importance-weighted under
``is_gamma``, E_loc winsorized under ``eloc_clip``) or chunked statistics,
with the f32, syrk, sym2 or tri2 Gram and the bf16 or int8 cross term
(parallel/stats.py, kernels/syrk.py) at any ``gram_precision`` (the f64
operands of ``f64``, the f64 accumulators of ``f64acc``, the one-pass
``default``); the spectral eigh or the Tikhonov-Cholesky solve, on the
device or on the host in f64 (``solve_on_device=False``), or the two
Gram-free solvers: matrix-free conjugate gradients (``cg``) and the
kernel-space minSR (``minsr``, direct or streaming over chunks);
observables, the fused integrator steps (the fixed Heun pair, the SSPRK3
triple, the adaptive Heun and Bogacki-Shampine attempts) and the adaptive
steppers' S metric: the dense SExp = E[logp^2 O_c^T O_c] beside the other
moments, or the matrix-free quadratic v^T SExp v from the per-sample O
rows.

One right-hand side (RHS): draw latent z (exact draws, or n / n_chains
sweeps of the Metropolis chains), push it through the inverse flow to
samples x; per sample logp, score g, Hessian quadratic trace and
the O row (kernels/persample.py: the CUDA kernel on the card, the
torch.func pipeline otherwise), or under ``hessian_mode`` "block" the
(k, k) Hessian block by torch.func (ops/score.py); E_loc from the
equation; the force
F = E[e_c O_c] and Gram S = E[O_c^T O_c] of the centered quantities (plus
A = E[e_c^2 O_c^T O_c] for the per-mode SNR); solve S u = F regularized
as the reference does; the update u is dtheta/dt.

theta is held in the master dtype (f64) by the integrator and cast to the
compute dtype per stage. Random numbers come from ``torch.Generator``s
seeded from an integer key; ``fold_in`` derives independent keys per step
and stage.

On a mesh (``state.ctx``, parallel/mesh.py) every rank runs this class on
its shard of the samples: the draws are global and sliced, the per-sample
kernels run on the rank's rows, means and maxima are global, and the
moments cross ranks in one all-reduce per statistics evaluation (one per
dtype: f64 moments reduce in f64); the solve and the Heun update then run
on every rank from the same reduced moments, so theta stays bitwise equal
across ranks. ``stats_partitioning`` selects, as in the JAX package:

- "shard_map" (what "auto" takes where it may): the per-rank direct or
  chunked statistics with the plain-mode and split kernels and quant8 on
  each rank's rows, the chunked pilot shift averaged over ranks, and the
  assembled (P, P) moments summed once (the JAX package's _stats_sharded,
  tdvp.py:1549-1598). It needs eigh or cholesky, no eloc_clip, no is_gamma
  and budgets and chunks divisible by the world (the JAX package's
  ValueError otherwise); a dp x tp mesh flattens into W sample shards.
- "gspmd" (and "auto" where shard_map may not run, or at tp > 1 with
  P > 16384): the JAX package's GSPMD layout. The samples shard over dp
  only (``self.ctx`` is the mesh's ``samples_over_dp`` view; the tp ranks
  of a dp index hold the same samples and run the same per-sample rows,
  through ``persample.per_sample_sharded``), and at tp > 1 each rank
  contracts only its ``row_block`` of every (P, P) moment: the
  (ceil(P/tp), P) blocks and F0 cross the dp group in one reduction and
  are then gathered over the tp group, so O is never gathered. The clip's
  median and MAD, the IS weights' max and mean are global. The int8 cross
  term of sym2 quantizes each rank's rows with the global column scales
  (an all-reduce MAX), as the JAX package quantizes its globally sharded
  operand. The chunked statistics run global chunks of chunk_size rows
  (_chunked_stats). tri2 needs shard_map (the JAX package's ValueError).

cg, minsr and the host solve run on either route (cg and minsr always
take GSPMD): CG's matvecs reduce over the dp group, minSR gathers the
centered rows (direct) or broadcasts each chunk's block (streaming), and
the host solve runs on the coordinator, which broadcasts the update.

Batches of steps (``heun_multi``, ``adaptive_multi``, the JAX package's
multi-step dispatch): on one CUDA device each step of a batch replays a
captured CUDA graph of the step (solver/graphs.py), the adaptive retries
as conditional nodes; elsewhere (``graphs_available``) the same step
functions run eagerly (``graphs_refusal`` says why). The small
eigensolves, the top-k Ritz matrix's (order k + 8) and the P-space
spectral solve's, are routed by their order when the TDVP is built
(kernels/jacobi.eigh_for): the Jacobi kernel on the card, whose solve
waits for nothing on the host, up to its reach; torch.linalg.eigh above
it, where the batches run eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..kernels import jacobi, persample, quant8, syrk
from ..models.state import VarState
from ..ops import score
from ..ops.evolution import Equation
from ..parallel import mesh, stats
from ..utils.dtypes import Precision, full_f32_matmuls
from . import graphs

_MASK63 = (1 << 63) - 1


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from (key, data) by the splitmix64 finalizer."""
    z = (key * 0x9E3779B97F4A7C15 + data + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK63


@dataclasses.dataclass(frozen=True)
class TDVPConfig:
    """Solver knobs; the JAX package's field names and defaults."""

    use_snr: bool = False
    snr_tol: float = 2.0
    svd_tol: float = 1e-11
    diagonal_shift: float = 0.0
    eig_cutoff: float = 1e-14
    # > 0: winsorize E_loc at this many robust sigmas (1.4826 MAD) around
    # its median (direct statistics only)
    eloc_clip: float = 0.0
    # < 1: draw the statistics batch from the Student-t proposal with
    # nu_q = max(is_gamma nu, 1.05) and weight it back (direct statistics)
    is_gamma: float = 1.0
    # "eigh" (spectral pseudo-inverse with the reference's per-mode
    # regularizers), "cholesky" (Tikhonov (S + svd_tol lambda_max I) u = F
    # with a power-iteration or top-k Ritz lambda_max), "cg" (the same
    # Tikhonov system by Jacobi-preconditioned conjugate gradients on
    # matvecs with O, S never formed; direct statistics only), "minsr"
    # (the N x N kernel T = O_c O_c^T's eigh, for P >> N; chunk_size > 0
    # streams it); "auto" = eigh up to eigh_max_params, cholesky above
    solver_method: str = "auto"
    eigh_max_params: int = 2048
    cg_maxiter: int = 250
    cg_tol: float = 1e-7
    # highest | high | default | f64 | f64acc (parallel/stats.py): "highest"
    # and "high" both mean a full-f32 matmul on the card (TF32 off,
    # utils/dtypes.full_f32_matmuls), "default" one bf16 pass there, "f64"
    # f64 operands, "f64acc" f64 accumulators across chunks
    gram_precision: str = "high"
    gram_backend: str = "auto"
    gram_cross: str = "auto"
    tri2_target_block: int = 0
    # top-k Ritz spectrum on the cholesky path (randomized subspace
    # iteration); 0 disables
    spectrum_topk: int = 64
    # floor svd_tol / eig_cutoff at 64 / 8 eps of the statistics' dtype
    # (f64 under gram_precision="f64"; f32's eps / sqrt(n / chunk_size)
    # under "f64acc")
    auto_tol_floor: bool = True
    # "trace": the quadratic trace along the equation's trace directions
    # (the CUDA kernel's mode); "block": the (k, k) Hessian block in its
    # hessian_coords (torch.func pipeline); "auto": trace where the
    # equation gives directions, else the block
    hessian_mode: str = "auto"
    # "auto" | "shard_map" | "gspmd": the statistics on a mesh (module
    # docstring); one rank runs the single-device statistics whatever it is
    stats_partitioning: str = "auto"
    # "cuda": the hand-written per-sample kernel (kernels/persample.py);
    # "torch": the torch.func pipeline; "auto": the kernel on a CUDA device
    # for f32 compute with 2048 <= P <= 32768 where it supports the flow;
    # the JAX package's "pallas" and "xla" are taken as "cuda" and "torch"
    per_sample_backend: str = "auto"
    # the CUDA kernel masks ragged batches, so it takes no tile; kept so
    # that configurations carry over from the JAX package
    per_sample_tile: int = 256
    compute_snr: bool = True
    compute_sexp: bool = False
    sexp_mode: str = "none"
    # False: the RHS returns S, S0, F0 and A and rhs() solves on the host
    # in numpy f64 (the reference's default path); eigh and cholesky only,
    # and only through rhs() (TDVP.fused_steps_available)
    solve_on_device: bool = True
    chunk_size: int = 0
    observables: bool = True
    # the observables add the Monte Carlo integrals of p over the balls of
    # radius {1, 0.5, 0.1} sqrt(integral_T) (sphere_integrals)
    integrals: bool = False
    integral_T: float = 10.0


# the JAX package's per_sample_backend values and the port's names for them
BACKEND_ALIASES = {"xla": "torch", "pallas": "cuda"}


def _check_config(cfg: TDVPConfig) -> None:
    if cfg.solver_method not in ("auto", "eigh", "cholesky", "cg", "minsr"):
        raise ValueError(f"unknown solver_method {cfg.solver_method!r}")
    if cfg.gram_precision not in stats.PRECISIONS:
        raise ValueError(f"unknown gram_precision {cfg.gram_precision!r}")
    if cfg.gram_backend not in ("auto", "xla", "syrk", "sym2", "tri2"):
        raise ValueError(f"unknown gram_backend {cfg.gram_backend!r}")
    if cfg.gram_cross not in ("auto", "bf16", "int8"):
        raise ValueError(f"unknown gram_cross {cfg.gram_cross!r}")
    if cfg.tri2_target_block < 0:
        raise ValueError("tri2_target_block must be >= 0 (0 = 512)")
    if cfg.chunk_size < 0:
        raise ValueError("chunk_size must be >= 0")
    if cfg.hessian_mode not in ("auto", "trace", "block"):
        raise ValueError(f"unknown hessian_mode {cfg.hessian_mode!r}")
    if cfg.stats_partitioning not in ("auto", "gspmd", "shard_map"):
        raise ValueError(
            f"unknown stats_partitioning {cfg.stats_partitioning!r}")
    if cfg.sexp_mode not in ("none", "auto", "dense", "matfree"):
        raise ValueError(f"unknown sexp_mode {cfg.sexp_mode!r}")
    if cfg.per_sample_backend not in ("auto", "torch", "cuda",
                                      *BACKEND_ALIASES):
        raise ValueError(f"unknown per_sample_backend "
                         f"{cfg.per_sample_backend!r} (auto, torch, cuda; "
                         f"xla, pallas)")


def _soft_cutoff(x, tol):
    """The reference's sixth-power regularizer 1/(1 + (tol/x)^6) as a
    log-space sigmoid (finite for x in [0, inf])."""
    return torch.sigmoid(6.0 * (torch.log(x) - math.log(tol)))


def _solve_regularized(S, F, cfg: TDVPConfig, n_samples: int, A=None,
                       eigh=torch.linalg.eigh):
    """Eigendecompose S (with ``eigh``) and apply the reference's
    regularized pseudo-inverse. A = E[Ebar^2 Obar^T Obar] feeds the
    per-mode SNR. Returns (update, ev, snr, VtF)."""
    ev, V = eigh(S)
    VtF = V.T @ F
    ratio = (ev / ev[-1]).abs()
    inv_ev = torch.where(ratio > cfg.eig_cutoff, 1.0 / ev,
                         torch.zeros_like(ev))
    regularizer = _soft_cutoff(ratio, cfg.svd_tol)
    snr = None
    if A is not None:
        AV = A @ V
        tiny = torch.finfo(VtF.dtype).tiny
        rho_var = ((V * AV).sum(0) - VtF**2).abs().clamp_min(tiny)
        snr = (n_samples * VtF**2 / rho_var).abs().sqrt()
        if cfg.use_snr:
            regularizer = regularizer * _soft_cutoff(snr, cfg.snr_tol)
    update = V @ (inv_ev * regularizer * VtF)
    return update, ev, snr, VtF


def _lambda_max(S, n_iter: int = 12):
    """Largest eigenvalue of S by power iteration (O(n_iter P^2))."""
    v = torch.ones(S.shape[0], dtype=S.dtype, device=S.device) \
        / math.sqrt(S.shape[0])
    for _ in range(n_iter):
        w = S @ v
        v = w / torch.linalg.norm(w)
    return v @ (S @ v)


def _randomized_topk_eigh(S, k: int, gen: torch.Generator, n_iter: int = 2,
                          eigh=jacobi.eigh):
    """Top-k eigenpairs of symmetric PSD S by randomized subspace
    iteration (Halko-Martinsson-Tropp) and a Rayleigh-Ritz eigh of order
    min(k + 8, P) with ``eigh`` (the TDVP's choice, jacobi.eigh_for: the
    Jacobi kernel on the card, no host wait). Returns (ev (k,), V (P, k))
    in ascending order of ev."""
    P = S.shape[0]
    k_eff = min(k + 8, P)
    Om = torch.randn((P, k_eff), generator=gen, dtype=S.dtype,
                     device=S.device)
    Y = S @ Om
    for _ in range(n_iter):
        Q, _ = torch.linalg.qr(Y)
        Y = S @ Q
    Q, _ = torch.linalg.qr(Y)
    B = Q.T @ (S @ Q)
    ev, U = eigh(0.5 * (B + B.T))
    V = Q @ U
    return ev[-k:], V[:, -k:]


def _solve_cholesky(S, F, cfg: TDVPConfig, lam_max=None):
    """Tikhonov solve (S + svd_tol * lambda_max * I) u = F. Returns
    (update, lambda_max)."""
    if lam_max is None:
        lam_max = _lambda_max(S)
    A = S + cfg.svd_tol * lam_max * torch.eye(S.shape[0], dtype=S.dtype,
                                              device=S.device)
    L, info = torch.linalg.cholesky_ex(A)
    u = torch.cholesky_solve(F[:, None], L)[:, 0]
    # a failed factorization gives NaN, as the JAX package's does, which
    # the NaN flag carries to the driver's abort (no host wait here)
    return torch.where(info == 0, u, torch.nan), lam_max


def _numpy_eigh(S):
    """torch.linalg.eigh's outputs from numpy's eigh of a CPU tensor."""
    ev, V = np.linalg.eigh(S.numpy())
    return torch.from_numpy(ev), torch.from_numpy(V)


# conjugate gradients read their stopping flag on the host once per this
# many iterations (the iteration itself stops on the device)
CG_CHECK_EVERY = 16


def _cg(A, b, M, tol: float, maxiter: int, check_every=CG_CHECK_EVERY):
    """jax.scipy.sparse.linalg.cg's preconditioned iteration (jax 0.9's
    _cg_solve) step for step: x0 = 0, gamma = r . M(r), and it runs while
    r . r > tol^2 b . b and k < maxiter. JAX runs a device while_loop;
    here the test is a device flag that freezes x, r, p and gamma once it
    fails, which gives what stopping there gives, and the host reads it
    once per ``check_every`` iterations to leave the loop. Returns
    (x, iterations as a device tensor)."""
    atol2 = tol**2 * (b @ b)
    x = torch.zeros_like(b)
    r = b.clone()  # b - A(x0) with x0 = 0
    p = z = M(r)
    gamma = r @ z
    active = r @ r > atol2
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for k in range(maxiter):
        if k and k % check_every == 0 and not bool(active):
            break
        Ap = A(p)
        alpha = gamma / (p @ Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        gamma_new = r_new @ z
        p_new = z + (gamma_new / gamma) * p
        x, r, gamma, p = (torch.where(active, new, old) for new, old in (
            (x_new, x), (r_new, r), (gamma_new, gamma), (p_new, p)))
        iters += active.to(torch.int32)
        active = active & (r @ r > atol2)
    return x, iters


def _solve_cg(O_c, e_c, cfg: TDVPConfig, mode: str, n=None, reduce=None):
    """Matrix-free Tikhonov solve (O_c^T O_c / N + lam I) u = F with
    Jacobi preconditioning: every operation is an (N, P) matvec, the Gram
    is never formed. ``mode``: the gram_precision of the matvecs
    (stats.contract). On a mesh O_c and e_c are a rank's rows, ``n`` the
    global count and ``reduce`` sums a list of tensors over the ranks:
    the diagonal and F cross them in one reduction, and every matvec in
    one of P values. Returns (update, F, lam_max, matvec, iterations)."""
    n = O_c.shape[0] if n is None else n
    if reduce is None:
        reduce = list
    diag_s, F = reduce([(O_c * O_c).sum(0),
                        stats.contract(e_c, O_c, mode)])
    diag_s, F = diag_s / n, F / n

    def sv(v):
        # (O_c v)^T O_c == O_c^T (O_c v)
        out = reduce([stats.contract(stats.contract(O_c, v, mode), O_c,
                                     mode)])[0] / n
        if cfg.diagonal_shift > 1e-10:
            # the shift S += shift * diag(S), matvec form
            out = out + cfg.diagonal_shift * diag_s * v
        return out

    # power iteration for lambda_max (matvecs only)
    v = torch.ones_like(F) / math.sqrt(F.shape[0])
    for _ in range(12):
        w = sv(v)
        v = w / torch.linalg.norm(w)
    lam_max = v @ sv(v)
    lam = cfg.svd_tol * lam_max
    diag = diag_s + lam  # the Jacobi preconditioner
    if cfg.diagonal_shift > 1e-10:
        diag = diag + cfg.diagonal_shift * diag_s
    update, iters = _cg(lambda u: sv(u) + lam * u, F, lambda r: r / diag,
                        cfg.cg_tol, cfg.cg_maxiter)
    return update, F, lam_max, sv, iters


def _minsr_kernel_solve(T, e_c, cfg: TDVPConfig, sdt):
    """Kernel-space (minSR) spectral solve for P >> N: the nonzero
    spectrum of S = O_c^T O_c / N is eig(T) / N of the N x N kernel
    T = O_c O_c^T, and the minimum-norm solution of S u = F is
    u = O_c^T alpha, alpha = W diag(reg_i / mu_i) W^T e_c for
    T = W diag(mu) W^T. The reference's per-mode regularizers apply to
    ev = mu / N; the per-mode SNR comes from V_i^T A V_i =
    (mu_i / N) sum_n e_n^2 W_ni^2; the residual and the TDVP error from
    the quadratic q(v) = v^T T v: ||S u - F||^2 = q(T alpha - e_c) / N^2,
    ||F||^2 = q(e_c) / N^2, u^T S u = ||T alpha||^2 / N and
    F . u = e_c^T T alpha / N, so no P-sized vector is needed.

    ``T``: the raw kernel (symmetrized here). Returns (alpha (N,) in
    ``sdt``, ev, snr, residual, u^T S u - 2 F . u)."""
    n = e_c.shape[0]
    T_s = 0.5 * (T + T.T).to(sdt)
    mu, W = torch.linalg.eigh(T_s)
    ev = mu / n
    e_s = e_c.to(sdt)
    Wte = W.T @ e_s
    ratio = (ev / ev[-1]).abs()
    inv_mu = torch.where(ratio > cfg.eig_cutoff, 1.0 / mu,
                         torch.zeros_like(mu))
    regularizer = _soft_cutoff(ratio, cfg.svd_tol)
    snr = None
    if cfg.compute_snr or cfg.use_snr:
        VtF = mu.clamp_min(0.0).sqrt() * Wte / n
        rho_var = ((mu / n) * (e_s**2 @ W**2) - VtF**2).abs().clamp_min(
            torch.finfo(VtF.dtype).tiny)
        snr = (n * VtF**2 / rho_var).abs().sqrt()
        if cfg.use_snr:
            regularizer = regularizer * _soft_cutoff(snr, cfg.snr_tol)
    alpha = W @ (inv_mu * regularizer * Wte)
    Ta = T_s @ alpha

    def q(v):
        return (v @ (T_s @ v)).clamp_min(0.0)

    residual = (q(Ta - e_s) / q(e_s).clamp_min(torch.finfo(sdt).tiny)).sqrt()
    tdvp_quad = (Ta @ Ta) / n - 2.0 * (e_s @ Ta) / n
    return alpha, ev, snr, residual, tdvp_quad


def _solve_minsr(O_c, e_c, cfg: TDVPConfig, mode: str, sdt,
                 use_sym2: bool = False):
    """Direct minSR on the materialized O_c: T by one product (or
    stats.sym2_outer_sum's two bf16 ones, ``use_sym2``), the kernel-space
    solve, and update = O_c^T alpha. Returns (update, ev, snr, residual,
    tdvp_quad)."""
    T = (stats.sym2_outer_sum(O_c) if use_sym2
         else stats.contract(O_c, O_c.T, mode))
    alpha, ev, snr, residual, tdvp_quad = _minsr_kernel_solve(T, e_c, cfg,
                                                              sdt)
    update = stats.contract(alpha.to(O_c.dtype), O_c, mode).to(sdt)
    return update, ev, snr, residual, tdvp_quad


def _ball_volume(dim: int, radius: float) -> float:
    return math.pi ** (dim / 2) / math.gamma(dim / 2 + 1) * radius**dim


def unit_ball(gen: torch.Generator, n: int, dim: int, dtype, device):
    """n points uniform in the unit ball: normal directions, normalized,
    times radii u^(1/dim), drawn in that order from ``gen``."""
    dirs = torch.randn((n, dim), generator=gen, dtype=dtype, device=device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    radii = torch.rand((n,), generator=gen, dtype=dtype,
                       device=device) ** (1.0 / dim)
    return dirs * radii[:, None]


def sphere_integrals(ctx, flow, params, ball, integral_T: float):
    """The Monte Carlo integrals of p over the balls of radius {1, 0.5,
    0.1} sqrt(integral_T) about the origin from the unit-ball points
    ``ball`` (this rank's rows on a mesh): the global mean of p at the
    scaled points times the ball's volume, under the reference's infos
    keys (integral_1sigma, integral_0.5sigma, integral_0.1sigma)."""
    n, d = ball.shape
    out = {}
    for label, lim in (("1", 1.0), ("0.5", 0.5), ("0.1", 0.1)):
        r = lim * math.sqrt(integral_T)
        p = torch.exp(flow.log_prob(params, r * ball))
        (mean,) = stats.global_means(ctx, [p], n * ctx.world)
        out[f"integral_{label}sigma"] = mean * _ball_volume(d, r)
    return out


def _chunk_spans(k: int, c: int, n_loc: int) -> bool:
    """Whether the global chunk k of c rows spans the rows of more than
    one shard of n_loc rows."""
    return (k * c) // n_loc != ((k + 1) * c - 1) // n_loc


def _chunk_pieces(n_loc: int, shard: int, c: int):
    """The global chunks [k c, (k+1) c) that meet shard ``shard``'s rows
    [shard n_loc, (shard+1) n_loc), in order: (k, lo, hi, spans) with the
    shard's rows of chunk k at [lo, hi) of its own, and whether the chunk
    spans shards. One shard: the chunks themselves."""
    base = shard * n_loc
    return [(k, max(k * c, base) - base,
             min((k + 1) * c, base + n_loc) - base, _chunk_spans(k, c, n_loc))
            for k in range(base // c, -(-(base + n_loc) // c))]


def _batch_row(aux):
    """The recorded part of a step's aux: without the update, the SExp
    matrix and the internal "_" entries."""
    return {k: v for k, v in aux.items()
            if not k.startswith("_") and k not in ("update", "SExp")}


def _copy_row(out):
    """A copy of a replay's outputs (nested dicts of tensors), off the
    program's static buffers."""
    if isinstance(out, dict):
        return {k: _copy_row(v) for k, v in out.items()}
    return out.clone() if isinstance(out, torch.Tensor) else out


def _stack_rows(rows):
    """Per-step rows -> {key: (K, ...) stack}; Python numbers become a
    CPU tensor."""
    return {k: (torch.stack([r[k] for r in rows])
                if isinstance(rows[0][k], torch.Tensor)
                else torch.tensor([r[k] for r in rows]))
            for k in rows[0]}


class TDVP:
    """Fused TDVP right-hand side on one device, or on one rank of a mesh.

    ``rhs(theta_master, t, key)`` returns (dtheta_master, aux);
    ``heun_pair`` and ``rk3_triple`` a whole fixed step, ``heun_attempt``
    and ``rk23_attempt`` a whole adaptive attempt with its error. After
    each call the reference's diagnostics are attributes (``ev``, ``snr``,
    ``solverResidual``, ``tdvp_error``, ``SExp``)."""

    def __init__(self, state: VarState, equation: Equation,
                 cfg: TDVPConfig = TDVPConfig(), n_samples: int = 10000,
                 n_samples_obs: Optional[int] = None,
                 precision: Optional[Precision] = None):
        _check_config(cfg)
        full_f32_matmuls()
        self.state = state
        self.flow = state.flow
        self.equation = equation
        self.precision = precision or state.precision
        self.sampler = state.sampler
        self.device = state.device
        # the mesh, and (below) self.ctx, the sharding of the samples
        self.mesh_ctx = ctx = state.ctx
        if not any((self.sampler.ctx.world, self.sampler.ctx.rank)
                   == (c.world, c.rank)
                   for c in (ctx, ctx.samples_over_dp())):
            raise ValueError("the sampler and the state sit on different "
                             "meshes")
        self.n_samples = self.sampler.rounded_budget(n_samples)
        self.n_samples_obs = (self.sampler.rounded_budget(n_samples_obs)
                              if n_samples_obs is not None
                              else self.n_samples)
        if 0 < cfg.chunk_size < self.n_samples:
            # the chunked statistics take whole chunks: round the budget up
            # to a multiple of lcm(chunk, sampler block), as the JAX
            # package does (budgets only grow)
            step = math.lcm(self.sampler.rounded_budget(1), cfg.chunk_size)
            self.n_samples = -(-self.n_samples // step) * step

        if cfg.auto_tol_floor:
            # the floor follows the dtype the statistics are contracted in:
            # f64 under "f64"; under "f64acc" each chunk contracts in f32
            # but the chunks add up exactly, so the noise floor drops by
            # sqrt(n_chunks)
            eps = torch.finfo(stats.GRAM_OPERAND_DTYPE.get(
                cfg.gram_precision, self.precision.compute)).eps
            if (cfg.gram_precision == "f64acc"
                    and 0 < cfg.chunk_size < self.n_samples):
                eps /= math.sqrt(self.n_samples / cfg.chunk_size)
            cfg = dataclasses.replace(
                cfg, svd_tol=max(cfg.svd_tol, 64.0 * eps),
                eig_cutoff=max(cfg.eig_cutoff, 8.0 * eps))
        self.n_params = state.numParameters
        if cfg.solver_method == "auto":
            method = ("eigh" if self.n_params <= cfg.eigh_max_params
                      else "cholesky")
        else:
            method = cfg.solver_method
        if cfg.eloc_clip < 0:
            raise ValueError("eloc_clip must be >= 0 (robust sigmas)")
        if cfg.eloc_clip and cfg.chunk_size > 0:
            raise ValueError("eloc_clip needs the direct stats path (global "
                             "median); use chunk_size=0")
        if cfg.is_gamma != 1.0:
            if not 0.0 < cfg.is_gamma < 1.0:
                raise ValueError("is_gamma must be in (0, 1] (proposal must "
                                 "dominate the target's tails)")
            if not (self.sampler.exact
                    and self.flow.latent_name == "Student_t"):
                raise ValueError("is_gamma tempering needs the exact "
                                 "Student_t latent")
            if cfg.chunk_size or method in ("cg", "minsr"):
                raise ValueError("is_gamma tempering runs on the direct "
                                 "eigh/cholesky statistics path")
        if method == "cg" and cfg.chunk_size:
            raise ValueError("solver_method='cg' works on the materialized "
                             "O matrix; use chunk_size=0")
        if method in ("cg", "minsr") and not cfg.solve_on_device:
            raise ValueError(f"solver_method={method!r} runs on device only")
        self.solver_method = method
        # the adaptive steppers' S metric, as in the JAX package: "auto" is
        # the dense SExp for eigh and the matrix-free quadratic otherwise
        self._sexp_matfree = cfg.sexp_mode == "matfree" or (
            cfg.sexp_mode == "auto" and method != "eigh")
        if cfg.sexp_mode == "dense" or (cfg.sexp_mode == "auto"
                                        and method == "eigh"):
            cfg = dataclasses.replace(cfg, compute_sexp=True)
        if method == "cg" and (cfg.compute_snr or cfg.use_snr
                               or cfg.compute_sexp):
            # matrix-free: no S, no spectrum, no SExp matrix
            if cfg.compute_sexp:
                warnings.warn(
                    "solver_method='cg' cannot provide the SExp matrix; an "
                    "adaptive stepper's S-metric error norm will silently "
                    "degrade to the plain 2-norm. Use solver_method="
                    "'cholesky' (or 'eigh') with adaptive_heun.",
                    stacklevel=2)
            if cfg.use_snr:
                warnings.warn(
                    "solver_method='cg' is matrix-free (no spectral basis), "
                    "so use_snr cannot gate modes and is DISABLED. Use "
                    "'eigh' (P <= eigh_max_params), 'cholesky' with "
                    "spectrum_topk > 0 (Ritz-projected gating), or 'minsr' "
                    "(kernel-basis gating) for SNR regularization.",
                    stacklevel=2)
            cfg = dataclasses.replace(cfg, compute_snr=False, use_snr=False,
                                      compute_sexp=False)
        elif method == "minsr" and cfg.compute_sexp:
            # the spectrum and the SNR live in the kernel basis, but a
            # (P, P) SExp would defeat minSR's point
            raise ValueError(
                "solver_method='minsr' cannot provide the SExp matrix for "
                "the adaptive stepper's S-metric; use 'cholesky' or 'eigh' "
                "with adaptive_heun")
        if method == "minsr" and cfg.diagonal_shift > 1e-10:
            raise ValueError(
                "solver_method='minsr' does not support diagonal_shift "
                "(no N x N kernel-space representation of shift * diag(S))")
        elif method == "cholesky":
            # per-mode SNR exists only in the top-k Ritz basis, which the
            # on-device solve alone has
            if cfg.use_snr and (cfg.spectrum_topk <= 0
                                or not cfg.solve_on_device):
                raise ValueError(
                    "use_snr on solver_method='cholesky' gates modes in "
                    "the randomized Ritz subspace, which exists on the "
                    "on-device solve only; set spectrum_topk > 0 and "
                    "solve_on_device=True (or use solver_method='eigh'/"
                    "'minsr' for full-spectrum SNR gating)")
            keep_snr = ((cfg.compute_snr or cfg.use_snr)
                        and cfg.spectrum_topk > 0)
            cfg = dataclasses.replace(cfg, compute_snr=keep_snr)
        self.cfg = cfg

        # The small eigensolves, routed here once by their order: the
        # top-k Ritz matrix (order k + 8) and the P-space spectral solve
        # (method eigh) take the Jacobi kernel on the card, which waits for
        # nothing on the host, up to its reach, and torch.linalg.eigh above
        # it (a host wait: such a TDVP runs its batches eagerly,
        # graphs_refusal).
        sdt = self.precision.solve
        self._ritz_order = min(cfg.spectrum_topk + 8, self.n_params)
        self._ritz_eigh = jacobi.eigh_for(self._ritz_order, sdt, self.device)
        self._spectral_eigh = jacobi.eigh_for(self.n_params, sdt,
                                              self.device)

        # torch has no x64 switch to forget, so the JAX package's "needs
        # x64" refusal of f64/f64acc has no counterpart here
        if cfg.gram_precision == "f64acc":
            # the mode is the chunked accumulation: the direct contraction
            # has no carry across chunks to widen
            if not 0 < cfg.chunk_size < self.n_samples:
                raise ValueError(
                    "gram_precision='f64acc' upgrades the CHUNKED "
                    "accumulation carry to f64; set 0 < chunk_size < "
                    f"n_samples (chunk_size={cfg.chunk_size}, "
                    f"n_samples={self.n_samples})")
            if method not in ("eigh", "cholesky"):
                raise ValueError(
                    "gram_precision='f64acc' serves the Gram-based "
                    "eigh/cholesky statistics path")

        # The statistics on a mesh, gated as in the JAX package
        # (tdvp.py:634-686): shard_map where it may run (and auto takes it,
        # except at tp > 1 with P > 16384, where the JAX package keeps its
        # memory-scaling GSPMD layout), else the GSPMD counterpart
        W = ctx.world
        smap_ok = (
            W > 1
            and method in ("eigh", "cholesky")
            and cfg.eloc_clip == 0.0
            and cfg.is_gamma == 1.0
            and (cfg.chunk_size == 0 or cfg.chunk_size % W == 0)
            and self.n_samples % W == 0
        )
        if cfg.stats_partitioning == "shard_map" and not smap_ok:
            raise ValueError(
                "stats_partitioning='shard_map' needs a multi-device "
                "mesh, solver_method eigh/cholesky, no "
                "eloc_clip/is_gamma, and n_samples/chunk_size divisible "
                "by the mesh size "
                f"(mesh dp={ctx.dp} tp={ctx.tp}, "
                f"method={method!r}, n_samples={self.n_samples}, "
                f"chunk_size={cfg.chunk_size})"
            )
        self._stats_shardmap = smap_ok and (
            cfg.stats_partitioning == "shard_map"
            or (cfg.stats_partitioning == "auto"
                and (ctx.tp == 1 or state.numParameters <= 16384)))
        self._gspmd = W > 1 and not self._stats_shardmap
        # GSPMD: the samples over dp, and at tp > 1 this rank's rows of
        # every (P, P) moment (None: all of them)
        self.ctx = ctx.samples_over_dp() if self._gspmd else ctx
        if self.sampler.ctx is not self.ctx:
            self.sampler.shard_over(self.ctx)
        self._rows = (ctx.row_block(state.numParameters)
                      if self._gspmd and ctx.tp > 1 else None)

        # Gram backend: "auto" resolves as the JAX package resolves it off
        # a TPU, to the plain f32 product; only an explicit syrk/sym2/tri2
        # engages the bf16 split (syrk: the triangle kernel,
        # kernels/syrk.py), and only an explicit int8 its int8 cross term
        # (parallel/stats.py)
        split_ok = (self.precision.compute == torch.float32
                    and cfg.gram_precision in ("high", "f64acc"))
        if cfg.gram_backend in ("syrk", "sym2", "tri2") and not split_ok:
            raise ValueError(
                f"gram_backend={cfg.gram_backend!r} implements f32 "
                "statistics at gram_precision='high' numerics; use "
                "'auto'/'xla' with this precision configuration")
        self._use_syrk = cfg.gram_backend == "syrk"
        if self._use_syrk and W > 1:
            raise ValueError(
                "gram_backend='syrk' is a single-device kernel; use "
                "gram_backend='auto'/'xla' on multi-device meshes"
            )
        self._use_sym2 = cfg.gram_backend == "sym2"
        self._use_tri2 = cfg.gram_backend == "tri2"
        if self._use_tri2 and self._gspmd:
            raise ValueError(
                "gram_backend='tri2' on a multi-device mesh needs the "
                "shard_map stats path (its K+1 split dot_generals "
                "would each all-reduce separately under GSPMD); this "
                "configuration is ineligible for it -- use "
                "gram_backend='auto'/'sym2'"
            )
        self._cross_int8 = cfg.gram_cross == "int8"
        self._tri2_bounds = (stats.tri2_bounds(
            state.numParameters, cfg.tri2_target_block or 512)
            if self._use_tri2 else None)
        if self._cross_int8 and not (self._use_sym2 or self._use_tri2):
            raise ValueError(
                "gram_cross='int8' is the cross pass of the sym2/tri2 "
                "split backends; this configuration has no cross term "
                "(use gram_backend='sym2'/'tri2')")

        self._unravel = self.flow.layout.unravel
        # the Hessian as the JAX package selects it (tdvp.py:851-873): the
        # quadratic trace along the equation's trace directions ("auto",
        # "trace"), else the (k, k) block in its hessian_coords ("block",
        # and "auto" for an equation that declares no trace directions)
        hess_idx = equation.hessian_coords(self.flow.dim)
        dirs = None
        if cfg.hessian_mode in ("auto", "trace"):
            dirs = equation.hessian_trace_dirs(self.flow.dim)
            if (dirs is None and cfg.hessian_mode == "trace"
                    and hess_idx is not None):
                raise ValueError(
                    f"equation {equation.name!r} needs the full Hessian "
                    "block; hessian_mode='trace' is not available")
        elif (hess_idx is None
              and equation.hessian_trace_dirs(self.flow.dim) is not None):
            raise ValueError(
                f"equation {equation.name!r} declares only "
                "hessian_trace_dirs (no hessian_coords block), so "
                "hessian_mode='block' cannot serve it; use "
                "hessian_mode='auto' or 'trace'")
        self._hess_dirs = None if dirs is None else torch.as_tensor(
            dirs, dtype=self.precision.compute, device=self.device)
        # the block runs on the torch.func pipeline: the kernel serves
        # trace mode only (persample.supports)
        self._hess_block = (
            score.make_flat_log_prob(self.flow, self._unravel), hess_idx
        ) if dirs is None and hess_idx is not None else None

        kernel_ok = persample.supports(self.flow, dirs, hess_idx)
        backend = BACKEND_ALIASES.get(cfg.per_sample_backend,
                                      cfg.per_sample_backend)
        if backend == "cuda" and not kernel_ok:
            raise ValueError("per_sample_backend='cuda' does not support "
                             "this flow (kernels.persample.supports)")
        use_kernel = backend == "cuda" or (
            backend == "auto"
            and self.device.type == "cuda"
            and self.precision.compute == torch.float32
            and 2048 <= self.n_params <= 32768
            and kernel_ok)
        # the wrapper launches the kernel for CUDA tensors and takes the
        # plain pipeline for CPU tensors; the GSPMD counterpart goes
        # through the sharded wrapper on the dp shards, as the JAX
        # package's GSPMD path takes make_per_sample_sharded
        if use_kernel and self._gspmd:
            self._per_sample = functools.partial(
                persample.per_sample_sharded, self.ctx)
        else:
            self._per_sample = (persample.per_sample if use_kernel
                                else persample.per_sample_plain)
        self.uses_kernel = use_kernel
        # the split-emitting variant serves the chunked sym2/tri2 path
        # wherever the kernel does (it too takes the plain version for CPU
        # tensors)
        self._ps_split = (persample.per_sample_split
                          if use_kernel and (self._use_sym2
                                             or self._use_tri2)
                          else None)

        # Metropolis latents: the chain state passes from RHS to RHS (and
        # from Heun stage 0 to stage 1) through the sampler, which starts
        # it on the first RHS (ensure_chain_state). As in the JAX package
        # the chain here is the torch one, never the Metropolis kernel
        self._mcmc = not self.sampler.exact
        self._chain_fn = (self.sampler.make_chain_fn() if self._mcmc
                          else None)

        self.ev = None
        self.snr = None
        self.solverResidual = None
        self.tdvp_error = None
        self.ElocMean = None
        self.ElocVar = None
        self.SExp = None
        # the last rhs() stage's (theta, x, logp, log_w, O) for sexp_norm
        self._sexp_ctx = None
        # the captured batched steps (solver/graphs.py), by kind and shape;
        # the program being captured and its random-walk scale buffer
        self._programs = {}
        self._program = None
        self._graph_rw = None
        # adaptive batch slots that needed more than max_graph_attempts
        # attempts and finished on the host
        self.host_finished = 0

    def _gen(self, key: int) -> torch.Generator:
        """The generator of the draws keyed by ``key``: a fresh one seeded
        with it, or, while a step is captured, the program's generator of
        that draw site (solver/graphs.py)."""
        if self._program is not None:
            return self._program.generator(key)
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        return g

    def _fold(self, key: int, i: int) -> int:
        """fold_in(key, i), recorded by the program being captured."""
        if self._program is not None:
            return self._program.fold(key, i)
        return fold_in(key, i)

    def _rw_scale(self):
        """The chain's random-walk scale: the sampler's, or inside a
        captured step the program's device copy of it (set per batch)."""
        if self._program is not None and self._graph_rw is not None:
            return self._graph_rw
        return self.sampler.chain_rw_scale()

    # ------------------------------------------------------------------
    def _per_sample_batch(self, theta_c, x, t):
        """x: (n, d) -> (logp (n,), Eloc (n,), O (n, P)); E_loc takes the
        trace, or in block mode the (n, k, k) Hessian blocks."""
        logp, g, hess, O = self._per_sample(self.flow, theta_c, x,
                                            self._hess_dirs)
        if self._hess_block is not None:
            hess = score.batched_hessian_block(self._hess_block[0], theta_c,
                                               x, self._hess_block[1])
        return logp, self.equation.eloc(x, g, hess, t), O

    def _maybe_clip_eloc(self, eloc):
        """Winsorize E_loc at eloc_clip robust standard deviations
        (1.4826 MAD) around its median (cfg.eloc_clip > 0): heavy-tailed
        workloads (Student-t at nu = 2 has infinite E_loc variance) trade
        a small controlled bias for that variance. Medians as jnp.median
        takes them (the midpoint of the two middle values); on a mesh the
        median and the MAD are those of all N values."""
        c = self.cfg.eloc_clip
        if not c:
            return eloc
        e = mesh.all_gather_rows(self.ctx, eloc)
        med = torch.quantile(e, 0.5, interpolation="midpoint")
        scale = 1.4826 * torch.quantile((e - med).abs(), 0.5,
                                        interpolation="midpoint")
        return med + torch.clamp(eloc - med, -c * scale, c * scale)

    def _direct_stats(self, theta_c, t, x, log_w=None):
        """Materialize O once, center, contract with the configured Gram
        backend. ``log_w``: per-sample log importance weights (x drawn
        from the is_gamma proposal): every statistic becomes its
        self-normalized estimator, with the weights normalized to mean 1
        so that the /n forms hold -- weighted means and centering, the
        weight in the force and in every Gram.

        On a mesh x (and log_w) is this rank's shard: the weights'
        normalizers and every mean are global, each rank contracts its
        rows against the global means, and F0, S0, A and the E_loc
        variance cross ranks in ONE all-reduce of the assembled moments
        (the JAX package's _direct_stats with axis / n_global). Under
        GSPMD at tp > 1 the Gram moments are this rank's row blocks until
        that reduction (over the dp group), then gathered over tp.

        Under gram_precision="f64" the centered O, E_loc, logp and the
        weights are cast to f64 before the contractions; every product
        takes the gram_precision (stats.contract)."""
        ctx = self.ctx
        n = x.shape[0] * ctx.world
        logp, eloc, O = self._per_sample_batch(theta_c, x, t)
        eloc = self._maybe_clip_eloc(eloc)
        w = None
        if log_w is not None:
            w = torch.exp(log_w - mesh.all_reduce_max(ctx, log_w.max()))
            w = w / stats.global_means(ctx, [w], n)[0]

        def wtimes(a):
            if w is None:
                return a
            return (w if a.ndim == 1 else w[:, None]) * a

        eloc_mean, eloc_abs_mean, eloc_sq_mean, o_mean = stats.global_means(
            ctx, [wtimes(eloc), wtimes(eloc.abs()), wtimes(eloc**2),
                  wtimes(O)], n)
        e_c = eloc - eloc_mean
        O_c = O - o_mean
        eloc_var = wtimes(e_c**2).sum() / n
        lp = logp
        gdt = stats.GRAM_OPERAND_DTYPE.get(self.cfg.gram_precision)
        if gdt is not None:
            O_c, e_c, lp = O_c.to(gdt), e_c.to(gdt), lp.to(gdt)
            w = None if w is None else w.to(gdt)
        # GSPMD: the rank's rows of a globally sharded operand, so the
        # int8 cross term takes the global column scales and row count (the
        # shard_map path keeps per-shard scales, as the JAX package does)
        glob = {}
        if self._gspmd and self._cross_int8:
            glob = dict(amax_fn=functools.partial(mesh.all_reduce_max, ctx),
                        n_rows=self.n_samples)
        gram_sum, _, gram_fin = self._gram_backend(**glob)
        A = SExp = None
        if self.cfg.compute_snr or self.cfg.use_snr:
            A = gram_fin(gram_sum(O_c, wtimes(e_c**2))) / n
        if self.cfg.compute_sexp:
            # SExp = E[w logp^2 O_c^T O_c], the adaptive steppers' metric
            SExp = gram_fin(gram_sum(O_c, wtimes(lp**2))) / n
        F0 = stats.contract(wtimes(e_c), O_c, self.cfg.gram_precision) / n
        F0, S0, A, SExp, eloc_var = mesh.all_reduce_sum(ctx, [
            F0, gram_fin(gram_sum(O_c, w)) / n, A, SExp, eloc_var])
        S0, A, SExp = self._gather_rows([S0, A, SExp])
        return dict(
            O=O if self._sexp_matfree else None,
            SExp=SExp,
            logp=logp,
            eloc=eloc,
            eloc_mean=eloc_mean,
            eloc_abs_mean=eloc_abs_mean,
            eloc_var=eloc_var,
            eloc_sq_mean=eloc_sq_mean,
            F0=F0,
            S0=S0,
            A=A,
            is_ess_share=(None if w is None else
                          1.0 / stats.global_means(ctx, [w**2], n)[0]),
        )

    def _gram_backend(self, acc_dtype=None, amax_fn=None, n_rows=None):
        """(gram_sum, gram_zero, gram_fin) of the configured backend:
        gram_sum(Os, w=None) the unnormalized chunk moment Os^T diag(w) Os,
        gram_zero() its accumulator (in ``acc_dtype``, default the compute
        dtype), gram_fin(acc) the assembled (P, P). tri2 accumulates the
        raw triangle strips and cross term and mirrors them once; the
        other backends the matrix itself (syrk: one kernel launch per
        moment, mirrored inside; the f32 product at the gram_precision
        otherwise). At tp > 1 under GSPMD the f32 and sym2 moments are
        this rank's (r1 - r0, P) row block (``self._rows``).
        ``amax_fn``, ``n_rows``: the int8 cross term's global column max
        and row count, where Os holds a rank's rows of a sharded operand
        (stats.sym2_gram_sum)."""
        P = self.n_params
        cdt = acc_dtype or self.precision.compute
        dev, cross = self.device, self._cross_int8
        rows = self._rows
        n_out = P if rows is None else rows[1] - rows[0]
        if self._use_tri2:
            bounds = self._tri2_bounds

            def gram_zero():
                return {"t": tuple(torch.zeros((hi - lo, hi), dtype=cdt,
                                               device=dev)
                                   for lo, hi in zip(bounds[:-1],
                                                     bounds[1:])),
                        "m2": torch.zeros((P, P), dtype=cdt, device=dev)}

            return (lambda Os, w=None: stats.tri2_gram_sum_raw(
                        Os, w, bounds, cross_int8=cross),
                    gram_zero,
                    lambda acc: stats.tri2_gram_finalize(acc, bounds))
        if self._use_syrk:
            gram_sum = syrk.syrk
        elif self._use_sym2:
            gram_sum = lambda Os, w=None: stats.sym2_gram_sum(  # noqa: E731
                Os, w, cross_int8=cross, amax_fn=amax_fn, n_rows=n_rows,
                rows=rows)
        else:
            mode = self.cfg.gram_precision
            r = slice(None) if rows is None else slice(*rows)
            gram_sum = lambda Os, w=None: stats.contract(  # noqa: E731
                Os[:, r].T, Os if w is None else Os * w[:, None], mode)
        return (gram_sum,
                lambda: torch.zeros((n_out, P), dtype=cdt, device=dev),
                lambda acc: acc)

    def _gather_rows(self, mats):
        """The whole (P, P) moments from this rank's row blocks (None
        entries pass through); the moments themselves off the tp-sharded
        layout."""
        if self._rows is None:
            return list(mats)
        return mesh.all_gather_row_blocks(self.mesh_ctx, mats, self.n_params)

    def _chunked_stats(self, theta_c, t, x):
        """Streaming statistics, the counterpart of the JAX package's
        _chunked_stats (tdvp.py:1200-1547) on one device: a loop over
        sample chunks, so O never exists beyond one chunk. The moments
        accumulate pilot-shifted (O - c_O, E_loc - c_E, the pilot means)
        so that the f32 sums stay well conditioned, and are un-shifted
        once at the end. Accumulators are updated in place.

        With the split kernel (sym2/tri2 on the kernel's path) every chunk
        goes through per_sample_split, which emits the bf16 pair of O - c_O
        with its column sums and max; the unweighted Gram and the force
        read the pair, and with the int8 cross term quant8.quant_force
        turns each half into its int8 operand and its force terms in one
        pass. The pilot then runs on the first min(c, 8 * tile) samples
        through the plain-mode kernel, as in the JAX package, so that both
        shift by the same constants. Without it, chunk 0 is the pilot and
        the split, if any, happens in the Gram (stats.py).

        On a mesh x is this rank's shard. Under shard_map it is scanned in
        local chunks of chunk_size / W rows (the same per-rank work as one
        device's scan at the global chunk); the pilot shift is averaged
        over the ranks, so that every rank un-shifts by the same
        constants; each rank assembles its tri2 strips, quantizes its int8
        cross terms with its own column scales and de-scales them before
        the reduce. Under GSPMD the chunks are the JAX package's global
        ones (its _chunked_stats with axis=None): chunk k is the global
        rows [k c, (k+1) c), of which each rank takes its own (a chunk may
        lie inside one rank's rows or span several: _chunk_pieces); the
        pilot shift is chunk 0's mean, sent from the rank that holds it
        (summed over its holders where it spans ranks), and chunk 0 is
        reused as the first accumulated chunk; the chunks run the
        plain-mode kernel (no split pair and no quant8: the JAX package
        takes those on one device or under shard_map only); sym2's int8
        column scales are each global chunk's, reduced over the dp group
        where the chunk spans ranks (the ranks without rows in it join
        with zeros, so every rank steps through those reductions in the
        chunks' order); at tp > 1 the Gram accumulators are this rank's
        row blocks. Either way every accumulated moment crosses ranks in
        ONE all-reduce after the scan (per dtype), per statistics
        evaluation, not per chunk (the JAX package's _chunked_stats with
        axis / n_global); the row blocks are then gathered over tp.

        The accumulators take the gram_precision's dtype (f64 under
        "f64" and "f64acc": each chunk's f32 moments add into f64). Under
        "f64" every chunk's shifted O and E_loc are cast to f64 before
        its products, so the chunks run the plain-mode kernel (the split
        pair applies only where the operand dtype stays the compute
        dtype, as in the JAX package)."""
        cfg = self.cfg
        ctx = self.ctx
        n_loc, d = x.shape
        n = n_loc * ctx.world
        if self._stats_shardmap:
            c = cfg.chunk_size // ctx.world
            if n_loc % c:
                raise ValueError(
                    f"sample budget {n_loc} is not a multiple of chunk size "
                    f"{c} (TDVP.__init__ rounds its own budgets; a "
                    "hand-built call must do the same)")
            pieces = [(i // c, i, i + c, False) for i in range(0, n_loc, c)]
        else:
            c = cfg.chunk_size
            if n % c:
                raise ValueError(
                    f"sample budget {n} is not a multiple of chunk size {c} "
                    "(TDVP.__init__ rounds its own budgets; a hand-built "
                    "call must do the same)")
            pieces = _chunk_pieces(n_loc, ctx.rank, c)
        P = self.n_params
        mode = cfg.gram_precision
        gdt = stats.GRAM_OPERAND_DTYPE.get(mode)
        acc_dt = stats.GRAM_ACC_DTYPE.get(mode, theta_c.dtype)
        use_pair = (self._ps_split is not None and gdt is None
                    and not self._gspmd)
        use_q8 = (use_pair and self._cross_int8 and c % 8 == 0
                  and c <= stats._INT8_CROSS_N_MAX)
        want_A = cfg.compute_snr or cfg.use_snr
        want_l2 = cfg.compute_sexp
        gram_sum, gram_zero, gram_fin = self._gram_backend(acc_dt)
        # a chunk that spans ranks under GSPMD quantizes its int8 cross
        # terms with the column scales of all of its rows: one all-reduce
        # MAX per Gram moment of the chunk, which every rank joins
        span_q8 = self._gspmd and self._cross_int8
        n_grams = 1 + 2 * want_A + want_l2
        if span_q8:
            span_gram_sum = self._gram_backend(
                acc_dt, amax_fn=functools.partial(mesh.all_reduce_max, ctx),
                n_rows=c)[0]

        first = pieces[0]
        if use_pair:
            c_pilot = min(c, 8 * cfg.per_sample_tile)
            pilot = self._per_sample_batch(theta_c, x[:c_pilot], t)
        else:
            pilot = self._per_sample_batch(theta_c, x[first[1]:first[2]], t)
        if self._gspmd:
            # chunk 0's mean: every rank shifts by the same constants
            if _chunk_spans(0, c, n_loc):
                held = first[0] == 0
                c_O, c_E = (v / c for v in mesh.all_reduce_sum(ctx, [
                    pilot[2].sum(0) if held else pilot[2].new_zeros(P),
                    pilot[1].sum() if held else pilot[1].new_zeros(())]))
            else:
                c_O = torch.cat([pilot[2].mean(0), pilot[1].mean()[None]])
                mesh.broadcast(ctx, c_O, 0)
                c_O, c_E = c_O[:P], c_O[P]
        else:
            c_O = pilot[2].mean(0)
            c_E = pilot[1].mean()
            if ctx.world > 1:
                # every rank must shift by the SAME constants, or the
                # summed raw moments could not be un-shifted: one small (P,)
                # mean
                c_O, c_E = (v / ctx.world
                            for v in mesh.all_reduce_sum(ctx, [c_O, c_E]))

        def zeros(*shape):
            return torch.zeros(shape, dtype=acc_dt, device=x.device)

        acc = dict(sum_O=zeros(P), sum_E=zeros(), sum_absE=zeros(),
                   sum_E2=zeros(), sum_rawE2=zeros(), sum_EO=zeros(P),
                   sum_OO=gram_zero())
        if want_A:
            acc.update(sum_E2O=zeros(P), sum_E2OO=gram_zero(),
                       sum_EOO=gram_zero())
        if want_l2:
            acc.update(sum_l2=zeros(), sum_l2O=zeros(P),
                       sum_l2OO=gram_zero())

        def add(key, part):
            a = acc[key]
            if isinstance(a, dict):  # raw tri2 parts
                for s_acc, s_part in zip(a["t"], part["t"]):
                    s_acc += s_part
                a["m2"] += part["m2"]
            else:
                a += part

        def add_scalars(eloc, es):
            add("sum_E", es.sum())
            add("sum_absE", eloc.abs().sum())
            add("sum_E2", (es**2).sum())
            add("sum_rawE2", (eloc**2).sum())

        def chunk_plain(logp, eloc, O, gsum=gram_sum):
            Os = O - c_O
            es = eloc - c_E
            if gdt is not None:
                Os, es, logp, eloc = (v.to(gdt) for v in (Os, es, logp,
                                                          eloc))
            add_scalars(eloc, es)
            add("sum_O", Os.sum(0))
            add("sum_EO", stats.contract(es, Os, mode))
            add("sum_OO", gsum(Os))
            if want_A:
                w = es**2
                add("sum_E2O", stats.contract(w, Os, mode))
                add("sum_E2OO", gsum(Os, w))
                add("sum_EOO", gsum(Os, es))
            if want_l2:
                w = logp**2
                add("sum_l2", w.sum())
                add("sum_l2O", stats.contract(w, Os, mode))
                add("sum_l2OO", gsum(Os, w))
            return logp, eloc
        def chunk_pair(xc):
            logp, g, quad, pair, colsum, omax = self._ps_split(
                self.flow, theta_c, xc, self._hess_dirs, c_O)
            eloc = self.equation.eloc(xc, g, quad, t)
            es = eloc - c_E
            add_scalars(eloc, es)
            add("sum_O", colsum)
            # int8 scale bounds from the column max |O - c_O|: max|hi| <=
            # omax (1 + 2^-8) (monotone rounding), max|lo| <= omax 2^-8
            amax = (omax * (1.0 + 2.0**-8), omax * 2.0**-8)
            m2 = None
            if use_q8:
                (s_hi, inv_hi), (s_lo, inv_lo) = map(stats._int8_scales,
                                                     amax)
                es_hi, es_lo = stats._split_bf16(es.float())
                q8_hi, f_hi = quant8.quant_force(
                    pair[0].T, inv_hi, torch.stack([es_hi, es_lo], dim=1))
                q8_lo, f_lo = quant8.quant_force(pair[1].T, inv_lo,
                                                 es_hi[:, None])
                m2 = stats.cross_from_q8(q8_hi, q8_lo, s_hi, s_lo)
                add("sum_EO", f_hi[:, 0] + f_hi[:, 1] + f_lo[:, 0])
            else:
                add("sum_EO", stats.pair_vecmat(es, pair))
            if not self._cross_int8:
                amax = None
            if self._use_tri2:
                add("sum_OO", stats.tri2_gram_sum_raw_pair(
                    pair, self._tri2_bounds, cross_int8=self._cross_int8,
                    amax=amax, m2=m2))
            else:
                add("sum_OO", stats.sym2_gram_sum_pair(
                    pair, cross_int8=self._cross_int8, amax=amax, m2=m2))
            # the weighted moments split sqrt|w| (O - c_O) themselves
            O_s = (stats.pair_to_f32(pair) if want_A or want_l2
                   else None)
            if want_A:
                w = es**2
                add("sum_E2O", stats.pair_vecmat(w, pair))
                add("sum_E2OO", gram_sum(O_s, w))
                add("sum_EOO", gram_sum(O_s, es))
            if want_l2:
                w = logp**2
                add("sum_l2", w.sum())
                add("sum_l2O", stats.pair_vecmat(w, pair))
                add("sum_l2OO", gram_sum(O_s, w))
            return logp, eloc

        if use_pair:
            out = [chunk_pair(x[lo:hi]) for _, lo, hi, _ in pieces]
        elif span_q8:
            # every global chunk in order on every rank, so that the ranks
            # meet in the column-max reductions of the chunks that span
            # them
            mine = {k: (lo, hi, spans) for k, lo, hi, spans in pieces}
            out = []
            for k in range(n // c):
                if k in mine:
                    lo, hi, spans = mine[k]
                    batch = (pilot if k == first[0] else
                             self._per_sample_batch(theta_c, x[lo:hi], t))
                    out.append(chunk_plain(
                        *batch, gsum=span_gram_sum if spans else gram_sum))
                elif _chunk_spans(k, c, n_loc):
                    for _ in range(n_grams):
                        mesh.all_reduce_max(ctx, torch.zeros(
                            (2, P), dtype=torch.float32, device=x.device))
        else:
            out = [chunk_plain(*pilot)]
            for _, lo, hi, _ in pieces[1:]:
                out.append(chunk_plain(*self._per_sample_batch(
                    theta_c, x[lo:hi], t)))
        logp = torch.cat([o[0] for o in out])
        eloc = torch.cat([o[1] for o in out])

        grams = [k for k in ("sum_OO", "sum_E2OO", "sum_EOO", "sum_l2OO")
                 if k in acc]
        if ctx.world > 1:
            # assemble the tri2 strips per rank (the finish commutes with
            # the sum), then ONE all-reduce of every accumulated moment
            for key in grams:
                acc[key] = gram_fin(acc[key])
            keys = sorted(acc)
            acc = dict(zip(keys, mesh.all_reduce_sum(
                ctx, [acc[k] for k in keys])))
            gram_fin = lambda m: m  # noqa: E731
        acc.update(zip(grams, self._gather_rows([acc[k] for k in grams])))

        # Un-shift. With y = O - c_O and f = E - c_E: m_y = E[y],
        # S0 = E[y^T y] - m_y^T m_y, F0 = E[f y] - m_f m_y
        m_y = acc["sum_O"] / n
        m_f = acc["sum_E"] / n
        Eyy = gram_fin(acc["sum_OO"]) / n
        Efy = acc["sum_EO"] / n
        S0 = Eyy - torch.outer(m_y, m_y)
        F0 = Efy - m_f * m_y
        A = None
        if want_A:
            # A = E[fbar^2 ybar^T ybar], fbar = f - m_f, ybar = y - m_y,
            # from the raw moments by expanding fbar^2 = f^2 - 2 m_f f +
            # m_f^2
            M2 = (gram_fin(acc["sum_E2OO"]) / n
                  - 2.0 * m_f * gram_fin(acc["sum_EOO"]) / n
                  + m_f**2 * Eyy)
            v2 = acc["sum_E2O"] / n - 2.0 * m_f * Efy + m_f**2 * m_y
            s2 = acc["sum_E2"] / n - m_f**2
            A = (M2 - torch.outer(v2, m_y) - torch.outer(m_y, v2)
                 + s2 * torch.outer(m_y, m_y))
        SExp = None
        if want_l2:
            # SExp = E[l2 ybar^T ybar], l2 = logp^2, ybar = y - m_y
            El2y = acc["sum_l2O"] / n
            SExp = (gram_fin(acc["sum_l2OO"]) / n - torch.outer(El2y, m_y)
                    - torch.outer(m_y, El2y)
                    + acc["sum_l2"] / n * torch.outer(m_y, m_y))
        return dict(
            O=None,
            SExp=SExp,
            logp=logp,
            eloc=eloc,
            eloc_mean=m_f + c_E,
            eloc_abs_mean=acc["sum_absE"] / n,
            eloc_var=acc["sum_E2"] / n - m_f**2,
            eloc_sq_mean=acc["sum_rawE2"] / n,
            F0=F0,
            S0=S0,
            A=A,
        )

    def _observables(self, x, logp, aux):
        """Moments of the observables' batch (this rank's shard of it on a
        mesh: global means, the covariance around the global mean)."""
        ctx = self.ctx
        n = x.shape[0] * ctx.world
        mean, mean_logp = stats.global_means(ctx, [x, logp], n)
        xc = x - mean
        aux["x1"] = mean
        (aux["covar"],) = mesh.all_reduce_sum(
            ctx, [stats.second_moment_matrix(xc, n=n)])
        aux["entropy"] = -mean_logp
        moments = stats.global_means(ctx, [xc**m for m in (3, 4, 5, 6)], n)
        for m, v in zip((3, 4, 5, 6), moments):
            aux[f"x{m}"] = v
        return aux

    # ------------------------------------------------------------------
    def _rhs_impl(self, theta_c, t, key: int, z_ext=None,
                  with_obs: bool = True, chain_state=None,
                  stash_sexp: bool = False):
        """One RHS. ``z_ext``: latent draws to use instead of sampling
        (tests hand both packages the same draws; the global block on a
        mesh). Only the first stage of an integrator step records
        observables. ``chain_state`` (Metropolis latents): this rank's
        chains, advanced n / n_chains sweeps (chain-major samples) in place
        of the exact draw; the advanced state comes back in
        aux["_chain_state"] and the counts of all ranks in
        aux["mcmc_accepted"] (a device tensor) and aux["mcmc_proposed"].
        ``n`` below is the global sample count; x is this rank's rows."""
        cfg = self.cfg
        ctx = self.ctx
        params = self._unravel(theta_c)
        k_sample, k_obs, k_int, k_spec = (self._fold(key, i)
                                          for i in range(4))
        z = z_ext
        mcmc = None
        log_w = None
        if z is None and chain_state is not None:
            sweeps = self.n_samples // self.sampler.n_chains
            z, cs, acc = self._chain_fn(self._gen(k_sample), chain_state,
                                        self._rw_scale(),
                                        sweeps)
            n = sweeps * self.sampler.n_chains
            mcmc = dict(state=cs, acc=acc, prop=n)
            z = z.to(theta_c.dtype)
        else:
            if z is None and cfg.is_gamma != 1.0:
                # the tail-tempered importance proposal (TDVPConfig.is_gamma)
                z, log_w = self.flow.latent_sample_tempered(
                    self._gen(k_sample), params, self.n_samples,
                    cfg.is_gamma, theta_c.dtype)
                log_w = ctx.local_rows(log_w)
            elif z is None:
                z = self.flow.latent_sample(self._gen(k_sample), params,
                                            self.n_samples, theta_c.dtype)
            n = z.shape[0]
            z = ctx.local_rows(z)
        x, _ = self.flow.push(params, z)

        if self.solver_method == "cg":
            aux, logp, O = self._rhs_cg(theta_c, t, x)
        elif self.solver_method == "minsr":
            aux, logp, O = self._rhs_minsr(theta_c, t, x, n)
        else:
            aux, logp, O = self._rhs_stats(theta_c, t, x, n, log_w, k_spec)

        if cfg.observables and with_obs:
            # the IS batch is proposal-distributed: observables resample
            if self.n_samples_obs > n or log_w is not None:
                if mcmc is not None:
                    # the observables' budget continues the chains
                    sweeps = self.n_samples_obs // self.sampler.n_chains
                    z_o, mcmc["state"], acc = self._chain_fn(
                        self._gen(k_obs), mcmc["state"],
                        self._rw_scale(), sweeps)
                    mcmc["acc"] = mcmc["acc"] + acc
                    mcmc["prop"] += sweeps * self.sampler.n_chains
                    z_o = z_o.to(theta_c.dtype)
                else:
                    z_o = ctx.local_rows(self.flow.latent_sample(
                        self._gen(k_obs), params, self.n_samples_obs,
                        theta_c.dtype))
                x_o, logp_o = self.flow.push(params, z_o)
            else:
                x_o, logp_o = x, logp
            aux = self._observables(x_o, logp_o, aux)
            if cfg.integrals:
                # fresh points from their own key (the JAX package's k_int)
                ball = ctx.local_rows(unit_ball(
                    self._gen(k_int), self.n_samples_obs, self.flow.dim,
                    theta_c.dtype, self.device))
                aux.update(sphere_integrals(ctx, self.flow, params, ball,
                                            cfg.integral_T))
        if mcmc is not None:
            aux["_chain_state"] = mcmc["state"]
            aux["mcmc_accepted"] = mcmc["acc"]
            aux["mcmc_proposed"] = mcmc["prop"]
        if self._sexp_matfree and stash_sexp:
            # the matrix-free S metric's inputs (_sexp_quad): this stage's
            # point, samples, logp, IS weights and, on the direct path, O
            aux["_sexp"] = (theta_c, x, logp, log_w, O)
        # the host solve's update comes later, in rhs(): F0 stands in
        aux["nan"] = torch.isnan(aux.get("update", aux.get("F0"))).any()
        return aux

    def _eloc_moments(self, eloc):
        """The E_loc diagnostics of the Gram-free solvers, over every
        sample (this rank's rows on a mesh), and E[E_loc^2]."""
        ctx = self.ctx
        n = eloc.shape[0] * ctx.world
        mean, abs_mean, sq_mean = stats.global_means(
            ctx, [eloc, eloc.abs(), eloc**2], n)
        (var,) = stats.global_means(ctx, [(eloc - mean)**2], n)
        return dict(eloc_mean=mean, eloc_abs_mean=abs_mean, eloc_var=var,
                    max_grad=mesh.all_reduce_max(ctx, eloc.max())), sq_mean

    def _rhs_stats(self, theta_c, t, x, n, log_w, k_spec):
        """The Gram-based RHS (eigh, cholesky): the statistics, then the
        regularized solve on the device, or, for the host solve, S, S0,
        F0, A and E[E_loc^2] for rhs() to solve. Returns (aux, logp, O)
        with O the per-sample rows the direct statistics kept for the
        matrix-free S metric (else None)."""
        cfg = self.cfg
        if cfg.chunk_size and cfg.chunk_size < n:
            st = self._chunked_stats(theta_c, t, x)
        else:
            st = self._direct_stats(theta_c, t, x, log_w=log_w)
        S0, F0 = st["S0"], st["F0"]
        S = S0
        if cfg.diagonal_shift > 1e-10:
            S = S + torch.diag(cfg.diagonal_shift * torch.diag(S))
        aux = {}
        if not cfg.solve_on_device:
            aux.update(S=S, S0=S0, F0=F0, A=st["A"],
                       eloc_sq_mean=st["eloc_sq_mean"])
        else:
            aux.update(self._solve_device(S, S0, F0, st, n, k_spec))
        aux["eloc_mean"] = st["eloc_mean"]
        aux["eloc_abs_mean"] = st["eloc_abs_mean"]
        aux["eloc_var"] = st["eloc_var"]
        aux["max_grad"] = mesh.all_reduce_max(self.ctx, st["eloc"].max())
        if st.get("is_ess_share") is not None:
            # effective sample share 1 / E[w^2] of the mean-1 IS weights
            aux["is_ess_share"] = st["is_ess_share"]
        if st["SExp"] is not None:
            aux["SExp"] = st["SExp"]
        return aux, st["logp"], st["O"]

    def _solve_device(self, S, S0, F0, st, n, k_spec):
        """The regularized solve of S u = F0 on the device in the solve
        dtype: eigh with the reference's per-mode regularizers, or the
        Tikhonov-Cholesky solve with the top-k Ritz spectrum. Returns the
        solver's aux entries (update, residual, TDVP error, spectrum)."""
        cfg = self.cfg
        sdt = self.precision.solve
        S_s, F_s = S.to(sdt), F0.to(sdt)
        A_s = None if st["A"] is None else st["A"].to(sdt)
        aux = {}
        if self.solver_method == "eigh":
            update, ev, snr, _ = _solve_regularized(
                S_s, F_s, cfg, n, A=A_s, eigh=self._spectral_eigh)
            aux["ev"] = ev
            aux["snr"] = snr if snr is not None else torch.zeros_like(ev)
        else:
            lam_max = None
            V_k = None
            if cfg.spectrum_topk > 0:
                k = min(cfg.spectrum_topk, S.shape[0])
                ev_k, V_k = _randomized_topk_eigh(S_s, k, self._gen(k_spec),
                                                  eigh=self._ritz_eigh)
                lam_max = ev_k[-1]
                tr = torch.trace(S_s)
                aux["ev_topk"] = ev_k
                aux["spectrum_trace"] = tr
                aux["spectrum_tail_mass"] = tr - ev_k.sum()
                if A_s is not None:
                    VtF = V_k.T @ F_s
                    rho_var = ((V_k * (A_s @ V_k)).sum(0) - VtF**2).abs() \
                        .clamp_min(torch.finfo(VtF.dtype).tiny)
                    aux["snr_topk"] = (n * VtF**2 / rho_var).abs().sqrt()
            update, lam_max = _solve_cholesky(S_s, F_s, cfg, lam_max=lam_max)
            aux["lambda_max"] = lam_max
            if cfg.use_snr and "snr_topk" in aux:
                # Ritz-projected SNR gating: the per-mode soft cutoff inside
                # the top-k subspace, pass-through on its complement
                g = _soft_cutoff(aux["snr_topk"], cfg.snr_tol)
                update = update + V_k @ ((g - 1.0) * (V_k.T @ update))
        aux["solver_res"] = (torch.linalg.norm(S_s @ update - F_s)
                             / torch.linalg.norm(F_s))
        aux["tdvp_error"] = 1.0 + (update @ S0.to(sdt) @ update
                                   - 2.0 * F_s @ update) \
            / st["eloc_sq_mean"].to(sdt)
        aux["update"] = update
        return aux

    def _rhs_cg(self, theta_c, t, x):
        """Matrix-free RHS: the per-sample batch, then Jacobi-preconditioned
        CG on the Tikhonov normal equations (_solve_cg); S is never formed.
        The residual and the TDVP error come from matvecs against the
        unregularized S, as on the other paths. On a mesh the centering is
        global and every matvec is one all-reduce of P values over the
        ranks that hold other samples; the reduced values are the same
        bits on every rank, so every rank reads the same stopping flag.
        Returns (aux, logp, O)."""
        cfg, ctx = self.cfg, self.ctx
        n = x.shape[0] * ctx.world
        logp, eloc, O = self._per_sample_batch(theta_c, x, t)
        eloc = self._maybe_clip_eloc(eloc)
        e_mean, o_mean = stats.global_means(ctx, [eloc, O], n)
        e_c = eloc - e_mean
        O_c = O - o_mean
        gdt = stats.GRAM_OPERAND_DTYPE.get(cfg.gram_precision)
        if gdt is not None:
            O_c, e_c = O_c.to(gdt), e_c.to(gdt)
        update, F0, lam_max, sv, iters = _solve_cg(
            O_c, e_c, cfg, cfg.gram_precision, n=n,
            reduce=functools.partial(mesh.all_reduce_sum, ctx))
        s_u = sv(update)
        moments, sq_mean = self._eloc_moments(eloc)
        aux = dict(
            update=update,
            solver_res=torch.linalg.norm(s_u - F0) / torch.linalg.norm(F0),
            tdvp_error=1.0 + (update @ s_u - 2.0 * F0 @ update) / sq_mean,
            lambda_max=lam_max, _cg_iters=iters, **moments)
        return aux, logp, O

    def _rhs_minsr(self, theta_c, t, x, n):
        """Kernel-space RHS: the per-sample batch (or the streaming passes
        of _minsr_chunked when 0 < chunk_size < n), the N x N kernel's
        eigh and the minimum-norm update; the (P, P) Gram never exists.
        On a mesh the direct form gathers every rank's O rows and E_loc
        (T is N x N over all samples, as in the JAX package, where XLA
        gathers across the contraction) and every rank solves the same
        kernel system. Returns (aux, logp, O), O this rank's rows (None
        when streamed)."""
        cfg = self.cfg
        sdt = self.precision.solve
        O = None
        if cfg.chunk_size and cfg.chunk_size < n:
            logp, eloc, update, ev, snr, residual, tdvp_quad = \
                self._minsr_chunked(theta_c, t, x)
        else:
            logp, eloc, O = self._per_sample_batch(theta_c, x, t)
            eloc = self._maybe_clip_eloc(eloc)
            e_all = mesh.all_gather_rows(self.ctx, eloc)
            O_all = mesh.all_gather_rows(self.ctx, O)
            e_c = e_all - e_all.mean()
            O_c = O_all - O_all.mean(0)
            del O_all
            gdt = stats.GRAM_OPERAND_DTYPE.get(cfg.gram_precision)
            if gdt is not None:
                O_c, e_c = O_c.to(gdt), e_c.to(gdt)
            update, ev, snr, residual, tdvp_quad = _solve_minsr(
                O_c, e_c, cfg, cfg.gram_precision, sdt,
                use_sym2=self._use_sym2 or self._use_tri2)
        moments, sq_mean = self._eloc_moments(eloc)
        aux = dict(
            update=update, solver_res=residual,
            tdvp_error=1.0 + tdvp_quad / sq_mean.to(sdt),
            ev=ev, snr=snr if snr is not None else torch.zeros_like(ev),
            **moments)
        return aux, logp, O

    def _minsr_chunked(self, theta_c, t, x):
        """Streaming minSR: O never exists beyond two (chunk, P) blocks.
        Three passes over the chunks, each chunk through the per-sample
        route (the plain-mode kernel on the card):

        1. the mean of O and the per-sample logp and E_loc;
        2. the kernel blocks T[i, j] = G_i G_j^T for chunk pairs j <= i,
           G_k = O_k - mean(O): G_j made once and kept through the inner
           loop, G_i made again for each pair (the diagonal blocks by
           sym2_outer_sum where the sym2/tri2 backends are configured);
        3. u = sum_i G_i^T alpha_i.

        That is n_c (n_c + 3) / 2 + n_c per-sample evaluations for n_c
        chunks, against 1 for the direct path; passes 2 and 3 need only O
        and take no trace directions. The solver's diagnostics are
        kernel-space (_minsr_kernel_solve), so apart from mean(O) and u no
        P-sized array lives longer than two blocks.

        On a mesh the chunks are the global ones (_chunk_pieces: a rank
        takes its rows of each), in the order of the global rows. In pass
        2 each chunk's G_j is made by its rank and broadcast to the others
        in turn, and each rank fills T's blocks of its own chunks at or
        after j; the disjoint blocks then cross ranks in one all-reduce of
        N^2 values, so every rank holds the same T and solves the same
        kernel system. Collectives per RHS: the sums of pass 1 (O's, then
        E_loc's), a gather of the N centered E_loc, n_c broadcasts of a
        (chunk, P) block, the all-reduce of T and the one of u (P values):
        n_c + 5. Returns (logp, eloc, update, ev, snr, residual,
        tdvp_quad)."""
        cfg, ctx = self.cfg, self.ctx
        n_loc = x.shape[0]
        n = n_loc * ctx.world
        c = cfg.chunk_size
        if n % c:
            raise ValueError(
                f"sample budget {n} is not a multiple of chunk_size {c}")
        mode = cfg.gram_precision
        cdt = stats.GRAM_OPERAND_DTYPE.get(mode, self.precision.compute)
        sdt = self.precision.solve
        mine = _chunk_pieces(n_loc, ctx.rank, c)

        sum_O = torch.zeros(self.n_params, dtype=cdt, device=x.device)
        logps, elocs = [], []
        for _, lo, hi, _ in mine:
            logp, eloc, O = self._per_sample_batch(theta_c, x[lo:hi], t)
            sum_O += O.sum(0)
            logps.append(logp)
            elocs.append(eloc)
        del O
        (sum_O,) = mesh.all_reduce_sum(ctx, [sum_O])
        o_mean = sum_O / n
        logp, eloc = torch.cat(logps), torch.cat(elocs)
        (e_mean,) = stats.global_means(ctx, [eloc], n)
        e_c = mesh.all_gather_rows(ctx, eloc - e_mean)

        def centered(lo, hi):
            # O - mean(O), promoted to f64 through o_mean under "f64"
            return self._per_sample(self.flow, theta_c, x[lo:hi],
                                    None)[3] - o_mean

        use_s2 = self._use_sym2 or self._use_tri2
        T = torch.zeros((n, n), dtype=cdt, device=x.device)
        for shard in range(ctx.world):
            q0 = shard * n_loc
            for _, lq, hq, _ in _chunk_pieces(n_loc, shard, c):
                bq = slice(q0 + lq, q0 + hq)
                if shard == ctx.rank:
                    # the kernel's O rows are a transposed view: broadcast
                    # sends the storage as it lies
                    G_q = centered(lq, hq).contiguous()
                else:
                    G_q = torch.empty((hq - lq, self.n_params), dtype=cdt,
                                      device=x.device)
                mesh.broadcast(ctx, G_q, shard)
                for _, lp, hp, _ in mine:
                    bp = slice(ctx.rank * n_loc + lp, ctx.rank * n_loc + hp)
                    if bp.start < bq.start:
                        continue
                    if bp == bq:
                        T[bq, bq] = (stats.sym2_outer_sum(G_q) if use_s2
                                     else stats.contract(G_q, G_q.T, mode))
                        continue
                    blk = stats.contract(centered(lp, hp), G_q.T, mode)
                    T[bp, bq] = blk
                    T[bq, bp] = blk.T
        del G_q
        (T,) = mesh.all_reduce_sum(ctx, [T])
        alpha, ev, snr, residual, tdvp_quad = _minsr_kernel_solve(
            T, e_c, cfg, sdt)
        del T
        u = torch.zeros(self.n_params, dtype=cdt, device=x.device)
        for _, lo, hi, _ in mine:
            g = ctx.rank * n_loc
            u += stats.contract(alpha[g + lo:g + hi].to(cdt),
                                centered(lo, hi), mode)
        (u,) = mesh.all_reduce_sum(ctx, [u])
        return logp, eloc, u.to(sdt), ev, snr, residual, tdvp_quad

    def _host_solve(self, aux):
        """The host f64 solve (the reference's default path), from the
        S, S0, F0, A and E[E_loc^2] the RHS left in ``aux`` (popped):
        numpy's eigh with the regularizers, or the Tikhonov solve by
        np.linalg.solve with lambda_max from np.linalg.norm(S, 2) up to
        P = 512 and from power iteration above. The update goes back to
        the device; the diagnostics stay on the host. On a mesh, where
        every rank holds the same reduced moments, the coordinator alone
        solves and broadcasts the update with its diagnostics in one f64
        buffer, so theta stays bitwise equal across ranks."""
        moments = [aux.pop(k) for k in ("S", "S0", "F0", "A")]
        e2 = aux.pop("eloc_sq_mean")
        eigh = self.solver_method == "eigh"
        if self.mesh_ctx.world == 1:
            out = self._host_solve_numpy(moments, e2)
            out["update"] = out["update"].to(self.device)
            out["nan"] = torch.isnan(out["update"]).any()
            return out
        P = self.n_params
        sizes = dict(update=P, ev=P, snr=P) if eigh else dict(
            update=P, lambda_max=1)
        sizes.update(solver_res=1, tdvp_error=1)
        if mesh.is_coordinator():
            out = self._host_solve_numpy(moments, e2)
            flat = torch.cat([out[k].reshape(-1) for k in sizes])
        else:
            flat = torch.zeros(sum(sizes.values()), dtype=torch.float64)
        flat = mesh.broadcast_from_coordinator(flat.to(self.device))
        out, i = {}, 0
        for k, m in sizes.items():
            v = flat[i:i + m]
            out[k] = v if k == "update" else (
                v.cpu() if m > 1 else v.cpu()[0])
            i += m
        out["nan"] = torch.isnan(out["update"]).any()
        return out

    def _host_solve_numpy(self, moments, e2):
        """_host_solve's numpy f64 solve of the (S, S0, F0, A) moments;
        every output on the host."""
        S, S0, F0, A = (None if v is None
                        else v.detach().to("cpu", torch.float64)
                        for v in moments)
        e2 = float(e2)
        out = {}
        if self.solver_method == "eigh":
            update, ev, snr, _ = _solve_regularized(
                S, F0, self.cfg, self.n_samples, A=A, eigh=_numpy_eigh)
            out["ev"] = ev
            out["snr"] = snr if snr is not None else torch.zeros_like(ev)
        else:
            P = S.shape[0]
            lam_max = (float(np.linalg.norm(S.numpy(), 2)) if P <= 512
                       else float(_lambda_max(S)))
            lam = self.cfg.svd_tol * lam_max
            update = torch.from_numpy(np.linalg.solve(
                S.numpy() + lam * np.eye(P), F0.numpy()))
            out["lambda_max"] = torch.tensor(lam_max, dtype=torch.float64)
        out["solver_res"] = (torch.linalg.norm(S @ update - F0)
                             / torch.linalg.norm(F0))
        out["tdvp_error"] = 1.0 + (update @ S0 @ update
                                   - 2.0 * F0 @ update) / e2
        out["update"] = update
        return out

    @property
    def fused_steps_available(self) -> bool:
        """The fused steps and attempts solve inside the call, so they need
        the on-device solve; the host solve runs through rhs(), one stage
        at a time (the driver then passes the steppers no fused
        functions)."""
        return self.cfg.solve_on_device

    def _finish(self, aux):
        self.ev = aux.get("ev", aux.get("ev_topk"))
        self.snr = aux.get("snr", aux.get("snr_topk"))
        self.solverResidual = aux["solver_res"]
        self.tdvp_error = aux["tdvp_error"]
        self.ElocMean = aux["eloc_mean"]
        self.ElocVar = aux["eloc_var"]
        if "SExp" in aux:
            self.SExp = aux["SExp"]

    def _chain_inputs(self, key: int):
        """The chain state for a call keyed by ``key`` (None for exact
        latents); the first call starts the chains from fold_in(key,
        997)."""
        if not self._mcmc:
            return None
        return self.sampler.ensure_chain_state(fold_in(key, 997),
                                               self.device)

    def _absorb_mcmc(self, aux):
        """Hand a call's advanced chain state and counts to the sampler
        (the rw scale adapts there, between calls); nothing waits for the
        device."""
        cs = aux.pop("_chain_state", None)
        if cs is not None:
            self.sampler.note_fused_acceptance(cs, aux["mcmc_accepted"],
                                               aux["mcmc_proposed"])

    def rhs(self, theta, t, key: int, intStep: int = 0):
        """Host-facing RHS: theta in master dtype -> (dtheta master, aux).
        ``intStep`` decorrelates the random draws of an integrator's
        stages; only stage 0 records observables."""
        theta_c = theta.to(self.precision.compute)
        aux = self._rhs_impl(theta_c, t, fold_in(key, intStep),
                             with_obs=intStep % 5 == 0,
                             chain_state=self._chain_inputs(key),
                             stash_sexp=True)
        if not self.cfg.solve_on_device:
            aux.update(self._host_solve(aux))
        self._absorb_mcmc(aux)
        self._sexp_ctx = aux.pop("_sexp", None)
        self._finish(aux)
        return aux["update"].to(self.precision.master), aux

    # ------------------------------------------------------------------
    # Fused integrator steps: a whole step (fixed Heun or SSPRK3) or a whole
    # adaptive attempt in one call, with dt a Python float and the stage
    # arithmetic in compute dtype; the increment goes back to the
    # master-precision parameters (steppers.py). Stage i draws with
    # fold_in(key, off + i), the keys rhs() derives from intStep.
    # ------------------------------------------------------------------
    def _stage_runner(self, key: int, off: int, n_stages: int, z_ext=None,
                      chain_state=None):
        """(stage, out): stage(i, theta_c, t) -> k_i evaluates stage i on
        its own latent batch z_ext[i] (or its own draw). Only stage 0
        records observables; the chain state passes from stage to stage;
        every stage's NaN flag and Metropolis counts fold into stage 0's
        aux (out["aux"]); the last stage's aux (out["last"]) keeps its S
        metric: the dense SExp, or the matrix-free inputs."""
        zs = tuple(z_ext) if z_ext is not None else (None,) * n_stages
        out = dict(cs=chain_state, aux=None, last=None)

        def stage(i, theta_c, t):
            last = i == n_stages - 1
            aux = self._rhs_impl(theta_c, t, self._fold(key, off + i), zs[i],
                                 i == 0, out["cs"], stash_sexp=last)
            cs = aux.pop("_chain_state", None)
            if i == 0:
                out["aux"] = a0 = aux
            else:
                a0 = out["aux"]
                a0["nan"] = a0["nan"] | aux["nan"]
                if cs is not None:
                    for k in ("mcmc_accepted", "mcmc_proposed"):
                        a0[k] = a0[k] + aux[k]
            if cs is not None:
                out["cs"] = a0["_chain_state"] = cs
            if last:
                out["last"] = aux
            else:
                aux.pop("SExp", None)
            return aux["update"].to(theta_c.dtype)

        return stage, out

    def _heun_pair_impl(self, theta_c, t, dt, key, z_ext=None,
                        chain_state=None):
        """Fixed-Heun pair dy = dt/2 (k0 + k1) in compute dtype; the aux is
        the first stage's (observables at time t)."""
        stage, out = self._stage_runner(key, 0, 2, z_ext, chain_state)
        k0 = stage(0, theta_c, t)
        k1 = stage(1, theta_c + dt * k0, t + dt)
        return 0.5 * dt * (k0 + k1), out["aux"]

    def _rk3_triple_impl(self, theta_c, t, dt, key, z_ext=None,
                         chain_state=None):
        """Fixed SSPRK3 (Shu-Osher): y1 = y + dt k0, y2 = y + dt/4 (k0 +
        k1), dy = dt/6 (k0 + k1 + 4 k2), with k1 = f(y1, t + dt) and k2 =
        f(y2, t + dt/2)."""
        stage, out = self._stage_runner(key, 0, 3, z_ext, chain_state)
        k0 = stage(0, theta_c, t)
        k1 = stage(1, theta_c + dt * k0, t + dt)
        k2 = stage(2, theta_c + 0.25 * dt * (k0 + k1), t + 0.5 * dt)
        return dt / 6.0 * (k0 + k1 + 4.0 * k2), out["aux"]

    def _attempt_error(self, diff, out):
        """The attempt's error in the LAST stage's S metric at that stage's
        own point: the dense SExp, else the matrix-free quadratic, else
        the 2-norm. The stage-0 aux carries the SExp used (self.SExp)."""
        last = out["last"]
        sexp = last.pop("SExp", None)
        sx = last.pop("_sexp", None)
        if sexp is not None:
            out["aux"]["SExp"] = sexp
            return self.s_metric_norm(diff, sexp)
        if sx is not None:
            return self._sexp_quad(*sx, diff)
        return torch.linalg.norm(diff)

    def _heun_attempt_impl(self, theta_c, t, dt, key, off, z_ext=None,
                           chain_state=None):
        """One embedded adaptive-Heun attempt: the full step against two
        half steps, 5 stages, the error from the last one (at y3).
        ``off`` = 5 * attempt. Returns (dy1, err, aux)."""
        stage, out = self._stage_runner(key, off, 5, z_ext, chain_state)
        k0 = stage(0, theta_c, t)
        k1 = stage(1, theta_c + dt * k0, t + dt)
        dy0 = 0.5 * dt * (k0 + k1)
        k10 = stage(2, theta_c + 0.5 * dt * k0, t + 0.5 * dt)
        dy1 = 0.25 * dt * (k0 + k10)
        y2 = theta_c + dy1
        k01 = stage(3, y2, t + 0.5 * dt)
        y3 = y2 + 0.5 * dt * k01
        k11 = stage(4, y3, t + dt)
        dy1 = dy1 + 0.25 * dt * (k01 + k11)
        return dy1, self._attempt_error(dy1 - dy0, out), out["aux"]

    def _rk23_attempt_impl(self, theta_c, t, dt, key, off, z_ext=None,
                           chain_state=None):
        """One embedded Bogacki-Shampine 3(2) attempt: 4 stages, the
        third-order dy3 accepted, the error against the second-order dy2
        from the last stage (at theta + dy3). Returns (dy3, err, aux)."""
        stage, out = self._stage_runner(key, off, 4, z_ext, chain_state)
        k0 = stage(0, theta_c, t)
        k1 = stage(1, theta_c + 0.5 * dt * k0, t + 0.5 * dt)
        k2 = stage(2, theta_c + 0.75 * dt * k1, t + 0.75 * dt)
        dy3 = dt * (2.0 / 9.0 * k0 + 1.0 / 3.0 * k1 + 4.0 / 9.0 * k2)
        k3 = stage(3, theta_c + dy3, t + dt)
        dy2 = dt * (7.0 / 24.0 * k0 + 0.25 * k1 + 1.0 / 3.0 * k2
                    + 0.125 * k3)
        return dy3, self._attempt_error(dy3 - dy2, out), out["aux"]

    def _fused(self, impl, theta, key, *args, z_ext=None):
        """Run a fused step or attempt from master-precision theta; the
        outputs with dy in the master dtype."""
        if not self.fused_steps_available:
            raise ValueError("the fused steps solve on the device; with "
                             "solve_on_device=False step through rhs() "
                             "(TDVP.fused_steps_available)")
        res = impl(theta.to(self.precision.compute), *args, z_ext=z_ext,
                   chain_state=self._chain_inputs(key))
        aux = res[-1]
        self._absorb_mcmc(aux)
        self._finish(aux)
        return (res[0].to(self.precision.master),) + tuple(res[1:])

    def heun_pair(self, theta, t, dt, key: int, z_ext=None):
        """(dy master, aux) for a whole fixed-Heun step. ``z_ext``: one
        latent batch per stage."""
        return self._fused(self._heun_pair_impl, theta, key, t, dt, key,
                           z_ext=z_ext)

    def rk3_triple(self, theta, t, dt, key: int, z_ext=None):
        """(dy master, aux) for a whole fixed SSPRK3 step."""
        return self._fused(self._rk3_triple_impl, theta, key, t, dt, key,
                           z_ext=z_ext)

    def heun_attempt(self, theta, t, dt, key: int, attempt: int = 0,
                     z_ext=None):
        """(dy master, err, aux) for a whole adaptive-Heun attempt; err is
        a 0-dim device tensor (the caller decides when to wait for it)."""
        return self._fused(self._heun_attempt_impl, theta, key, t, dt, key,
                           5 * attempt, z_ext=z_ext)

    def rk23_attempt(self, theta, t, dt, key: int, attempt: int = 0,
                     z_ext=None):
        """(dy master, err, aux) for a whole Bogacki-Shampine attempt."""
        return self._fused(self._rk23_attempt_impl, theta, key, t, dt, key,
                           5 * attempt, z_ext=z_ext)

    # ------------------------------------------------------------------
    # Multi-step dispatch: a batch of K steps per call, the JAX package's
    # heun_multi / adaptive_multi (vmc_pde_tpu/solver/tdvp.py:2305-2584).
    # On one CUDA device each step of a batch replays a captured program
    # (solver/graphs.py): one host read per batch. On the CPU, on a mesh
    # and on the paths of graphs_available's list the same step functions
    # run eagerly: the plain version.
    # ------------------------------------------------------------------
    # the adaptive attempts a captured step holds (one IF node each); a
    # step that needs more finishes on the host after its batch
    max_graph_attempts = 4

    @property
    def graphs_refusal(self):
        """Why the batched steps run eagerly, or None where they replay
        CUDA graphs: one CUDA device and the device solve by eigh or
        cholesky, with no eigensolve that waits for the host."""
        if self.device.type != "cuda":
            return f"the device is {self.device.type}"
        if self.mesh_ctx.world > 1:
            return "a mesh (its collectives wait for the host)"
        if not self.cfg.solve_on_device:
            return "the host solve"
        if self.solver_method not in ("eigh", "cholesky"):
            return (f"solver_method={self.solver_method!r} (cg reads its "
                    f"flag every CG_CHECK_EVERY iterations; minsr)")
        if (self.solver_method == "eigh"
                and self._spectral_eigh is not jacobi.eigh):
            return (f"the spectral solve of P={self.n_params} by "
                    f"torch.linalg.eigh (above the Jacobi kernel's reach)")
        if (self.solver_method == "cholesky" and self.cfg.spectrum_topk > 0
                and self._ritz_eigh is not jacobi.eigh):
            return (f"the top-k Ritz solve of order {self._ritz_order} by "
                    f"torch.linalg.eigh (above the Jacobi kernel's reach)")
        return None

    @property
    def graphs_available(self) -> bool:
        """Whether the batched steps replay CUDA graphs (graphs_refusal)."""
        return self.graphs_refusal is None

    def release_graphs(self) -> None:
        """Free every captured program and its memory pools."""
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()

    def _capture(self, prog, fn, root):
        self._program = prog
        try:
            prog.capture(fn, root)
        finally:
            self._program = None

    def _set_graph_rw(self):
        """The random-walk scale of this batch into the programs' device
        buffer (the scale adapts between batches, as in the JAX package)."""
        rw = self.sampler.chain_rw_scale() if self._mcmc else None
        if rw is None:
            return
        if self._graph_rw is None:
            self._graph_rw = torch.zeros((), dtype=torch.float64,
                                         device=self.device)
        if isinstance(rw, torch.Tensor):
            self._graph_rw.copy_(rw)
        else:
            self._graph_rw.fill_(float(rw))

    def _fixed_step(self, kind, theta, t, dt, key, cs):
        """One fixed step of a batch from the master theta: (theta', chain
        state', the step's aux with dist_params of theta'). t and dt are
        floats, or 0-dim f64 device tensors inside a captured step."""
        impl = self._rk3_triple_impl if kind == "rk3" else self._heun_pair_impl
        compute = self.precision.compute
        dy, aux = impl(theta.to(compute), t, dt, key, chain_state=cs)
        cs = aux.pop("_chain_state", cs)
        theta = theta + dy.to(self.precision.master)
        aux = _batch_row(aux)
        aux["dist_params"] = self._unravel(
            theta.to(compute))["latent"]["dist_params"]
        return theta, cs, aux

    def _fixed_program(self, kind, theta, cs, root):
        """The captured fixed step (kind "heun" or "rk3") on static
        buffers: theta (master), sc = (t, dt) in f64, the chain state."""
        name = ("multi", kind)
        if name in self._programs:
            return self._programs[name]
        buf = dict(theta=theta.clone(),
                   sc=torch.zeros(2, dtype=torch.float64, device=self.device),
                   cs=None if cs is None else cs.clone())

        def step(key):
            th, c, aux = self._fixed_step(kind, buf["theta"], buf["sc"][0],
                                          buf["sc"][1], key, buf["cs"])
            buf["theta"].copy_(th)
            if c is not None:
                buf["cs"].copy_(c)
            return aux

        prog = graphs.Program(self.device, fold_in)
        prog.buffers = buf
        self._set_graph_rw()
        self._capture(prog, step, root)
        self._programs[name] = prog
        return prog

    def heun_multi(self, theta, ts, dts, keys, kind: str = "heun"):
        """Run ``len(ts)`` fixed steps (kind "heun": the Heun pair, "rk3":
        the SSPRK3 triple) with the per-step keys ``keys`` (the driver's
        fold_in(sample_seed + 7, n_step)). Returns (theta master, the
        stacked aux rows), each row with the post-step dist_params. The
        per-call diagnostic attributes (ev, snr, ...) are not updated, as
        in the JAX package. On one CUDA device every step is a replay of
        the captured step; the steps are those of heun_pair / rk3_triple
        bit for bit."""
        if not self.fused_steps_available:
            raise ValueError("heun_multi needs the on-device solve "
                             "(TDVP.fused_steps_available)")
        if kind not in ("heun", "rk3"):
            raise ValueError(f"unknown fixed kind {kind!r}")
        theta = theta.to(self.precision.master)
        cs = self._chain_inputs(keys[0])
        rows = []
        if self.graphs_available:
            prog = self._fixed_program(kind, theta, cs, keys[0])
            buf = prog.buffers
            buf["theta"].copy_(theta)
            if cs is not None:
                buf["cs"].copy_(cs)
            self._set_graph_rw()
            for t, dt, key in zip(ts, dts, keys):
                buf["sc"][0].fill_(float(t))
                buf["sc"][1].fill_(float(dt))
                prog.replay(key)
                rows.append(_copy_row(prog.outputs))
            theta = buf["theta"].clone()
            cs = None if cs is None else buf["cs"].clone()
        else:
            for t, dt, key in zip(ts, dts, keys):
                theta, cs, aux = self._fixed_step(kind, theta, float(t),
                                                  float(dt), key, cs)
                rows.append(aux)
        auxs = _stack_rows(rows)
        self._absorb_rows(cs, auxs)
        return theta, auxs

    def _absorb_rows(self, cs, auxs, n=None):
        """A batch's chain state and its first ``n`` rows' counts to the
        sampler (the rw scale adapts there, between batches)."""
        if cs is None:
            return
        acc, prop = auxs["mcmc_accepted"][:n], auxs["mcmc_proposed"][:n]
        self.sampler.note_fused_acceptance(cs, acc.sum(), int(prop.sum()))

    def _adaptive_slot(self, kind, buf, key, branch, n_attempts, t_end,
                       t_eps, tol, max_step, exact):
        """One slot of an adaptive batch on device tensors: the JAX
        package's step_body of _adaptive_multi_impl. buf holds theta
        (master), st = (t, dt_sugg, dt_prev) in f64, ``halted`` and the
        chain state, all updated in place. Up to ``n_attempts`` attempts,
        each under ``branch(need, attempt)`` (an IF node in the captured
        step, eager_if otherwise), with the controller in f64: fe = tol /
        err (inf at err <= 0), dt scale clamp(0.9 fe^(1/3), 0.2, 2), the
        max_step cap, the uncapped suggestion carried, ``exact`` clamping
        each attempt at t_end - t; attempt a draws with offset 5 a. A slot
        is active while the driver's loop condition holds and no earlier
        slot of the batch is halted; a slot whose last attempt still fails
        halts the batch (``overflow``) and is finished on the host.
        Returns the slot's outputs, rows of an inactive slot zero."""
        master, compute = self.precision.master, self.precision.compute
        impl = (self._rk23_attempt_impl if kind == "rk23"
                else self._heun_attempt_impl)
        st = buf["st"]
        t, dt_sugg, dt_prev = st[0], st[1], st[2]
        active = ((t < t_end - t_eps) if exact else (t < t_end + dt_prev))
        active = active & ~buf["halted"]
        cap = t_end - t
        dt = torch.minimum(dt_sugg, cap) if exact else dt_sugg.clone()
        need = active.clone()
        dev = buf["theta"].device
        c = dict(dy=torch.zeros(self.n_params, dtype=compute, device=dev),
                 real_dt=dt.clone(), dt_free=dt.clone(),
                 err=torch.zeros((), dtype=master, device=dev),
                 attempts=torch.zeros((), dtype=torch.int64, device=dev),
                 acc=torch.zeros((), dtype=torch.int64, device=dev),
                 cs=None if buf["cs"] is None else buf["cs"].clone())
        theta_c = buf["theta"].to(compute)

        def attempt(a):
            dy, err, aux = impl(theta_c, t, dt, key, 5 * a,
                                chain_state=c["cs"])
            cs = aux.pop("_chain_state", None)
            errm = err.to(master)
            fe = torch.where(errm > 0.0, tol / errm,
                             torch.full_like(errm, math.inf))
            scale = torch.clamp(0.9 * fe ** (1.0 / 3.0), 0.2, 2.0)
            dt_free = torch.clamp_max(dt * scale, max_step)
            dt_next = torch.minimum(dt_free, cap) if exact else dt_free
            c["dy"].copy_(dy)
            c["real_dt"].copy_(dt)
            c["dt_free"].copy_(dt_free)
            c["err"].copy_(errm)
            c["attempts"].add_(1)
            row = _batch_row(aux)
            if cs is not None:
                c["cs"].copy_(cs)
                c["acc"].add_(row.pop("mcmc_accepted"))
                # a constant of the step: the host multiplies it by the
                # attempts after the batch
                buf["proposed"] = row.pop("mcmc_proposed")
            if buf["aux"] is None:
                buf["aux"] = {k: v.clone() for k, v in row.items()}
            else:
                for k, v in buf["aux"].items():
                    v.copy_(row[k])
            dt.copy_(dt_next)
            need.copy_(fe < 1.0)

        for a in range(n_attempts):
            branch(need, functools.partial(attempt, a))
        if buf["aux"] is None:
            raise RuntimeError("an adaptive batch whose first slot is not "
                               "active")
        done = active & ~need
        theta_new = buf["theta"] + c["dy"].to(master)
        zero = torch.zeros((), dtype=master, device=dev)

        def masked(v):
            return torch.where(done, v, torch.zeros_like(v))

        rows = {k: masked(v) for k, v in buf["aux"].items()}
        if c["cs"] is not None:
            rows["mcmc_accepted"] = masked(c["acc"])
        rows["attempts"] = masked(c["attempts"])
        rows["step_error"] = masked(c["err"])
        rows["dist_params"] = masked(self._unravel(
            theta_new.to(compute))["latent"]["dist_params"])
        out = dict(aux=rows, t_at=t.clone(),
                   dt_used=torch.where(done, c["real_dt"], zero),
                   active=done, overflow=need.clone(), dt_next=dt,
                   attempts=c["attempts"], acc=c["acc"], cs=c["cs"])
        st_new = torch.stack([
            torch.where(done, t + c["real_dt"], t),
            torch.where(done, c["dt_free"], dt_sugg),
            torch.where(done, c["real_dt"], dt_prev)])
        buf["theta"].copy_(torch.where(done, theta_new, buf["theta"]))
        st.copy_(st_new)
        buf["halted"].copy_(buf["halted"] | need)
        if c["cs"] is not None:
            buf["cs"].copy_(c["cs"])
        return out

    def _adaptive_buffers(self, theta, cs):
        """An adaptive batch's state: theta (master), st = (t, dt_sugg,
        dt_prev) in f64, the halt flag, the chain state, and the rows'
        carry, made by the first attempt."""
        dev = self.device
        return dict(theta=theta.clone(),
                    st=torch.zeros(3, dtype=torch.float64, device=dev),
                    halted=torch.zeros((), dtype=torch.bool, device=dev),
                    cs=None if cs is None else cs.clone(), aux=None,
                    proposed=0)

    @staticmethod
    def _start_batch(buf, theta, t, dt_sugg, dt_prev, cs):
        """A batch's inputs into its buffers, with device ops only."""
        buf["theta"].copy_(theta)
        for i, v in enumerate((t, dt_sugg, dt_prev)):
            buf["st"][i].fill_(float(v))
        buf["halted"].zero_()
        if cs is not None:
            buf["cs"].copy_(cs)

    def adaptive_multi(self, theta, t, dt_sugg, dt_prev, keys, t_end, t_eps,
                       tol, max_step, kind: str = "heun",
                       exact: bool = False):
        """Up to ``len(keys)`` adaptive steps (kind "heun" or "rk23") with
        the retry loop and the dt controller on the device. ``dt_sugg``:
        the stepper's carried (uncapped) dt; ``dt_prev``: the last step's
        dt_used (the loop condition's dt). Returns (theta_f master, t_f,
        dt_sugg_f, dt_prev_f as floats, outs) with outs = {"aux": the
        stacked rows (dist_params, attempts, step_error and the summed
        Metropolis counts added; no SExp), "t_at", "dt_used", "attempts",
        "active", "nan" (whether a row's update is NaN, a bool)}: rows
        past the first inactive slot are zero. One host read per batch
        (the flags, the NaN flag and the final times); a slot that needs
        more than max_graph_attempts attempts finishes on the host after
        it (``host_finished`` counts them) and ends the batch."""
        if not self.fused_steps_available:
            raise ValueError("adaptive_multi needs the on-device solve "
                             "(TDVP.fused_steps_available)")
        if kind not in ("heun", "rk23"):
            raise ValueError(f"unknown adaptive kind {kind!r}")
        master = self.precision.master
        theta = theta.to(master)
        cs = self._chain_inputs(keys[0])
        A = self.max_graph_attempts
        consts = (float(t_end), float(t_eps), float(tol), float(max_step),
                  bool(exact))
        K = len(keys)
        if self.graphs_available:
            name = ("amulti", kind, A) + consts
            prog = self._programs.get(name)
            if prog is None:
                buf = self._adaptive_buffers(theta, cs)
                self._start_batch(buf, theta, t, dt_sugg, dt_prev, cs)
                prog = graphs.Program(self.device, fold_in, bodies=True)
                prog.buffers = buf
                self._set_graph_rw()
                self._capture(prog, lambda key: self._adaptive_slot(
                    kind, buf, key, prog.run_if, A, *consts), keys[0])
                self._programs[name] = prog
            buf = prog.buffers
            self._start_batch(buf, theta, t, dt_sugg, dt_prev, cs)
            self._set_graph_rw()
            outs = []
            for key in keys:
                prog.replay(key)
                outs.append(_copy_row(prog.outputs))
        else:
            buf = self._adaptive_buffers(theta, cs)
            self._start_batch(buf, theta, t, dt_sugg, dt_prev, cs)
            outs = [self._adaptive_slot(kind, buf, key, graphs.eager_if, A,
                                        *consts) for key in keys]
        # the batch's one host read: which slots ran or halted, where the
        # batch ended, the attempts, and whether a row holds a NaN update
        flags = torch.cat([torch.stack([o["active"] for o in outs]),
                           torch.stack([o["overflow"] for o in outs]),
                           torch.stack([o["aux"]["nan"] for o in outs])
                           .any()[None]])
        host = torch.cat([flags.to(torch.float64), buf["st"],
                          torch.stack([o["attempts"] for o in outs])
                          .to(torch.float64)]).tolist()
        active = [bool(v) for v in host[:K]]
        overflow = [bool(v) for v in host[K:2 * K]]
        nan = bool(host[2 * K])
        t_f, dt_sugg_f, dt_prev_f = host[2 * K + 1:2 * K + 4]
        attempts = [int(v) for v in host[2 * K + 4:]]
        theta_f = buf["theta"].clone()
        cs_f = None if cs is None else buf["cs"].clone()
        rows = [o["aux"] for o in outs]
        dt_used = [o["dt_used"] for o in outs]
        if cs is not None:
            for row, n in zip(rows, attempts):
                row["mcmc_proposed"] = n * buf["proposed"]
        if True in overflow:
            i = overflow.index(True)
            theta_f, cs_f, rows[i], (t_f, dt_sugg_f, dt_prev_f) = \
                self._finish_on_host(kind, outs[i], theta_f, keys[i], t_f,
                                     t_end, tol, max_step, exact, A,
                                     buf["proposed"])
            dt_used[i] = torch.full((), dt_prev_f, dtype=master,
                                    device=self.device)
            active[i] = True
            nan = nan or bool(rows[i]["nan"])
        stacked = _stack_rows(rows)
        self._absorb_rows(cs_f, stacked, sum(active))
        out = {"aux": stacked, "t_at": torch.stack([o["t_at"] for o in outs]),
               "dt_used": torch.stack(dt_used),
               "attempts": stacked["attempts"],
               "active": torch.tensor(active), "nan": nan}
        return theta_f, t_f, dt_sugg_f, dt_prev_f, out

    def _finish_on_host(self, kind, out, theta, key, t, t_end, tol,
                        max_step, exact, first, proposed):
        """The rest of a slot whose ``first`` captured attempts all failed:
        the host's retry loop (steppers.AdaptiveHeun) from attempt
        ``first`` at the device controller's next dt, with the chain state
        and counts the attempts left (``proposed`` per attempt). Returns
        (theta', chain state', the row, (t', dt_sugg', dt_prev'))."""
        from .steppers import AdaptiveHeun, AdaptiveRK23

        self.host_finished += 1
        cls = AdaptiveRK23 if kind == "rk23" else AdaptiveHeun
        fn = self.rk23_attempt if kind == "rk23" else self.heun_attempt
        stepper = cls(timeStep=float(out["dt_next"]), tol=tol,
                      maxStep=max_step, attempt_fn=fn)
        counts = None
        if out["cs"] is not None:
            self.sampler.set_chain_state(out["cs"])
            counts = (out["acc"], first * proposed)
        res = stepper.step(t, None, theta, key,
                           dt_cap=t_end - t if exact else None,
                           first_attempt=first, counts=counts)
        info = _batch_row(res.info)
        dev, master = self.device, self.precision.master
        info["step_error"] = torch.full((), info["step_error"],
                                        dtype=master, device=dev)
        info["attempts"] = torch.full((), info["attempts"],
                                      dtype=torch.int64, device=dev)
        info["dist_params"] = self._unravel(res.y.to(
            self.precision.compute))["latent"]["dist_params"]
        cs = self.sampler.chain_state() if out["cs"] is not None else None
        return res.y, cs, info, (t + res.dt_used, stepper.dt, res.dt_used)

    # ------------------------------------------------------------------
    # The S metric of the adaptive steppers' error norm.
    # ------------------------------------------------------------------
    def s_metric_norm(self, v, S):
        """v^T S v in the solve dtype (the reference's norm_fun)."""
        v = v.to(self.precision.solve)
        return v @ (S.to(self.precision.solve) @ v)

    def _sexp_a(self, theta_c, x, v, O=None):
        """a_n = O_n . v on this rank's rows: one product with the kept O
        (direct statistics), else the per-sample route (the plain-mode
        kernel on the card) re-run chunk by chunk on the samples at
        theta_c, without trace directions, each chunk's O contracted and
        dropped."""
        v = v.to(theta_c.dtype)
        if O is not None:
            return O @ v
        n = x.shape[0]
        c = self.cfg.chunk_size // self.ctx.world or n
        return torch.cat([
            self._per_sample(self.flow, theta_c, x[i:i + c], None)[3] @ v
            for i in range(0, n, c)])

    def _sexp_quad(self, theta_c, x, logp, log_w, O, v):
        """Matrix-free v^T SExp v = E[w logp^2 (a - E[w a])^2], a = O v,
        w the self-normalized IS weights (1 without ``log_w``), returned in
        the solve dtype. On a mesh x, logp, log_w and O are this rank's
        rows: the weights' max crosses ranks first, then the five sums in
        one all-reduce. The sums are taken in f64 whatever the solve dtype:
        the one-pass variance s4 - 2 m s3 + m^2 s2 cancels as (m / spread)^2
        where the JAX package centres a first, and f64 keeps that below
        a's own f32 rounding without a second all-reduce for m."""
        ctx, f64 = self.ctx, torch.float64
        a = self._sexp_a(theta_c, x, v, O).to(f64)
        l2 = logp.to(f64) ** 2
        if log_w is None:
            w = torch.ones_like(a)
        else:
            lw = log_w.to(f64)
            w = torch.exp(lw - mesh.all_reduce_max(ctx, lw.max()))
        wl2 = w * l2
        s0, s1, s2, s3, s4 = mesh.all_reduce_sum(ctx, [torch.stack([
            w.sum(), (w * a).sum(), wl2.sum(), (wl2 * a).sum(),
            (wl2 * a * a).sum()])])[0]
        m = s1 / s0
        return ((s4 - 2.0 * m * s3 + m * m * s2) / s0).to(
            self.precision.solve)

    def stepper_norm(self, v, S=None):
        """A per-stage adaptive stepper's error norm (its normFunction):
        v^T S v with the dense SExp S of the last rhs() call, else the
        matrix-free quadratic at that call's stage, else the 2-norm."""
        if S is not None:
            return self.s_metric_norm(v, S)
        if self._sexp_matfree:
            return self.sexp_norm(v)
        return torch.linalg.norm(v)

    def sexp_norm(self, v):
        """The matrix-free S metric of v at the last rhs() call's stage
        (its theta, samples and O): the per-call stepper's stand-in for
        the dense SExp."""
        if self._sexp_ctx is None:
            raise RuntimeError("sexp_norm needs a prior rhs() call with the "
                               "matrix-free S metric (sexp_mode 'matfree' "
                               "or 'auto' off eigh)")
        return self._sexp_quad(*self._sexp_ctx, v)
