"""Experiment configuration, the counterpart of vmc_pde_tpu/config.py:
all of its presets. Field names and defaults follow the JAX package's
RunConfig; ``aot_dir`` (an XLA executable cache: eager torch compiles
nothing ahead of time) is left out, and ``device`` is new: the port runs
on one explicit torch device per rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class RunConfig:
    # problem
    name: str = "mwe"
    dim: int = 2
    offset: Tuple[float, ...] = (0.0, 0.0)
    equation: str = "diffusion"
    equation_params: dict = dataclasses.field(default_factory=dict)

    # model (depth 4, hidden (dim//2,))
    depth: int = 4
    hidden: Optional[Tuple[int, ...]] = None
    variant: str = "scale"
    global_affine: bool = False
    latent_name: str = "Gauss"
    alpha: float = 10.0
    init_scale: float = 1e-5
    seed: int = 1
    # randomized-QMC (scrambled Sobol) exact-latent draws
    # (sampling/qmc.py): Gauss and Student_t latents only; the MCMC
    # presets ignore it
    qmc: bool = False

    # sampling
    sample_seed: int = 1
    n_chains: int = 30
    mcmc_bound: float = 0.25
    # MCMC proposal: "independence" (uniform ball covering the support,
    # the reference's) or "rw" (Gaussian random walk with acceptance-
    # adapted scale, for unbounded latent targets; sampling/sampler.py)
    proposal_mode: str = "independence"
    rw_scale: float = 0.5
    n_samples_tdvp: int = 10000
    n_samples_obs: int = 10000

    # TDVP solver (solver/tdvp.py TDVPConfig)
    use_snr: bool = False
    snr_tol: float = 2.0
    svd_tol: float = 1e-11
    # > 0: winsorize Eloc at this many robust (MAD) sigmas (direct
    # statistics only; solver/tdvp.py _maybe_clip_eloc)
    eloc_clip: float = 0.0
    # < 1: tail-tempered importance sampling of the TDVP statistics batch
    # (Student_t latent; TDVPConfig.is_gamma)
    is_gamma: float = 1.0
    diagonal_shift: float = 0.0
    # False: solve the regularized system on the host in numpy f64 (the
    # reference's default path; eigh and cholesky)
    solve_on_device: bool = True
    solver_method: str = "auto"     # auto | eigh | cholesky | cg | minsr
    eigh_max_params: int = 2048     # "auto" switches eigh->cholesky here
    gram_precision: str = "high"    # highest | high | default | f64 |
                                    # f64acc (parallel/stats.py)
    gram_backend: str = "auto"      # auto | xla | syrk | sym2 | tri2
    gram_cross: str = "auto"        # auto | bf16 | int8 (split cross pass)
    hessian_mode: str = "auto"      # auto | trace | block (TDVPConfig)
    # auto | torch | cuda (the JAX package's xla | pallas)
    per_sample_backend: str = "auto"
    cg_maxiter: int = 250
    cg_tol: float = 1e-7
    # floor svd_tol at 64 eps of the statistics' dtype (TDVPConfig)
    auto_tol_floor: bool = True
    # > 0: stream the statistics in chunks of this many samples
    chunk_size: int = 0
    # the MC integrals of p over three balls in the observables
    # (TDVPConfig.integrals; no flag, as in the JAX package)
    integrals: bool = False

    # time integration: fixed_heun | fixed_euler | fixed_rk3 |
    # adaptive_heun | adaptive_rk23 (solver/steppers.py)
    stepper: str = "fixed_heun"
    dt0: float = 1e-7
    max_step: float = 1e-2
    increase_fac: float = 1.3
    tol: float = 1e-2               # adaptive stepper tolerance
    t_end: float = 5.0
    # clamp the last dt to land on t_end (the reference's loop overshoots
    # by up to one dt)
    exact_t_end: bool = False
    # > 1: check the NaN flags once every that many steps instead of every
    # nan_check_every (driver.run)
    steps_per_dispatch: int = 1

    # statistics on a mesh: auto | shard_map | gspmd (TDVPConfig)
    stats_partitioning: str = "auto"

    # runtime
    precision: str = "tpu"          # tpu | tpu_f64stats | f32 | f64
    device: str = "cuda"            # torch device; cuda raises without one
    # mesh over the process group (parallel/mesh.py): dp sample shards
    # (-1: all ranks) times tp (more sample shards on the shard_map stats)
    mesh_dp: int = -1
    mesh_tp: int = 1

    # diagnostics / io
    grid_bound: float = 10.0
    sym_grid: bool = True
    grid_points: int = 200
    plot_every: float = 1.0
    workdir: Optional[str] = None
    # also stream each step's infos (times, dt, the stepper's diagnostics,
    # dist_params) through the native recorder (native/recorder.cpp) into
    # <workdir>/metrics.bin: one host read per step, the file written by a
    # background thread (utils/recorder.py). Needs workdir
    async_recorder: bool = False
    checkpoint_every: int = 0       # steps; 0 = off (utils/checkpoint.py)
    resume: bool = False            # resume from workdir's latest checkpoint
    # start from stored parameters instead of the random init: an npz
    # holding theta (an evolution checkpoint, or pretrain/train.py's
    # <workdir>/pretrain_ckpt.npz); the flow must be the one that wrote it
    init_params: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler trace of a window
    profile_steps: Tuple[int, int] = (5, 8)  # [start, end) steps traced
    nan_check_every: int = 10
    verbose: bool = True

    def hidden_resolved(self) -> Tuple[int, ...]:
        return tuple(self.hidden) if self.hidden else (max(self.dim // 2, 1),)


PRESETS = {
    # 2-D Gaussian diffusion, the reference's minimal example
    "mwe": RunConfig(
        name="mwe", dim=2, offset=(0.0, 0.0), latent_name="Gauss",
        equation="diffusion", variant="scale",
        dt0=1e-7, max_step=1e-2, grid_bound=10.0,
    ),
    # Liouville transport of a 2-D Gaussian by the harmonic oscillator's
    # symplectic flow (no Hessian)
    "harmonicOsc": RunConfig(
        name="harmonicOsc", dim=2, offset=(1.0, 1.0), latent_name="Gauss",
        equation="advection_hamiltonian", variant="affine",
        dt0=1e-4, max_step=1e-2, grid_bound=8.0,
    ),
    # phase-space Fokker-Planck of three uncoupled oscillators (d=6)
    "harmonicOsc_diff": RunConfig(
        name="harmonicOsc_diff", dim=6,
        offset=(1.0, 0.0, 0.0, 1.0, 0.0, 0.0), latent_name="Gauss",
        equation="advection_hamiltonian_wDiss", variant="affine",
        dt0=1e-4, max_step=1e-2, grid_bound=8.0,
    ),
    # the reference's d=8 diffusion of a Student-t density (nu = 2 at t=0)
    "diffusion": RunConfig(
        name="diffusion", dim=8, offset=(0.0,) * 8, latent_name="Student_t",
        equation="diffusion", variant="scale",
        dt0=1e-7, max_step=1e-2, grid_bound=10.0,
    ),
    # d=12 anisotropic diffusion div(D grad p), D the JAX package's random
    # SPD matrix of seed 0
    "diffusion_anisotropic": RunConfig(
        name="diffusion_anisotropic", dim=12, offset=(0.0,) * 12,
        latent_name="Gauss", equation="diffusion_anisotropic",
        variant="scale", dt0=1e-7, max_step=1e-2, grid_bound=10.0,
    ),
    # the ML-fluids paper's advection of a cosine bump by a time-periodic
    # swirl on [0, 1]^2 (Metropolis sampling, independence proposals)
    "fluidpaper": RunConfig(
        name="fluidpaper", dim=2, offset=(0.25, 0.25), latent_name="cos_dist",
        equation="advection_paper", variant="affine",
        dt0=1e-4, max_step=1e-3, grid_bound=1.0, sym_grid=False,
        mcmc_bound=0.25,
    ),
    # anharmonic double-well Fokker-Planck (V(x) = -2 x^2 + x^4, bath
    # T = 0.5) quenched from the double-well Boltzmann latent at T0 = 1.5,
    # Metropolis sampling with random-walk proposals
    "doubleWell": RunConfig(
        name="doubleWell", dim=2, offset=(0.0, 0.0),
        latent_name="double_well",
        equation="advection_hamiltonian_wDiss", variant="affine",
        equation_params={"v2": -4.0, "lam": 1.0, "T": 0.5},
        proposal_mode="rw", rw_scale=0.8,
        dt0=1e-4, max_step=2e-3, grid_bound=4.0, mcmc_bound=2.5,
    ),
    # d=32 interacting Ornstein-Uhlenbeck Fokker-Planck: 16 (q, p) pairs on
    # a nearest-neighbour coupled ring, momentum damping and diffusion
    # toward a T=10 bath; P = 9264 parameters. The JAX package's production
    # operating point adds --samples 524288 --chunk-size 65536, with the
    # tri2 Gram and the int8 cross term there
    "fokkerPlanck32": RunConfig(
        name="fokkerPlanck32", dim=32, offset=(0.0,) * 32,
        latent_name="Gauss", equation="advection_hamiltonian_wDiss",
        equation_params={"T": 10.0, "coupled": True},
        variant="affine", n_samples_tdvp=16384, n_samples_obs=16384,
        dt0=2e-3, max_step=2e-3, t_end=1.0, grid_bound=10.0,
    ),
}


def preset(name: str, **overrides) -> RunConfig:
    return dataclasses.replace(PRESETS[name], **overrides)
