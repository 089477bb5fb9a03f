"""Smoke test of the PyTorch port on one CUDA card:

    python3 chip_smoke.py

1. the device, and its name and power limit as nvidia-smi reports them;
   then every CUDA kernel is built from vmc_pde_torch/kernels/csrc, one
   nvcc per source, all at once;
2. the per-sample kernel against its plain torch.func version at the
   fokkerPlanck32 shape (d=32, P=9264): N=1024, a ragged N=1000 and the
   main path's N=16384 on a perturbed theta (there within twice plain
   f32's own error), then the preset's initial theta at N=16384, where
   both are also timed with CUDA events, and the kernel on the chunked
   path's pilot shape (its first 2048 rows); each time's share of its
   bound is printed;
3. the same kernel in split mode (bf16 hi/lo of O - shift, column sums,
   column max) against the plain pipeline and split: N=1024 and a ragged
   N=1000 on the perturbed theta, the chunked path's N=65536 on the
   initial theta, where both are timed (and the share of the bound);
4. the fused quantize+force kernel against its plain passes at P=9264,
   n=65536 on the split pair of phase 3: q8 bit-identical, f against f64;
   both calls timed (the hi half with kv=2, the lo half with kv=1), each
   with its share of the bound;
5. the port's main path, ``vmc_pde_torch.driver.main`` on fokkerPlanck32
   at the preset's N=16384 for 5 fixed-Heun steps: the per-sample kernel's
   launch counter must rise, nothing may be NaN, the solver residual must
   be finite and below 1e-3;
6. the chunked statistics on one batch of 131072 in chunks of 65536 at
   the theta phase 5 ends on, tri2 + int8 and syrk each against the f32
   Gram on the same draws: S0, F0 and A within 1e-4 of each one's largest
   value;
7. the chunked path at the production operating point, N=524288 in
   chunks of 65536 with the tri2 Gram and the int8 cross term, for 3
   steps: 3 steps x 2 RHS x 8 chunks split launches, twice that many
   quant8 launches, the plain-mode kernel for the pilot, no NaN, residual
   below 1e-3;
8. the 2-D Gaussian diffusion ``mwe`` in f64 against its closed forms;
9. the Metropolis kernel against its plain version on the same external
   uniforms and on the same Philox stream at the launch shapes (128
   chains x 24 sweeps; 8192 x 128, the VarState.sample launch; 8192 x
   136, a last chunk of 8 sweeps; 2048 x 128 from chain 2048, also
   against those chains' rows of the plain version over 4096), every
   fourth chain started outside the bump's support: the same accept
   count, samples and final states within 2e-6, the rim proposals of
   the chains outside rejected; a Philox run at 8192 x 128 against the
   torch chain on statistics (acceptance within 0.03, mean radius within
   5% of the analytic value, radial-histogram L1 below 0.15); timed, with
   the shares of the bound and of the bound without Philox's multiplies;
10. ``VarState.sample`` on fluidpaper's flow with 8192 chains, 2^20
   samples: the kernel's launch counter must rise;
11. ``fluidpaper`` through the driver at the preset (30 chains, N=10020)
   for 20 steps: no NaN, residual below 1e-3, acceptance in (0.05, 0.95),
   the grid integral on [0, 1]^2 within 0.05 of 1, the entropy drift;
12. ``doubleWell`` through the driver for 20 steps: no NaN, acceptance in
   (0.05, 0.95), the adapted random-walk scale;
13. the syrk kernel against its plain version at P=9264 on the operands
   the syrk paths give it, at the theta phase 5 ends on: one chunk of the
   chunked path, N=65536, unweighted (within 2e-5 of the largest entry)
   and with the weights es and es^2 (3e-5), after the plain-mode
   per-sample kernel that makes the chunk is held against its plain
   version at N=65536; then the direct path's centered O at N=16384,
   unweighted and with the signed weight E_loc - mean, where it is timed
   against the plain version and against torch.mm(O^T, O) in f32; the
   weighted call and the chunk (N=65536) are timed too, each with its
   share of the bound;
14. ``fokkerPlanck32 --gram-backend syrk``: 5 steps at N=16384 with
   exactly 20 syrk launches, S0 and A within 1e-4 of the f32 Gram's on one
   batch, then the chunked statistics at N=131072 in chunks of 65536 for
   2 steps with exactly 24 syrk and 8 per-sample launches. The chunked
   syrk run is cut to 2 steps and N=131072, the direct one to 5 steps,
   to keep the whole script well inside its time limit;
15. (A) the per-sample kernel's Student-t and global-affine branches at
   full width: fokkerPlanck32's flow with the Student-t latent and the
   global affine in every block (d=32, P=9397), on the preset's initial
   theta and a perturbed one (nu = 2.5, g_scale off 1): plain mode at
   N=1024, a ragged 1000 and 16384, split mode at 1024, 1000 and 65536,
   to TOL (on the perturbed theta's heavy-tailed draws, to plain f32's own
   error sample by sample: GRADE_Q and GRADE_MAX below), the nu and
   g_scale rows reported on their own; both modes timed, plain mode also
   at the pilot's 2048 rows, with the shares of the bounds; then
   diffusion_anisotropic's flow (d=12, P=762) with its dense Cholesky
   trace directions at N=16384;
16. (B) ``driver.run(preset("fokkerPlanck32", latent_name="Student_t",
   global_affine=True))`` at N=16384 for 4 steps: exactly 8 plain-mode
   launches, no NaN, residual below 1e-3; then the chunked statistics at
   N=131072 in chunks of 65536 with tri2 + int8 (2 split launches)
   against the f32 Gram on the same draws, S0, F0 and A within 1e-4;
17. (C) ``diffusion`` (d=8, Student-t, P=365) through the CLI with
   ``--per-sample-backend cuda`` for 20 steps: exactly 40 plain-mode
   launches, no NaN, residual below 1e-3, the f64 entropy on common
   random numbers rising every step; then ``--is-gamma 0.5`` for 10 steps
   (20 launches) with the IS weights' effective sample share;
18. (D) ``diffusion_anisotropic`` in f64 (the torch pipeline) for 50
   steps against Sigma(t) = I + 2 t D and 1/2 log det(2 pi e Sigma(t)),
   within 5 Monte Carlo standard errors; ``harmonicOsc`` for 20 steps
   (entropy within 5 standard errors of the initial log(2 pi e), grid
   integral within 0.05 of 1) and ``harmonicOsc_diff`` for 20 steps;
19. (E) the sharded statistics at full width, in 4 rank processes on the
   one card (spawned after every kernel is built; they exchange over gloo,
   through the host): fokkerPlanck32 through ``driver.run`` with
   ``stats_partitioning="shard_map"`` and ``mesh_dp=4``, (a) direct at
   N=16384 for 3 steps (exactly 2 plain-mode launches per step per rank),
   (b) chunked tri2 + int8 at N=262144 in global chunks of 65536 for 2
   steps (each rank 4 local chunks of 16384: exactly 16 split, 32 quant8
   and 4 pilot launches per rank); in both no NaN, residual below 1e-3,
   theta bitwise equal across ranks after every step, and S0, F0 and A on
   one batch within 1e-4 of the one-rank f32 statistics on the same global
   draws; step times and the all-reduce's share and bytes printed; (c)
   ``per_sample_sharded`` against its plain version on a rank's 4096 rows
   (timed, with its share of the bound), then the GSPMD counterpart (``eloc_clip=2``) for 2 steps with
   exactly 4 of its launches per rank;
20. (F) ``metropolis_chain_sharded`` on the 4 ranks, 8192 chains x 128
   and x 136 sweeps (every fourth chain outside the support): each
   rank's launch against the plain version with its chain_base, and the
   gathered shards against the single launch, bit for bit, accept counts
   equal, with external uniforms and with Philox (the per-rank launch
   timed, with both shares); then ``VarState.sample`` of fluidpaper's
   flow on the mesh with 8192 chains: 2 launches on every rank.
K. (after phase 20, in the same 4 rank processes: ``phase_mesh_k``) the
   rest of the mesh path, fokkerPlanck32 at full width through
   ``driver.run`` / ``driver.build_problem``: K1 the GSPMD statistics at
   dp=2 x tp=2 (each rank contracts its ceil(P/2) of the Gram's rows) for
   2 steps: theta bitwise across ranks, residual below 1e-3, exactly 2
   sharded per-sample launches per step per rank, the dp-group reduction
   of the moments exactly ceil(P/2) P 4 bytes per (P, P) moment, and the
   statistics within 1e-4 of one rank's; K2 ``auto`` at dp2 x tp2 on the
   depth-8 flow (P=17968 > 16384: GSPMD with tp row blocks), 1 step, each
   rank's peak memory beside a shard_map step; K3 chunked GSPMD at dp=4,
   sym2 + int8, N=131072 in chunks of 32768 for 2 steps (one plain-mode
   launch per chunk a rank holds per RHS, no split or quant8 launch;
   within 1e-4 of one rank), then 1 step at f64acc; K4 one RHS each on
   4 ranks against one rank's on the same draws, the RHS times beside
   each other: cg (1e-3 of the update's norm), minSR direct and streaming
   (chunks of 256) on scripts/bench_minsr.py's flow (1e-3), the default
   precision (statistics within 1e-4), the f64 precision and the host
   solve (cholesky) with f64 statistics and an f64 solve (1e-3);
21. (G) the steppers at full width, before phases 19-20:
   ``fokkerPlanck32`` at N=16384 with ``--stepper`` fixed_euler,
   fixed_rk3, adaptive_heun and adaptive_rk23 for 3 steps each (cholesky,
   so the adaptive error is the matrix-free S metric on the last stage's
   kept O): exactly stages x attempts plain-mode launches, each step's t,
   dt, attempts, error and residual; adaptive_heun for 2 steps at tol
   2e-5, below its first attempt's error, so that the first step retries
   at a smaller dt (5 launches per attempt, the accepted errors within
   tol); the matrix-free pass timed with CUDA events beside one
   per-sample launch;
22. (G) ``--exact-t-end`` landing on t_end = 5e-3 (dt 2e-3, 2e-3, 1e-3),
   and ``steps_per_dispatch`` 3 against 1 for fixed_heun and
   adaptive_heun (3 steps, verbose output off, so the NaN flags are read
   once per 3 steps): theta and the recorded rows bit for bit; then the host waits (torch's sync debug
   mode) inside one fused Heun pair, one adaptive-Heun attempt and one
   chunked Heun pair, printed with where each comes from;
23. (G) one batch with the dense SExp at the theta phase 5 ends on: the
   direct statistics at N=16384 through syrk (3 launches: S0, A and SExp
   weighted with logp^2) and the chunked ones at N=131072 through tri2 +
   int8, each SExp within 1e-4 of the f32 Gram's; the matrix-free
   v^T SExp v on the direct f32 path within 1e-4 relative of the dense;
   the syrk SExp again on phase 16's Student-t + global-affine flow
   (heavy tails, large logp^2);
24. (G) one adaptive_heun step at the production point (N=524288 in
   chunks of 65536, tri2 + int8): per attempt 40 split, 80 quant8 and 13
   plain-mode launches (5 pilots, 8 for the matrix-free metric, which
   re-makes O per chunk); that metric timed;
25. (G) ``fluidpaper`` with adaptive_heun (the dense SExp, the torch
   chain) for 3 steps: the recorded proposals are the budget x 5 x
   attempts;
26. (H1) ``--solver cg`` at fokkerPlanck32's N=16384 for 3 fixed-Heun
   steps (2 plain-mode launches a step, lambda_max and no spectrum); one
   RHS at phase 5's theta against the Cholesky solve on the same draws
   (svd_tol 1e-5, 600 iterations): cosine, lambda_max, residual, and the
   update against the f64 Cholesky solve; the CG solve timed with its
   iterations and the host waits of one RHS; one adaptive-Heun step;
27. (H2) ``--solver minsr`` in its regime, P > N: fokkerPlanck32 at
   N=2048 and scripts/bench_minsr.py's flow (d=32, depth 8, hidden 32,
   P=34,864, N=1024, kernel forced), 3 steps each (1 launch a RHS); one
   batch's kernel-space residual and spectrum against P-space ones on
   the same O rows; the N x N eigh, a minSR RHS and a Cholesky RHS timed;
28. (H3) streaming minSR at chunk_size N/4 on both flows, 3 steps (18
   launches a RHS), one RHS against the direct one on the same draws;
29. (H4) the Gram precisions: direct N=16384 under tpu_f64stats, f64 and
   default against high on the same draws, the f64 solve's residuals;
   then f64acc at the production point (3 steps: 16 split, 32 quant8, 2
   pilots a step) and one batch's statistics under f64acc, high and
   chunked f64, gated at f64acc's Frobenius distance to f64 at most
   1.001 x high's and below 1.2e-5 (10 draws: 0.999935-1.000065 x,
   9.97e-6-1.0094e-5); and the JAX test's ordering on its problem in
   chunks of 64, f64acc 4x nearer to f64 than high;
30. (H5) the host f64 solve: ``mwe --precision f64 --host-solve`` for 10
   steps (residual below 1e-10), one fokkerPlanck32 RHS solved on the
   host (numpy f64) against the device's f64 Cholesky, timed;
31. (I1) the randomized QMC draws on the card against the CPU at
   fokkerPlanck32's production batch (d=33, n=524288): the scrambled bits
   from the same words bit for bit, the f32 normals within 8 f32 ulps of
   the CPU's f64 ones, chi^2 for nu in {1.05, 2.5, 50} within the
   inversion's bound; the net, the normals and the Newton solve timed;
32. (I2) ``fokkerPlanck32 --qmc`` at N=16384 for 5 steps (exactly 10
   plain-mode launches) and at the production point for 3 steps (48
   split, 96 quant8, 6 pilots), each step time beside phase 5's and 7's;
   the spread of F0 over 8 randomizations, QMC against pseudo-random
   draws (printed, no gate);
33. (I3) the Student-t + global affine ``fokkerPlanck32`` with ``qmc`` for
   4 steps (8 launches), and the kernel on QMC draws of the joint
   (d+1)-column net held to plain f32 with phase 15's grading;
34. (I4) ``fokkerPlanck32 --hessian-mode block`` for 2 steps (the
   torch.func pipeline: no per-sample launch; 4 of the Jacobi
   eigensolve), its f32 E_loc against the f64
   pipeline's beside the kernel's trace-mode E_loc, and mwe and
   diffusion_anisotropic in f64, block against trace within 1e-10;
35. (I5) the MC sphere integrals: mwe in f64 for 10 steps within 5
   standard errors of its closed form, fokkerPlanck32 at N=16384 for 3
   steps (6 launches) in [0, 1 + 5 SE], with the step time.

Phase J (36-40, after phase 35), the run state, all on fokkerPlanck32 at
N=16384; driver runs with a workdir write infos.hdf5 through an in-memory
stand-in for h5py (a card's host may have none), read back from it:
36. (J1) ``--seed 3`` for 2 steps twice: theta bit for bit equal, and
   unequal to the default seed's; ``--per-sample-backend pallas`` for 1
   step: exactly 2 plain-mode launches;
37. (J2) ``--checkpoint-every 1`` for 4 steps, then ``--resume`` from the
   step-2 checkpoint in a fresh workdir for 2: the same theta, t and dt
   after step 4, bit for bit (else the non-deterministic operation is
   named and the gap held to 1e-6 of a step's largest change); launches
   8 + 4; one checkpoint write timed, the step time beside phase 5's;
38. (J3) ``--async-recorder`` for 3 steps: metrics.bin equals the run's
   rows exactly for every number-valued key and dist_params; the step
   time beside phase 5's; the host waits of one step's record;
39. (J4) a profiler window over steps [1, 3) of 4: one Chrome trace with
   exactly 4 per-sample kernel launches by its kernel name;
40. (J5) pretrain.train on the flow (normal_superpos, 16384 points,
   batches of 1024, 2 epochs): the loss falls, the time per epoch; then
   ``--init-params`` from its checkpoint for 2 steps: the first step
   starts from the pretrained theta bit for bit, 4 launches, and the
   residual (this flow's Tikhonov bias, ~3.3e-3) within 10% of an f64
   solve of the same system.

Phase L (41-47, after the mesh): the ground-truth oracles, SanityFlow,
the plots and the examples, against the d=32 Fokker-Planck main path at
scripts/evolve_d32_fp.py's shape (alone: ``python3 -c "import chip_smoke
as c; c.phase_device(); c.full_f32_matmuls(); c.phase_build();
c.phase_oracles()"``):
41. (L1) the SDE oracle on the card in f64: 20000 particles, d=32,
   phase_space at T=10, dt 2e-3, 49 records, its covariance diagonal
   within 5 sqrt(2/n) of the Lyapunov ODE at every record; timed, with
   its host waits;
42. (L2) evolve_d32_fp.py's RunConfig through ``driver.run`` at N=16384
   for 48 fixed-Heun steps (steps_per_dispatch 8, precision tpu, P=9264):
   exactly 96 plain-mode launches, no NaN, residual below 1e-3; the
   script's summary against L1's cloud and the Lyapunov ODE, the latter
   within the model's Monte Carlo bound 5 sqrt(2/N) at every record;
43. (L3) ``python -m vmc_pde_torch.oracle fluidpaper`` at its defaults
   (10000 particles, dt 1e-2, t_end 12): one Metropolis launch for the
   cloud, the cloud's mean radius within 5% of the bump's, and the same
   cloud integrated on the CPU in f64 within 1e-10 of the card's after
   100 steps (the gap at t_end printed);
44. (L4) ``hamiltonian`` through the CLI with ``--workdir``: infos.hdf5
   with the JAX CLI's keys and shapes, read back by ``load_infos`` (through
   phase J's h5py stand-in, which also reads), the final variances within
   5 SE of T;
45. (L5) ``double_well_init_cloud`` at 100000 particles (x against the
   quadrature CDF, KS below 5/sqrt(n); var p within 5 SE of DW_T0), then
   1001 phase_space steps, timed;
46. (L6) ``evolve_radial`` on the card: the Gaussian grid against its
   closed forms, the graded Student-t grid's t=0 entropy, card against
   CPU within 1e-12, ms a step eager and graphed, the graded grid to a
   cut t_end 0.5 (the script's 5 projected), host waits;
47. (L7) one TDVP RHS with SanityFlow(dim=3) (no kernel launch; card vs
   CPU within 1e-5), the plots' grid density of fluidpaper's flow card vs
   CPU (and ``plot_data_diff`` and ``minimal_demo`` where matplotlib
   imports; the card's host has none), and
   ``vmc_pde_torch.examples.custom_equation`` on the card, PASS with its
   own gates.

48. (after phase 5) the Jacobi eigensolve kernel (csrc/jacobi.cu)
   against torch.linalg.eigh on the main path's own Ritz matrix (72 x 72
   f32, caught from one fokkerPlanck32 RHS) and on the same matrix in
   f64, in one block, and in its block variant at orders 365, 411, 684,
   762, 1024 and 2048 f32 and 256, 320, 411, 762 and 2048 f64:
   eigenvalues against an f64 eigh within 64 n eps of the norm, V diag(w)
   V^T and V^T V - I within 1e-4 (f32) or 1e-12 (f64), both timed in
   turns (eigh, kernel, kernel, eigh), the kernel's device ms, the sweeps,
   the bound and its share; one fokkerPlanck32 step at spectrum_topk=200
   (2 block-variant launches); the eigh solves of diffusion (P=365) and
   diffusion_anisotropic (P=762) at --steps-per-dispatch 8 as CUDA graphs
   against K=1, bit for bit, s/step both ways (as M1 below), the solves
   counted by the kernel on the device and in a trace;
49. (M1, after phase 25) ``--steps-per-dispatch 8`` on fokkerPlanck32 at
   N=16384 through ``driver.run`` against the K=1 run, theta and every
   recorded row bit for bit: fixed Heun, SSPRK3, and Heun with
   ``--gram-backend syrk``. The batched run runs in a trace of the
   device's activity, whose kernels are its launches: its K replays' and
   the capture's warm-up step's, exactly (the K=1 run's are its wrappers'
   counts). For each: the capture's seconds and pool, the batch's s/step
   against the per-step loop's, a 1-step batch's host waits (at most 1)
   and replay's host time, and one replay's kernel launches in a
   profiler trace (2 plain-mode and 2 Jacobi a Heun step, 3 and 3 an
   SSPRK3 step, 4 syrk with syrk);
50. (M2) adaptive Heun at tol 2e-5 and K=8, RK23 at K=4, against K=1:
   the same attempts (the first Heun step retries: 4 attempts), times
   to rtol 1e-12, theta within 1e-6 of its largest entry (bit for bit so
   far); the launches 5 (Heun) or 4 (RK23) plain-mode and Jacobi
   kernels per attempt, the batched run's warm-up 4 attempts more; one
   host wait in a batch; one replay from t=0 launches 5 plain-mode
   kernels per attempt;
51. (M3) the production point (N=524288 in chunks of 65536, tri2 + int8)
   at K=2 against K=1, bit for bit; one replay launches 16 split, 32
   quant8, 2 pilot plain-mode and 2 Jacobi kernels;
52. (M4) fluidpaper at K=8 and doubleWell at K=4 through
   ``TDVP.heun_multi`` (their grid keeps the driver per step): the
   graph against the eager heun_multi bit for bit, fluidpaper also
   against 8 heun_pair calls;
   s/step graphed and eager, the device's busy share over one step,
   graphed and per step.

Phase W (53-55, after phase 48's traced part): the per-sample kernel on
flows past dim 64, coupling halves of 32, widths of 64 and four linear
layers, and without coupling blocks, as the JAX kernel takes them: each
fokkerPlanck32 with its dim, depth or widths changed (``WIDE``):
53. (W1) A = ``driver.run(preset("fokkerPlanck32", dim=128, depth=2,
   hidden=(16,)))`` (P=25,408, 64 trace directions), which ``auto`` sends
   to the kernel (uses_kernel): 4 fixed-Heun steps at N=16384 one at a
   time and as one graphed batch at steps_per_dispatch 4, bit for bit,
   2 plain-mode launches a step (the wrappers' counts; the batched run's
   in a trace of the device's activity, as phase M counts them); then the
   chunked tri2 + int8 path at N=131072 in chunks of 65536 for 2 steps: 8
   split, 16 quant8 launches and the pilots;
54. (W2) B = the preset with hidden (16, 16, 16, 16) (five linear layers,
   P=22,320) through ``driver.run`` for 3 steps at N=16384: 6 launches;
55. (W3) every WIDE flow (A, d=96 depth 4, B, width 96,
   scripts/bench_persample.py's d=128 depth 4 hidden 64 at P=141,504, A
   with the Student-t latent and the global affine, SanityFlow at d=4):
   the kernel timed at N=16384 in both modes (bound and share) with the
   wrapper's plans, the timed calls held against the plain version to
   TOL on 512 rows of whole tiles from blocks across the grid (a block's
   later tiles too) and split mode's column sums and max over all 16384
   rows against plain f32's; at a perturbed theta both modes on all
   16384 standard normal x, to TOL or graded as phase 15's; then at
   N=2048 beside torch.func, which it must beat; the flows ``auto``
   leaves off the kernel with
   ``per_sample_backend='cuda'``: the P=141,504 flow through driver.run
   with minSR at N=1024 for 2 steps (4 launches), and one SanityFlow
   (d=4) RHS at N=16384 against the CPU's (1 launch, 1e-5).

Phase S (56-61, after phase L): the accuracy studies
(vmc_pde_torch/studies/, the JAX package's scripts/ of the same names) at
the scripts' default widths and sizes (``phase_studies``):
56. (S1) northstar_l2: mwe in f64 at N=10^4 to t_end 1 on the 501^2 grid,
   L2 at most 1e-5;
57. (S2) make_paper_figures.regenerate_runs: accuracy_d8 Gauss and
   Student-t (N=10^4, t_end 5, K=8, --qmc) in the JAX record's 541 steps
   to t = 5.0044, the Gauss entropy error at most 0.118; the fp6 heat
   chain to t_end 5 with its sphere integrals;
58. (S3) check_fp6 at 60000 particles on the heat chain, and on
   harmonicOsc_diff at T = 10 to t_end 0.5 beside the JAX package's run;
59. (S4) diffusion_anisotropic (d=12) to t_end 0.5 at K=8, check_aniso;
60. (S5) evolve_minsr_largep at its defaults (P = 18,604, N = 4096):
   the per-sample kernel launched, the chunked replay within 4 times the
   f32 order control's gap (two direct runs on the same draws in two
   sample orders) of the direct steps' change, and its first 2 steps
   within 2e-4 replayed in f64 (the CPU test's bar);
61. (S6) make_paper_figures' collection (no drawing; the grid oracle to
   t_end 0.5) and the lag of S2's Student-t curve against that grid.
No study may record a NaN.

Any failure raises and exits nonzero. On success the second-to-last line
is the per-kernel JSON record and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import math
import multiprocessing
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import (bounds, build, jacobi, metropolis,
                                   persample, quant8, syrk)
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.parallel import mesh, stats
from vmc_pde_torch.parallel.mesh import ParallelCtx
from vmc_pde_torch.sampling import sampler as sampling
from vmc_pde_torch.solver import graphs
from vmc_pde_torch.solver import tdvp as tdvp_mod
from vmc_pde_torch.solver.tdvp import TDVP
from vmc_pde_torch.utils.dtypes import full_f32_matmuls
from vmc_pde_torch.utils.grid import Grid

# Kernel (f32) vs plain version in f64 on the same f32-rounded inputs,
# relative to the largest reference value: f32 rounding amplified by four
# coupling blocks of exp/tanh (the plain pipeline in f32 shows 1e-5 to
# 7e-5 on the perturbed flow at N=1024), and a second derivative with
# cancellations for quad. The plain pipeline's own f32 error is printed
# beside the kernel's. The split pair adds 2^-16 (its dropped residual).
TOL = {"logp": 1e-4, "g": 2e-4, "quad": 1e-3, "O": 2e-4}
KERNELS = {
    "persample": ("vmc_pde_torch/kernels/csrc/persample.cu",
                  "vmc_pde_tpu/kernels/persample.py:899"),
    "persample_split": ("vmc_pde_torch/kernels/csrc/persample.cu",
                        "vmc_pde_tpu/kernels/persample.py:916"),
    "quant8": ("vmc_pde_torch/kernels/csrc/quant8.cu",
               "vmc_pde_tpu/kernels/quant8.py:103"),
    "metropolis": ("vmc_pde_torch/kernels/csrc/metropolis.cu",
                   "vmc_pde_tpu/kernels/metropolis.py:140"),
    "syrk": ("vmc_pde_torch/kernels/csrc/syrk.cu",
             "vmc_pde_tpu/kernels/syrk.py:161"),
    "persample_sharded": ("vmc_pde_torch/kernels/csrc/persample.cu",
                          "vmc_pde_tpu/kernels/persample.py:1104"),
    "metropolis_sharded": ("vmc_pde_torch/kernels/csrc/metropolis.cu",
                           "vmc_pde_tpu/kernels/metropolis.py:191"),
    # no Pallas kernel: the JAX package's jnp.linalg.eigh of the Ritz
    # matrix, which XLA runs inside the step program, in one block; and of
    # the P-space spectral solve (the diffusion presets' P=365 and 762), in
    # the block variant
    "jacobi": ("vmc_pde_torch/kernels/csrc/jacobi.cu",
               "vmc_pde_tpu/solver/tdvp.py:308"),
    "jacobi_blocks": ("vmc_pde_torch/kernels/csrc/jacobi.cu",
                      "vmc_pde_tpu/solver/tdvp.py:241"),
}
WRAPPERS = {"persample": persample.per_sample_cuda,
            "persample_split": persample.per_sample_split_cuda,
            "quant8": quant8.quant_force_cuda,
            "metropolis": metropolis.metropolis_chain_cuda,
            "syrk": syrk.syrk_cuda,
            "persample_sharded": persample.per_sample_sharded,
            "metropolis_sharded": metropolis.metropolis_chain_sharded,
            "jacobi": jacobi.eigh_cuda}
# rank processes of phases 19 and 20, all on the one card
MESH_WORLD = 4
# the chunked path's pilot batch (solver/tdvp.py): its per-sample shape
PILOT_N = 2048
# wall seconds of each step of each _drive run, by its label
STEP_TIMES = {}
MAIN_LABEL = "fokkerPlanck32 N=16384"
CHUNKED_LABEL = "fokkerPlanck32 N=524288 chunked tri2+int8"


def fail(msg):
    raise RuntimeError(msg)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])


def phase_build():
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in build.SIGNATURES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"ptxas {name}:", line.strip())


def _time_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fp32_problem(dev):
    cfg = preset("fokkerPlanck32")
    flow, theta0 = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                              hidden=cfg.hidden_resolved(),
                              variant=cfg.variant, out_scale=cfg.init_scale,
                              dtype=torch.float32, device=dev)
    if flow.layout.size != 9264:
        fail(f"fokkerPlanck32 has P={flow.layout.size}, expected 9264")
    perturbed = perturb_theta(flow, theta0, np.random.default_rng(0),
                              out_scale=0.03)
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    return flow, theta0, perturbed, eq, dirs


def _rel(a, ref, scale=None):
    ref = ref.double()
    if scale is None:
        scale = ref.abs().max().clamp_min(1.0)
    return float((a.double() - ref).abs().max() / scale)


def _row_groups(flow):
    """The O rows of the Student-t and global-affine branches, by name:
    the nu row and every block's g_scale row (and g_offset rows)."""
    lay, groups = flow.layout, {}
    if flow.latent_name == "Student_t":
        groups["nu row"] = [lay.offset(("latent", "dist_params"))]
    ga = [b for b, spec in enumerate(flow.blocks) if spec.global_affine]
    if ga:
        groups["g_scale rows"] = [lay.offset(("blocks", b, "g_scale"))
                                  for b in ga]
        groups["g_offset rows"] = [
            lay.offset(("blocks", b, "g_offset")) + i
            for b in ga for i in range(flow.dim)]
    return groups


def _print_rows(label, n, O, O_ref, O_32, groups):
    """Max abs error of each row group of O, relative to the group's
    largest reference value, beside plain f32's."""
    for name, rows in groups.items():
        r = O_ref[:, rows]
        scale = r.abs().max().clamp_min(1e-30)
        err = float((O[:, rows].double() - r).abs().max())
        err32 = float((O_32[:, rows].double() - r).abs().max())
        print(f"  {label}, N={n}, {name}: max abs err {err:.3e}, relative "
              f"to the rows' largest value {err / float(scale):.3e} (plain "
              f"f32 {err32 / float(scale):.3e})")


# Heavy-tailed draws of a perturbed flow (phase 15): a few samples are so
# ill-conditioned that f32 itself loses three digits there, and which of
# two f32 evaluations errs more at the worst one is a coin toss
# (over seven draws of 16384 on the card, six of them through
# tools/persample_blocks.py, the kernel's largest g error was 0.46-4.2
# times plain f32's, while their per-sample error quantiles up to 0.999
# agreed within 25%). There each
# per-sample output is held to plain f32's own error sample by sample:
# the quantiles GRADE_Q of the per-sample error within twice plain f32's,
# the largest within GRADE_MAX times plain f32's largest (or TOL).
GRADE_Q = (0.5, 0.99, 0.999)
GRADE_MAX = 10.0


def _grade_ok(name, a, r, p, tol, where):
    """The same-grade check of kernel output ``a`` against the f64
    reference ``r``, beside plain f32's ``p``, each sample's largest error
    relative to the largest reference value; prints it, returns whether it
    holds."""
    scale = r.double().abs().max().clamp_min(1.0)

    def per_sample(v):
        e = (v.double() - r).abs()
        return (e if e.ndim == 1 else e.amax(1)) / scale

    return _graded(name, per_sample(a), per_sample(p), tol, where)


def _graded(name, ek, ep, tol, where):
    """_grade_ok on the per-sample errors of the kernel (``ek``) and of
    plain f32 (``ep``), each relative to the largest reference value."""
    qs = torch.tensor(GRADE_Q, dtype=torch.float64, device=ek.device)
    qk, qp = torch.quantile(ek, qs).tolist(), torch.quantile(ep, qs).tolist()
    mk, mp = float(ek.max()), float(ep.max())
    limit = max(tol, GRADE_MAX * mp)
    print(f"{where}, {name}: per-sample error at quantiles {GRADE_Q}: "
          f"kernel {' '.join(f'{v:.2e}' for v in qk)}, plain f32 "
          f"{' '.join(f'{v:.2e}' for v in qp)}; largest kernel {mk:.3e}, "
          f"plain f32 {mp:.3e} (limit {limit:.2e})")
    return (all(k <= 2.0 * q + 2.0**-24 for k, q in zip(qk, qp))
            and mk < limit)


def _persample_vs_plain(flow, theta, x, dirs, label, loose=False,
                        grade=False):
    """The plain-mode kernel against the plain pipeline in f64 on the same
    f32 inputs, to TOL (with ``loose``, to twice plain f32's own error
    where that is larger; with ``grade``, to plain f32's own error sample
    by sample, _grade_ok); returns the largest abs error of O. The
    Student-t and global-affine rows are also reported on their own."""
    n = x.shape[0]
    got = persample.per_sample_cuda(flow, theta, x, dirs)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    ref32 = persample.per_sample_plain(flow, theta, x, dirs)
    torch.cuda.synchronize()
    _print_rows(f"kernel vs plain, {label} theta", n, got[3], ref[3],
                ref32[3], _row_groups(flow))
    for name, a, r, p in zip(("logp", "g", "quad", "O"), got, ref, ref32):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"kernel {name} at N={n}: shape {tuple(a.shape)} vs "
                 f"{tuple(r.shape)}, or not finite")
        rel, rel32 = _rel(a, r), _rel(p, r)
        tol = max(TOL[name], 2.0 * rel32) if loose else TOL[name]
        where = f"kernel vs plain, {label} theta, N={n}"
        print(f"{where}, {name}: max abs err "
              f"{float((a.double() - r).abs().max()):.3e}, relative "
              f"{rel:.3e} (tol {tol:.2e}; plain f32 {rel32:.3e})")
        ok = (_grade_ok(name, a, r, p, TOL[name], where) if grade
              else rel < tol)
        if not ok:
            fail(f"kernel {name} disagrees with the plain version at "
                 f"N={n}: {rel:.3e}")
    return float((got[3].double() - ref[3]).abs().max())


def phase_kernel(dev, prob):
    flow, theta0, perturbed, _, dirs = prob
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = 0.0
    # a perturbed theta exercises the nonlinear parts (N=1000 is ragged);
    # the last case is what the main path hands the kernel: its initial
    # theta and a batch of the preset's N=16384. At N=16384 the perturbed
    # flow throws a few samples far out (|x| ~ 47), where f32 itself loses
    # digits: plain f32 misses TOL there (g 1.1e-3, O 1.6e-3 relative), so
    # that case holds the kernel to twice plain f32's own error
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("perturbed", perturbed, 16384),
                            ("initial", theta0, 16384)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        max_abs = max(max_abs, _persample_vs_plain(
            flow, theta, x, dirs, label,
            loose=label == "perturbed" and n == 16384))

    # time both on the main path's theta and batch, the last case above;
    # then the kernel alone on the chunked path's pilot shape (its first
    # 2048 rows)
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k)
    print(f"per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain "
          f"torch.func {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]}), the bound's share of the kernel "
          f"{bound[0] / ms:.4f}")
    xp = x[:PILOT_N].contiguous()
    pilot_ms = _time_ms(
        lambda: persample.per_sample_cuda(flow, theta, xp, dirs), 20)
    pilot_bound = bounds.persample(bounds.flow_layers(flow), d, P, PILOT_N,
                                   k)[0]
    print(f"per-sample at the pilot's N={PILOT_N}: CUDA kernel "
          f"{pilot_ms:.4f} ms, bound {pilot_bound:.4f} ms, share "
          f"{pilot_bound / pilot_ms:.4f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                share_of_bound=bound[0] / ms, pilot_N=PILOT_N,
                pilot_ms=pilot_ms, pilot_bound_ms=pilot_bound,
                pilot_share_of_bound=pilot_bound / pilot_ms)


def _split_vs_plain(flow, theta, x, dirs, label, grade=False):
    """The split-mode kernel against the plain pipeline in f64 and split,
    to TOL (with ``grade``, the per-sample outputs to plain f32's own
    error sample by sample, _grade_ok, and the column statistics to twice
    plain f32's where that is larger). The shift is the pilot's: the
    plain f32 mean O of the first 2048 samples. Returns (kernel outputs,
    shift, largest abs error of hi + lo)."""
    n = x.shape[0]
    shift = persample.per_sample_plain(flow, theta, x[:2048],
                                       dirs)[3].mean(0)
    got = persample.per_sample_split_cuda(flow, theta, x, dirs, shift)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    ref32 = persample.per_sample_split_plain(flow, theta, x, dirs, shift)
    torch.cuda.synchronize()
    o_ref = ref[3] - shift.double()
    o_scale = o_ref.abs().max().clamp_min(1.0)
    pair = got[3][0].double() + got[3][1].double()
    pair32 = ref32[3][0].double() + ref32[3][1].double()
    _print_rows(f"split kernel vs plain, {label} theta", n, pair, o_ref,
                pair32, _row_groups(flow))
    checks = [(name, a, r, p, TOL[name], None) for name, a, r, p in
              zip(("logp", "g", "quad"), got, ref, ref32)]
    checks += [
        ("hi+lo", pair, o_ref, pair32, TOL["O"] + 2**-16, None),
        # per-element scale: a sum of n terms each within the O bar
        ("colsum", got[4], o_ref.sum(0), ref32[4], TOL["O"], n * o_scale),
        ("colmax", got[5], o_ref.abs().amax(0), ref32[5], TOL["O"],
         o_scale)]
    max_abs = 0.0
    for name, a, r, p, tol, scale in checks:
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"split kernel {name} at N={n}: shape "
                 f"{tuple(a.shape)} vs {tuple(r.shape)}, or not finite")
        rel, rel32 = _rel(a, r, scale), _rel(p, r, scale)
        per_sample = scale is None
        if grade and not per_sample:
            tol = max(tol, 2.0 * rel32)
        where = f"split kernel vs plain, {label} theta, N={n}"
        print(f"{where}, {name}: relative {rel:.3e} (tol {tol:.1e}; plain "
              f"f32 {rel32:.3e})")
        ok = (_grade_ok(name, a, r, p, tol, where) if grade and per_sample
              else rel < tol)
        if not ok:
            fail(f"split kernel {name} disagrees with the plain version "
                 f"at N={n}: {rel:.3e}")
        if name == "hi+lo":
            max_abs = float((a - r).abs().max())
    return got, shift, max_abs


def phase_split(dev, prob):
    """Split mode against the plain pipeline and split."""
    flow, theta0, perturbed, eq, dirs = prob
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs = 0.0
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("initial", theta0, 65536)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        got, shift, err = _split_vs_plain(flow, theta, x, dirs, label)
        max_abs = max(max_abs, err)

    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    ms = _time_ms(lambda: persample.per_sample_split_cuda(
        flow, theta, x, dirs, shift), 10)
    plain_ms = _time_ms(lambda: persample.per_sample_split_plain(
        flow, theta, x, dirs, shift), 2)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                             split=True)
    print(f"split per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, "
          f"plain torch.func + split {plain_ms:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]}), share {bound[0] / ms:.4f}")
    eloc = eq.eloc(x, got[1], got[2], 0.0)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                share_of_bound=bound[0] / ms,
                pair=got[3], omax=got[5], es=eloc - eloc.mean())


def phase_quant8(split):
    """Both quantize+force calls of one chunk, as the chunked path makes
    them, on the real pair: q8 must equal the plain quantization bit for
    bit; f is held against the f64 product."""
    amax = (split["omax"] * (1.0 + 2.0**-8), split["omax"] * 2.0**-8)
    es_hi, es_lo = stats._split_bf16(split["es"].float())
    calls = (("hi", split["pair"][0].T, amax[0],
              torch.stack([es_hi, es_lo], dim=1)),
             ("lo", split["pair"][1].T, amax[1], es_hi[:, None]))
    max_abs = 0.0
    for half, x_pn, am, V in calls:
        inv = stats._int8_scales(am)[1]
        q8, f = quant8.quant_force_cuda(x_pn, inv, V)
        q_ref, f_plain = quant8.quant_force_plain(x_pn, inv, V)
        f64 = x_pn.double() @ V.double()
        torch.cuda.synchronize()
        mismatches = int((q8 != q_ref).sum())
        scale = f64.abs().max().clamp_min(1e-30)
        rel, rel_plain = _rel(f, f64, scale), _rel(f_plain, f64, scale)
        print(f"quant8 vs plain, {half} half (P, n) = {tuple(x_pn.shape)}, "
              f"kv={V.shape[1]}: q8 mismatches {mismatches}, f relative "
              f"{rel:.3e} against f64 (tol 1e-5; plain bf16 product "
              f"{rel_plain:.3e})")
        if mismatches or not rel < 1e-5:
            fail(f"quant8 kernel disagrees on the {half} half")
        max_abs = max(max_abs, float((f.double() - f64).abs().max()))
    # time both calls; the hi call (kv=2) is the kernel's record
    timed = {}
    for half, x_pn, am, V in calls:
        inv = stats._int8_scales(am)[1]
        ms = _time_ms(lambda: quant8.quant_force_cuda(x_pn, inv, V), 20)
        plain_ms = _time_ms(lambda: quant8.quant_force_plain(x_pn, inv, V),
                            20)
        P, n = x_pn.shape
        kv = V.shape[1]
        bound = bounds.quant8(P, n, kv)
        print(f"quant8 {half} at P={P}, n={n}, kv={kv}: CUDA kernel "
              f"{ms:.3f} ms, plain passes {plain_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}), share {bound[0] / ms:.3f}")
        timed[half] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                           bound_by=bound[1], share_of_bound=bound[0] / ms)
    return dict(max_abs_err=max_abs, **timed["hi"],
                shapes={"lo, kv=1": timed["lo"]})


def _zero_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
    jacobi.eigh_cuda.block_launches = 0


def _counts():
    """The wrappers' launches by kernel; jacobi_blocks: the Jacobi
    wrapper's launches of its block variant."""
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            "jacobi_blocks": jacobi.eigh_cuda.block_launches}


def _drive(args, label, n_steps, dim=32, cfg=None, callbacks=(),
           max_res=1e-3):
    """Run the driver's CLI on ``args`` (or ``driver.run`` on ``cfg``);
    returns (state, recorder arrays, counts). Each of ``callbacks`` runs
    after every step, outside the step's timing. The solver residual must
    stay below ``max_res`` (None: the caller gates it)."""
    stamps = []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        for cb in callbacks:
            cb(n_step, t, state, info)
        torch.cuda.synchronize()
        starts.append(time.perf_counter())  # the next step's clock

    starts = []
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg is None:
        state, rec = driver.main(
            args + ["--max-steps", str(n_steps), "--device", "cuda"],
            callbacks=[record])
    else:
        state, rec = driver.run(cfg, max_steps=n_steps, callbacks=[record])
    counts = _counts()
    steps = np.array(stamps) - np.array([t0] + starts[:-1])
    STEP_TIMES[label] = steps
    mean = (f", mean of steps 2-{len(steps)} {steps[1:].mean():.3f} s"
            if len(steps) > 1 else "")
    print(f"{label}: {len(steps)} steps, wall s/step "
          f"{' '.join(f'{s:.3f}' for s in steps)} (first includes "
          f"set-up){mean}")
    print(f"{label}: kernel launches {counts}")
    arrays = rec.as_arrays()
    # the spectrum of eigh/minsr, the Ritz one of cholesky; cg has none
    spectrum = next(k for k in ("ev_topk", "ev", "lambda_max")
                    if k in arrays)
    for key in ("solver_res", "tdvp_error", "entropy", "covar", "x1",
                "eloc_mean", spectrum):
        if not np.isfinite(arrays[key]).all():
            fail(f"non-finite {key} in the {label} run")
    if arrays["nan"].any():
        fail(f"NaN update in the {label} run")
    if arrays["covar"].shape != (n_steps, dim, dim):
        fail(f"covar shape {arrays['covar'].shape}")
    res = arrays["solver_res"]
    print(f"{label} solver_res per step: "
          f"{' '.join(f'{r:.3e}' for r in res)}")
    if max_res is not None and not (res < max_res).all():
        fail(f"solver residual above {max_res} in the {label} run: {res}")
    return state, arrays, counts


def phase_main_path():
    state, _, counts = _drive(["fokkerPlanck32"], MAIN_LABEL, 5)
    if counts["persample"] == 0:
        fail("the main path never launched the per-sample kernel")
    return state, counts


def phase_chunked_path():
    n_steps = 3
    _, _, counts = _drive(
        ["fokkerPlanck32", "--samples", "524288", "--chunk-size", "65536",
         "--gram-backend", "tri2", "--gram-cross", "int8"],
        CHUNKED_LABEL, n_steps)
    want = n_steps * 2 * (524288 // 65536)
    if counts["persample_split"] != want:
        fail(f"split kernel launches {counts['persample_split']}, expected "
             f"{want}")
    if counts["quant8"] != 2 * want:
        fail(f"quant8 launches {counts['quant8']}, expected {2 * want}")
    if counts["persample"] == 0:
        fail("the chunked path never ran the plain-mode kernel's pilot")
    return counts


def phase_chunked_vs_f32(theta, syrk_too=True, **flow_overrides):
    """The chunked statistics on one batch of draws through the tri2+int8,
    the syrk (``syrk_too``) and the f32 Gram, at the theta a path ends on;
    tri2+int8 must run the split kernel once per chunk."""
    n, c = 131072, 65536
    out = {}
    backends = [("tri2+int8", dict(gram_backend="tri2", gram_cross="int8")),
                ("syrk", dict(gram_backend="syrk")), ("f32", {})]
    for label, over in backends if syrk_too else backends[::2]:
        cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                     n_samples_obs=n, chunk_size=c, **over, **flow_overrides)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = theta.to(device=state.device, dtype=torch.float32)
        params = state.flow.layout.unravel(theta_c)
        gen = torch.Generator(device=state.device).manual_seed(7)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        st = tdvp._chunked_stats(theta_c, 0.0, x)
        torch.cuda.synchronize()
        out[label] = (st, time.perf_counter() - t0)
        if label == "tri2+int8" and _counts()["persample_split"] != n // c:
            fail(f"chunked tri2+int8 statistics ran the split kernel "
                 f"{_counts()['persample_split']} times, expected {n // c}")
    print(f"chunked statistics at N={n}, chunk {c}, first call each: "
          + ", ".join(f"{label} {t:.3f} s" for label, (_, t) in out.items()))
    full = out.pop("f32")[0]
    for label, (st, _) in out.items():
        for key in ("S0", "F0", "A"):
            rel = _rel(st[key], full[key], full[key].abs().max())
            print(f"chunked {label} vs f32 {key} at N={n}: max abs diff / "
                  f"max {rel:.3e} (tol 1e-4)")
            if not rel <= 1e-4:
                fail(f"chunked {label} {key} differs from the f32 Gram "
                     f"path: {rel}")


def phase_mwe():
    cfg = preset("mwe", precision="f64", device="cuda", n_samples_tdvp=4096,
                 n_samples_obs=4096, verbose=False)
    _, rec = driver.run(cfg, max_steps=80)
    a = rec.as_arrays()
    t = a["times"][-1]
    var = 1.0 + 2.0 * t
    cov_err = np.abs(np.diagonal(a["covar"][-1]) - var).max()
    ent = 0.5 * 2 * math.log(2 * math.pi * math.e * var)
    ent_err = abs(a["entropy"][-1] - ent)
    print(f"mwe f64 at t={t:.4f}: covar diag {np.diagonal(a['covar'][-1])} "
          f"vs {var:.4f}, entropy {a['entropy'][-1]:.4f} vs {ent:.4f}, "
          f"solver_res {a['solver_res'][-1]:.3e}")
    # 5 standard errors of the N=4096 Monte Carlo estimates
    if not (t > 0.2 and cov_err < 0.2 and ent_err < 0.08):
        fail(f"mwe misses its closed forms (covar {cov_err:.3f}, "
             f"entropy {ent_err:.3f})")


BUMP_OFFSET = (0.25, 0.25)


def _bump_mean_radius(bound=0.25):
    """Analytic mean radius of the cosine bump, p(s) ~ s (1 + cos(4 pi s))
    on [0, bound]."""
    s_grid = np.linspace(0, bound, 20001)
    w = s_grid * (1 + np.cos(4 * np.pi * s_grid))
    return np.trapezoid(s_grid * w, s_grid) / np.trapezoid(w, s_grid)


def _metropolis_inputs(dev, n_chains, sweeps, seed=2):
    """Initial states and external uniforms of n_chains chains, as
    tests/test_torch_cuda.py makes them: every fourth chain starts outside
    the bump's support (lp = -inf) and draws its first 8 proposals on the
    ball's rim (lp = -inf: -inf - -inf is NaN, which must reject); the
    mask of those chains."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = torch.tensor(BUMP_OFFSET, device=dev).repeat(n_chains, 1)
    outside = torch.arange(n_chains, device=dev) % 4 == 3
    init[outside, 0] += 0.5
    u = torch.rand((6, sweeps, n_chains), generator=gen, device=dev) \
        * (1 - 2e-7) + 1e-7
    u[4, :8, outside] = 1.0
    return init, u.reshape(6, -1), outside


def _metropolis_vs_plain(dev, C, sweeps, base, ext):
    """One launch on the global chains [base, base + C) against the plain
    version with the same chain_base (and, for base > 0, against the rows
    of these chains in the plain version over all base + C chains); the
    rim proposals of the chains outside the support rejected. Returns the
    largest difference."""
    G = base + C
    init_all, u_all, outside = _metropolis_inputs(dev, G, sweeps)
    init = init_all[base:].contiguous()
    u = (u_all.reshape(6, sweeps, G)[:, :, base:].reshape(6, -1) if ext
         else None)
    got = metropolis.metropolis_chain_cuda(5, init, sweeps, 0.25,
                                           BUMP_OFFSET, u, chain_base=base)
    ref = metropolis.metropolis_chain_plain(5, init, sweeps, 0.25,
                                            BUMP_OFFSET, u, chain_base=base)
    torch.cuda.synchronize()
    err = max(float((a - r).abs().max()) for a, r in zip(got[:2], ref[:2]))
    rows = got[0].reshape(sweeps, C, 2)
    if base:
        full = metropolis.metropolis_chain_plain(
            5, init_all, sweeps, 0.25, BUMP_OFFSET, u_all if ext else None)
        err = max(err, float((rows - full[0].reshape(sweeps, G, 2)[:, base:])
                             .abs().max()))
    stuck = rows[:8, outside[base:]]
    rejected = (not ext or torch.equal(
        stuck, init[outside[base:]].expand_as(stuck)))
    acc, acc_ref = int(got[2]), int(ref[2])
    label = "external uniforms" if ext else "Philox"
    print(f"metropolis kernel vs plain, {C} chains x {sweeps} sweeps from "
          f"chain {base}, {label}: accepted {acc} vs {acc_ref}, max abs err "
          f"{err:.3e} (tol 2e-6), rim proposals outside the support "
          f"rejected: {rejected}")
    if acc != acc_ref or not err <= 2e-6 or not rejected:
        fail(f"the Metropolis kernel disagrees with its plain version "
             f"({label}, {C} chains x {sweeps} sweeps from {base})")
    return err


def _metropolis_bound(n, ext=False):
    """(bound ms, bound_by, the bound with Philox left out in ms)."""
    t = bounds.metropolis_terms(n, 2, ext=ext)
    return (*bounds.metropolis(n, 2, ext=ext), max(t["bytes"], t["f32"]))


def phase_metropolis(dev):
    """The Metropolis kernel against its plain version on the same
    uniforms and on the Philox stream, exact, at the launch shapes;
    the Philox variant against the torch chain on statistics; timed."""
    max_abs = 0.0
    for C, sweeps, base in ((128, 24, 0), (8192, 128, 0), (8192, 136, 0),
                            (2048, 128, 2048)):
        for ext in (True, False):
            max_abs = max(max_abs, _metropolis_vs_plain(dev, C, sweeps, base,
                                                        ext))

    # statistics of a Philox run from the offset against the torch chain
    C, sweeps = 8192, 128
    init = torch.tensor(BUMP_OFFSET, device=dev).repeat(C, 1)
    got = metropolis.metropolis_chain_cuda(5, init, sweeps, 0.25,
                                           BUMP_OFFSET)
    acc = int(got[2])
    total, burn = sweeps * C, 32 * C
    info = {"offset": np.asarray(BUMP_OFFSET), "bound": 0.25}
    t_s, _, t_acc = sampling.metropolis_chain(
        torch.Generator(device=dev).manual_seed(3), init,
        lambda x: sampling.cos_dist_log_prob(
            x, torch.tensor(BUMP_OFFSET, device=dev)),
        sampling.radial_proposal, sweeps, info)
    off = np.asarray(BUMP_OFFSET)
    rk = np.linalg.norm(got[0].cpu().numpy()[burn:] - off, axis=1)
    rt = np.linalg.norm(t_s.cpu().numpy()[burn:] - off, axis=1)
    mean_r = _bump_mean_radius()
    hk, edges = np.histogram(rk, bins=25, range=(0, 0.25), density=True)
    ht, _ = np.histogram(rt, bins=edges, density=True)
    l1 = np.abs(hk - ht).mean() / ht.mean()
    rate_k, rate_t = acc / total, int(t_acc) / total
    print(f"metropolis Philox vs torch chain: acceptance {rate_k:.4f} vs "
          f"{rate_t:.4f}, mean radius {rk.mean():.5f} and {rt.mean():.5f} "
          f"(analytic {mean_r:.5f}), radial histogram L1 {l1:.4f}")
    if not (abs(rate_k - rate_t) < 0.03 and abs(rk.mean() / mean_r - 1) < 0.05
            and abs(rt.mean() / mean_r - 1) < 0.05 and l1 < 0.15):
        fail("the Philox Metropolis kernel does not sample the cosine bump")

    gen = torch.Generator(device=dev).manual_seed(2)
    u_ext = torch.rand((6, sweeps * C), generator=gen, device=dev) \
        * (1 - 2e-7) + 1e-7
    ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps, 0.25, BUMP_OFFSET), 50)
    ext_ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps, 0.25, BUMP_OFFSET, u_ext), 50)
    tail_ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps + 8, 0.25, BUMP_OFFSET), 50)
    plain_ms = _time_ms(lambda: metropolis.metropolis_chain_plain(
        5, init, sweeps, 0.25, BUMP_OFFSET, u_ext), 3)
    torch_ms = _time_ms(lambda: sampling.metropolis_chain(
        torch.Generator(device=dev).manual_seed(3), init,
        lambda x: sampling.cos_dist_log_prob(
            x, torch.tensor(BUMP_OFFSET, device=dev)),
        sampling.radial_proposal, sweeps, info), 3)
    bound, by, old = _metropolis_bound(total)
    bound_ext, _, _ = _metropolis_bound(total, ext=True)
    print(f"metropolis at {C} chains x {sweeps} sweeps: CUDA kernel Philox "
          f"{ms:.4f} ms (bound {bound:.6f} ms, {by}, share "
          f"{bound / ms:.4f}; without Philox's multiplies {old:.6f} ms, "
          f"share {old / ms:.4f}), external uniforms {ext_ms:.4f} ms (bound "
          f"{bound_ext:.6f} ms, share {bound_ext / ext_ms:.4f}), Philox at "
          f"{sweeps + 8} sweeps {tail_ms:.4f} ms, plain torch on the same "
          f"uniforms {plain_ms:.3f} ms, the torch chain {torch_ms:.3f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, bound_without_philox_ms=old,
                ext_ms=ext_ms, ext_bound_ms=bound_ext)


def phase_var_state_sample(dev):
    """VarState.sample on fluidpaper's flow with 8192 chains: the path
    that reaches the Metropolis kernel."""
    cfg = preset("fluidpaper")
    flow, theta = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, latent_name=cfg.latent_name,
                             offset=cfg.offset, out_scale=cfg.init_scale,
                             dtype=torch.float32, device=dev)
    sampler = sampling.Sampler(2, cfg.latent_name, n_chains=8192,
                               mcmc_info={"offset": np.asarray(cfg.offset),
                                          "bound": cfg.mcmc_bound})
    state = VarState(flow, theta, sampler=sampler)
    n = 2**20
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, logp = state.sample(n, key=1)
    x2, logp2 = state.sample(n, key=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    rate = sampler.last_info.acceptance_rate
    r = (x2 - torch.tensor(cfg.offset, device=dev)).norm(dim=1)
    print(f"VarState.sample, fluidpaper flow, 8192 chains: 2 x {n} samples "
          f"in {wall:.3f} s, launches {counts}, acceptance {rate:.4f}, "
          f"mean radius {float(r.mean()):.5f} (bump {_bump_mean_radius():.5f}"
          f"; the flow starts near the identity)")
    if counts["metropolis"] != 2:
        fail(f"VarState.sample launched the Metropolis kernel "
             f"{counts['metropolis']} times, expected 2")
    if (x.shape != (n, 2) or not torch.isfinite(x).all()
            or not torch.isfinite(logp).all() or not 0.05 < rate < 0.95):
        fail("VarState.sample gave bad samples")
    return counts["metropolis"]


def _acceptance(arrays):
    return float(arrays["mcmc_accepted"].sum()
                 / arrays["mcmc_proposed"].sum())


def phase_fluidpaper():
    state, arrays, counts = _drive(["fluidpaper"], "fluidpaper", 20, dim=2)
    rate = _acceptance(arrays)
    integral = float(state.integrate(Grid(np.ones(2), 150, sym=False)))
    ent = arrays["entropy"]
    print(f"fluidpaper: acceptance {rate:.4f}, grid integral on [0,1]^2 "
          f"{integral:.5f}, entropy {ent[0]:.6f} -> {ent[-1]:.6f} (drift "
          f"{ent[-1] - ent[0]:+.3e}; the field is divergence-free)")
    if not (0.05 < rate < 0.95 and abs(integral - 1.0) < 0.05):
        fail("fluidpaper: acceptance or mass conservation off")


def phase_doublewell():
    state, arrays, _ = _drive(["doubleWell"], "doubleWell", 20, dim=2)
    rate = _acceptance(arrays)
    scale = float(state.sampler.rw_scale)
    print(f"doubleWell: acceptance {rate:.4f}, adapted rw_scale {scale:.4f} "
          f"(preset 0.8, target acceptance 0.234)")
    if not 0.05 < rate < 0.95:
        fail(f"doubleWell acceptance {rate}")


def _syrk_operands(flow, theta, eq, dirs, gen, n, check_persample=False):
    """(O - mean O, E_loc - mean E_loc) of n fresh draws from the
    per-sample kernel's plain mode: the direct path's centered operands,
    and chunk 0 of the chunked path's (its shifts are chunk 0's means)."""
    params = flow.layout.unravel(theta)
    x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                torch.float32))
    if check_persample:
        _persample_vs_plain(flow, theta, x, dirs, "syrk chunk")
    _, g, quad, O = persample.per_sample_cuda(flow, theta, x, dirs)
    eloc = eq.eloc(x, g, quad, 0.0)
    return O - O.mean(0), eloc - eloc.mean()


def _syrk_vs_plain(O_c, cases):
    """syrk_cuda against syrk_plain for each (label, w, tol); returns the
    largest abs error."""
    n, P = O_c.shape
    max_abs = 0.0
    for label, w, tol in cases:
        got = syrk.syrk_cuda(O_c, w)
        ref = syrk.syrk_plain(O_c, w)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        asym = float((got - got.T).abs().max()) / scale
        print(f"syrk kernel vs plain at N={n}, P={P}, {label}: max abs err "
              f"{err:.3e}, relative to the largest entry {err / scale:.3e} "
              f"(tol {tol:.0e}); relative asymmetry {asym:.3e}")
        if not err <= tol * scale:
            fail(f"syrk kernel disagrees with its plain version at N={n} "
                 f"({label})")
        max_abs = max(max_abs, err)
        del got, ref
    return max_abs


def phase_syrk(dev, theta):
    """The syrk kernel on the operands the syrk paths give it, at the theta
    the main path ends on: the direct path's centered O at N=16384 with
    the signed weight E_loc - mean (timed there), and one chunk of the
    chunked path at N=65536 with the weights es and es^2, after the
    plain-mode per-sample kernel that makes the chunk is held against its
    plain version at that N."""
    flow, _, _, eq, dirs = _fp32_problem(dev)
    theta = theta.to(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(4)
    O_c, e_c = _syrk_operands(flow, theta, eq, dirs, gen, 65536,
                              check_persample=True)
    max_abs = _syrk_vs_plain(O_c, (("chunk, unweighted", None, 2e-5),
                                   ("chunk, signed weight es", e_c, 3e-5),
                                   ("chunk, weight es^2", e_c**2, 3e-5)))
    shapes = {"chunk N=65536": _syrk_timed(lambda: syrk.syrk_cuda(O_c), 3,
                                           bounds.syrk(*O_c.shape),
                                           "the chunk, N=65536")}
    del O_c, e_c
    n = 16384
    O_c, e_c = _syrk_operands(flow, theta, eq, dirs, gen, n)
    max_abs = max(max_abs, _syrk_vs_plain(
        O_c, (("unweighted", None, 2e-5),
              ("signed weight E_loc - mean", e_c, 3e-5))))
    P = O_c.shape[1]
    shapes["weighted N=16384"] = _syrk_timed(
        lambda: syrk.syrk_cuda(O_c, e_c), 10, bounds.syrk(n, P, True),
        f"N={n} with the signed weight")
    ms = _time_ms(lambda: syrk.syrk_cuda(O_c), 10)
    plain_ms = _time_ms(lambda: syrk.syrk_plain(O_c), 5)
    lib_ms = _time_ms(lambda: torch.mm(O_c.T, O_c), 5)
    bound = bounds.syrk(n, P)
    print(f"syrk at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain split "
          f"products {plain_ms:.3f} ms, torch.mm f32 (TF32 off) "
          f"{lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), share "
          f"{bound[0] / ms:.3f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
                share_of_bound=bound[0] / ms, shapes=shapes)


def _syrk_timed(fn, reps, bound, label):
    """syrk's time at one more shape, with its bound and share."""
    ms = _time_ms(fn, reps)
    print(f"syrk at {label}: CUDA kernel {ms:.3f} ms, bound {bound[0]:.3f} "
          f"ms ({bound[1]}), share {bound[0] / ms:.3f}")
    return dict(ms=ms, bound_ms=bound[0], bound_by=bound[1],
                share_of_bound=bound[0] / ms)


def phase_syrk_paths(theta):
    """fokkerPlanck32 with --gram-backend syrk: the direct path with exact
    launch counts, its statistics against the f32 Gram's, and the chunked
    path with exact launch counts."""
    n_steps = 5
    _, _, counts = _drive(["fokkerPlanck32", "--gram-backend", "syrk"],
                          "fokkerPlanck32 N=16384 syrk", n_steps)
    want = n_steps * 2 * 2  # S0 and A per RHS
    if counts["syrk"] != want or counts["persample"] != n_steps * 2:
        fail(f"syrk path launches {counts}, expected {want} syrk")
    direct_launches = counts["syrk"]

    n = 16384
    out = {}
    for backend in ("syrk", "auto"):
        cfg = preset("fokkerPlanck32", device="cuda", gram_backend=backend)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = theta.to(device=state.device, dtype=torch.float32)
        params = state.flow.layout.unravel(theta_c)
        gen = torch.Generator(device=state.device).manual_seed(8)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        out[backend] = tdvp._direct_stats(theta_c, 0.0, x)
    for key in ("S0", "F0", "A"):
        full = out["auto"][key]
        rel = _rel(out["syrk"][key], full, full.abs().max())
        print(f"syrk vs f32 Gram {key} at N={n}: max abs diff / max "
              f"{rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            fail(f"syrk {key} differs from the f32 Gram's: {rel}")
    del out

    n_steps, n, c = 2, 131072, 65536
    _, _, counts = _drive(
        ["fokkerPlanck32", "--samples", str(n), "--chunk-size", str(c),
         "--gram-backend", "syrk"],
        f"fokkerPlanck32 N={n} chunked syrk", n_steps)
    chunks = n_steps * 2 * (n // c)
    if counts["syrk"] != 3 * chunks or counts["persample"] != chunks:
        fail(f"chunked syrk launches {counts}, expected {3 * chunks} syrk "
             f"and {chunks} per-sample")
    return direct_launches



def _student_problem(dev):
    """fokkerPlanck32's flow with the Student-t latent and the global
    affine in every block (P=9397): the preset's initial theta, and a
    perturbed one with nu = 2.5 and g_scale 0.9, 1.1, 0.95, 1.05."""
    cfg = preset("fokkerPlanck32")
    flow, theta0 = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                              hidden=cfg.hidden_resolved(),
                              variant=cfg.variant, global_affine=True,
                              latent_name="Student_t",
                              out_scale=cfg.init_scale, dtype=torch.float32,
                              device=dev)
    lay = flow.layout
    if lay.size != 9397:
        fail(f"the Student-t fokkerPlanck32 flow has P={lay.size}, "
             f"expected 9397")
    perturbed = perturb_theta(flow, theta0, np.random.default_rng(0),
                              out_scale=0.03)
    perturbed[lay.offset(("latent", "dist_params"))] = math.log(1.5)
    for b, g in enumerate((0.9, 1.1, 0.95, 1.05)):
        perturbed[lay.offset(("blocks", b, "g_scale"))] = g
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    return flow, theta0, perturbed, dirs


def phase_student_kernel(dev):
    """Phase A: the kernel's Student-t and global-affine branches against
    the plain version at full width, plain and split mode, on the preset's
    initial theta (to TOL) and the perturbed one (to plain f32's own error
    sample by sample, _grade_ok); timed at the main paths' N; then the
    kernel on diffusion_anisotropic's flow with its dense trace
    directions."""
    flow, theta0, perturbed, dirs = _student_problem(dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    n_ga = bounds.flow_ga(flow)
    out = {}
    max_abs = 0.0
    for label, theta, n in (("Student-t perturbed", perturbed, 1024),
                            ("Student-t perturbed", perturbed, 1000),
                            ("Student-t perturbed", perturbed, 16384),
                            ("Student-t initial", theta0, 16384)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        max_abs = max(max_abs, _persample_vs_plain(
            flow, theta, x, dirs, label, grade="perturbed" in label))
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k, n_ga=n_ga)
    print(f"per-sample, Student-t + global affine, at N={n}, P={P}: CUDA "
          f"kernel {ms:.3f} ms, plain torch.func {plain_ms:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}), share {bound[0] / ms:.4f}")
    xp = x[:PILOT_N].contiguous()
    pilot_ms = _time_ms(
        lambda: persample.per_sample_cuda(flow, theta, xp, dirs), 20)
    pilot_bound = bounds.persample(bounds.flow_layers(flow), d, P, PILOT_N,
                                   k, n_ga=n_ga)[0]
    print(f"per-sample, Student-t + global affine, at the pilot's "
          f"N={PILOT_N}: CUDA kernel {pilot_ms:.4f} ms, bound "
          f"{pilot_bound:.4f} ms, share {pilot_bound / pilot_ms:.4f}")
    out["persample"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound[0], bound_by=bound[1], P=P, N=n,
                            share_of_bound=bound[0] / ms,
                            pilot_ms=pilot_ms, pilot_bound_ms=pilot_bound)

    max_abs = 0.0
    for label, theta, n in (("Student-t perturbed", perturbed, 1024),
                            ("Student-t perturbed", perturbed, 1000),
                            ("Student-t initial", theta0, 65536)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        _, shift, err = _split_vs_plain(flow, theta, x, dirs, label,
                                        grade="perturbed" in label)
        max_abs = max(max_abs, err)
    ms = _time_ms(lambda: persample.per_sample_split_cuda(
        flow, theta, x, dirs, shift), 10)
    plain_ms = _time_ms(lambda: persample.per_sample_split_plain(
        flow, theta, x, dirs, shift), 2)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                             split=True, n_ga=n_ga)
    print(f"split per-sample, Student-t + global affine, at N={n}, P={P}: "
          f"CUDA kernel {ms:.3f} ms, plain torch.func + split "
          f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), share "
          f"{bound[0] / ms:.4f}")
    out["persample_split"] = dict(max_abs_err=max_abs, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound[0],
                                  bound_by=bound[1], P=P, N=n,
                                  share_of_bound=bound[0] / ms)
    del x

    acfg = preset("diffusion_anisotropic")
    aflow, atheta = build_flow(acfg.seed, acfg.dim, depth=acfg.depth,
                               hidden=acfg.hidden_resolved(),
                               variant=acfg.variant,
                               out_scale=acfg.init_scale,
                               dtype=torch.float32, device=dev)
    if aflow.layout.size != 762:
        fail(f"diffusion_anisotropic has P={aflow.layout.size}, "
             f"expected 762")
    aeq = make_equation(acfg.equation, acfg.dim, **acfg.equation_params)
    adirs = torch.as_tensor(aeq.hessian_trace_dirs(acfg.dim),
                            dtype=torch.float32, device=dev)
    aperturbed = perturb_theta(aflow, atheta, np.random.default_rng(1),
                               out_scale=0.03)
    for label, theta in (("anisotropic initial", atheta),
                         ("anisotropic perturbed", aperturbed)):
        params = aflow.layout.unravel(theta)
        x, _ = aflow.push(params, aflow.latent_sample(gen, params, 16384,
                                                      torch.float32))
        _persample_vs_plain(aflow, theta, x, adirs, label,
                            grade="perturbed" in label)
    return out


def phase_student_path():
    """Phase B: fokkerPlanck32 with the Student-t latent and the global
    affine through driver.run at N=16384: one plain-mode launch per RHS,
    no NaN, residual below 1e-3; nu per step."""
    n_steps = 4
    cfg = preset("fokkerPlanck32", latent_name="Student_t",
                 global_affine=True, device="cuda")
    state, arrays, counts = _drive(
        None, "fokkerPlanck32 Student-t + global affine N=16384", n_steps,
        cfg=cfg)
    if counts["persample"] != 2 * n_steps:
        fail(f"the Student-t path launched the per-sample kernel "
             f"{counts['persample']} times, expected {2 * n_steps}")
    nu = np.exp(arrays["dist_params"][:, 0]) + 1.0
    print(f"fokkerPlanck32 Student-t: nu per step "
          f"{' '.join(f'{v:.7f}' for v in nu)}")
    return state, counts


def _crn_entropy(n=65536, seed=123):
    """(values, callback): the flow's entropy -E[log p] in f64 on common
    random numbers (the same generator seed every step), so that its
    change from step to step is the model's, free of Monte Carlo noise."""
    values = []

    def cb(n_step, t, state, info):
        theta = state.theta.double()
        params = state.flow.layout.unravel(theta)
        gen = torch.Generator(device=theta.device).manual_seed(seed)
        z = state.flow.latent_sample(gen, params, n, torch.float64)
        values.append(float(-state.flow.push(params, z)[1].mean()))

    return values, cb


def phase_diffusion():
    """Phase C: the d=8 Student-t diffusion preset through the CLI with
    the per-sample kernel (P=365: auto would leave it on torch), 20 steps:
    exactly one plain-mode launch and one block-variant Jacobi launch (the
    eigh solve of P=365) per RHS (direct statistics, the
    observables on the same batch), no NaN, residual below 1e-3, the
    entropy on common random numbers rising every step; then 10 steps with
    --is-gamma 0.5 (one launch per RHS; observables resample without the
    kernel) and the IS weights' effective sample share."""
    n_steps = 20
    ent, cb = _crn_entropy()
    _, arrays, counts = _drive(["diffusion", "--per-sample-backend", "cuda"],
                               "diffusion (d=8, Student-t) N=10000", n_steps,
                               dim=8, callbacks=[cb])
    if (counts["persample"] != 2 * n_steps
            or counts["jacobi_blocks"] != 2 * n_steps):
        fail(f"diffusion launched {counts}, expected {2 * n_steps} "
             f"per-sample and block-variant Jacobi kernels (one a RHS)")
    rise = np.diff(ent)
    nu = np.exp(arrays["dist_params"][:, 0]) + 1.0
    print(f"diffusion: f64 entropy on common random numbers (N=65536) "
          f"{ent[0]:.9f} -> {ent[-1]:.9f}, smallest step-to-step rise "
          f"{rise.min():.3e}; nu {nu[0]:.7f} -> {nu[-1]:.7f}; recorded MC "
          f"entropy {arrays['entropy'][0]:.5f} -> {arrays['entropy'][-1]:.5f}")
    if not (rise > 0).all():
        fail(f"diffusion entropy did not rise every step: {rise}")
    launches = counts["persample"], counts["jacobi_blocks"]

    n_is = 10
    _, arrays, counts = _drive(
        ["diffusion", "--per-sample-backend", "cuda", "--is-gamma", "0.5"],
        "diffusion --is-gamma 0.5", n_is, dim=8)
    if counts["persample"] != 2 * n_is:
        fail(f"diffusion --is-gamma launched the per-sample kernel "
             f"{counts['persample']} times, expected {2 * n_is}")
    ess = arrays["is_ess_share"]
    print(f"diffusion --is-gamma 0.5: IS effective sample share per step "
          f"{' '.join(f'{v:.4f}' for v in ess)}")
    if not ((ess > 0) & (ess <= 1)).all():
        fail(f"IS effective sample share out of (0, 1]: {ess}")
    return launches


def phase_anisotropic_and_oscillators():
    """Phase D: diffusion_anisotropic in f64 (the torch pipeline; the
    kernel is f32 only) against Sigma(t) = I + 2 t D and the entropy
    1/2 log det(2 pi e Sigma(t)); then harmonicOsc and harmonicOsc_diff
    for 20 steps each."""
    n_steps = 50
    cfg = preset("diffusion_anisotropic", precision="f64", device="cuda",
                 verbose=False)
    _, a, _ = _drive(None, "diffusion_anisotropic f64 N=10000", n_steps,
                     dim=12, cfg=cfg)
    D = make_equation("diffusion_anisotropic", 12).D_matrix
    t, N = a["times"][-1], cfg.n_samples_obs
    sigma = np.eye(12) + 2.0 * t * D
    cov_err = np.abs(a["covar"][-1] - sigma).max()
    # Gaussian sample covariance: Var(S_ij) = (S_ii S_jj + S_ij^2) / N;
    # Var(-log p) = d/2 for a Gaussian
    se_cov = math.sqrt(float((np.outer(np.diag(sigma), np.diag(sigma))
                              + sigma**2).max()) / N)
    ent = 0.5 * np.linalg.slogdet(2 * math.pi * math.e * sigma)[1]
    ent_err = abs(a["entropy"][-1] - ent)
    se_ent = math.sqrt(6.0 / N)
    print(f"diffusion_anisotropic f64 at t={t:.4f} (D's eigenvalues "
          f"{np.linalg.eigvalsh(D).min():.3f}..{np.linalg.eigvalsh(D).max():.3f}"
          f"): covar max abs err {cov_err:.4f} (5 SE {5 * se_cov:.4f}), "
          f"entropy {a['entropy'][-1]:.5f} vs {ent:.5f} (5 SE "
          f"{5 * se_ent:.4f}), solver_res {a['solver_res'][-1]:.3e}")
    if not (t > 0.05 and cov_err < 5 * se_cov and ent_err < 5 * se_ent):
        fail("diffusion_anisotropic misses Sigma(t) = I + 2 t D")

    state, a, _ = _drive(["harmonicOsc"], "harmonicOsc", 20, dim=2)
    ent = math.log(2 * math.pi * math.e)  # the initial N(offset, I)
    se = math.sqrt(1.0 / preset("harmonicOsc").n_samples_obs)
    drift = np.abs(a["entropy"] - ent).max()
    integral = float(state.integrate(Grid(np.ones(2) * 8.0, 200)))
    print(f"harmonicOsc: entropy {a['entropy'][0]:.5f} -> "
          f"{a['entropy'][-1]:.5f}, largest distance from log(2 pi e) "
          f"{drift:.4f} (5 SE {5 * se:.4f}; Liouville transport conserves "
          f"it), grid integral on [-8, 8]^2 {integral:.5f}")
    if not (drift < 5 * se and abs(integral - 1.0) < 0.05):
        fail("harmonicOsc: entropy not conserved or mass lost")
    _drive(["harmonicOsc_diff"], "harmonicOsc_diff", 20, dim=6)


def _time_all_reduces(log):
    """Time every torch.distributed.all_reduce (what parallel/mesh.py
    calls) between two device synchronizations, with its bytes: ``log``
    accumulates "s" and "bytes"."""
    plain = dist.all_reduce

    def timed(tensor, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(tensor, *args, **kw)
        torch.cuda.synchronize()
        log["s"] += time.perf_counter() - t0
        nbytes = tensor.numel() * tensor.element_size()
        log["bytes"] += nbytes
        if "calls" in log:
            log["calls"].append((nbytes, kw.get("group")))
        return out

    dist.all_reduce = timed


def _rank_drive(cfg, n_steps, label, log):
    """``driver.run`` of this rank for n_steps with every count set to 0
    just before: the counts just after, each step's wall time and its
    all-reduce seconds and bytes, and whether theta was bitwise the
    coordinator's after every step (checked outside the step's time)."""
    stamps, starts, ar_s, ar_bytes, same = [], [], [], [], []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ar_s.append(log["s"])
        ar_bytes.append(log["bytes"])
        theta = state.get_parameters()
        same.append(bool(torch.equal(
            theta, mesh.broadcast_from_coordinator(theta))))
        torch.cuda.synchronize()
        log.update(s=0.0, bytes=0)
        starts.append(time.perf_counter())

    _zero_counts()
    log.update(s=0.0, bytes=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rec = driver.run(cfg, max_steps=n_steps, callbacks=[record])
    counts = _counts()
    steps = np.array(stamps) - np.array([t0] + starts[:-1])
    a = rec.as_arrays()
    for key in ("solver_res", "tdvp_error", "entropy", "covar", "x1"):
        if not np.isfinite(a[key]).all():
            fail(f"non-finite {key} in the {label} run")
    if a["nan"].any() or not (a["solver_res"] < 1e-3).all():
        fail(f"{label}: NaN or residual above 1e-3: {a['solver_res']}")
    if not all(same) or len(same) != n_steps:
        fail(f"{label}: theta differs across ranks after a step: {same}")
    if mesh.is_coordinator():
        share = (f"share of steps 2-{n_steps} "
                 f"{sum(ar_s[1:]) / steps[1:].sum():.3f}" if n_steps > 1
                 else f"share {ar_s[0] / steps[0]:.3f}")
        print(f"[mesh] {label}: {n_steps} Heun steps per rank, wall s/step "
              f"{' '.join(f'{v:.3f}' for v in steps)} (first includes "
              f"set-up), all-reduce s/step "
              f"{' '.join(f'{v:.3f}' for v in ar_s)} (gloo through the host, "
              f"{ar_bytes[-1] / 2 / 1e6:.1f} MB per RHS), {share}; "
              f"solver_res {' '.join(f'{r:.3e}' for r in a['solver_res'])};"
              f" launches on rank 0 {counts}", flush=True)
    return state, dict(step_s=steps.tolist(), all_reduce_s=ar_s,
                       all_reduce_bytes_per_rhs=ar_bytes[-1] / 2,
                       counts=counts)


def _sharded_vs_one_rank(ctx, cfg, ref_cfg, theta, n, label):
    """The mesh's statistics on one batch (this rank's rows of a global
    draw) against one rank's on the whole batch, computed by the
    coordinator (``ref_cfg``): S0, F0 and A within 1e-4 of each one's
    largest value."""
    state, tdvp = driver.build_problem(cfg)[:2]
    chunked = cfg.chunk_size > 0
    theta_c = theta.to(device=ctx.device, dtype=torch.float32)
    params = state.flow.layout.unravel(theta_c)
    gen = torch.Generator(device=ctx.device).manual_seed(7)
    z = state.flow.latent_sample(gen, params, n, torch.float32)
    # the rank's rows: of the W sample shards (shard_map), or of the dp
    # shards under GSPMD (tdvp.ctx)
    x_loc = state.flow.push(params, tdvp.ctx.local_rows(z))[0]
    fn = tdvp._chunked_stats if chunked else tdvp._direct_stats
    st = fn(theta_c, 0.0, x_loc)
    del tdvp, x_loc
    out = {}
    torch.cuda.synchronize()
    if ctx.rank == 0:
        one = ParallelCtx.single_device(ctx.device)
        rtdvp = driver.build_problem(ref_cfg, ctx=one)[1]
        x = state.flow.push(params, z)[0]
        ref = (rtdvp._chunked_stats if chunked
               else rtdvp._direct_stats)(theta_c, 0.0, x)
        for key in ("S0", "F0", "A"):
            out[key] = _rel(st[key], ref[key], ref[key].abs().max())
        print(f"[mesh] {label} vs one rank's f32 statistics on the same "
              f"N={n} draws: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in out.items())
              + " (max abs diff / max, tol 1e-4)", flush=True)
        if not all(v <= 1e-4 for v in out.values()):
            fail(f"{label} differs from one rank's statistics: {out}")
        del rtdvp, ref, x
    del st
    torch.cuda.synchronize()
    mesh.sync_global_devices()
    return out


def _coordinator_times(ctx, fns):
    """Time each (label, fn, reps) on the coordinator while the other
    ranks wait at a barrier with an idle card; {label: ms}."""
    torch.cuda.synchronize()
    out = {}
    if ctx.rank == 0:
        out = {label: _time_ms(fn, reps) for label, fn, reps in fns}
    mesh.sync_global_devices()
    return out


def phase_mesh_stats(ctx, log):
    """Phase 19 on this rank: (a) direct and (b) chunked shard_map
    statistics through driver.run, each against one rank on one batch;
    (c) per_sample_sharded against its plain version, timed, and the GSPMD
    counterpart through driver.run."""
    W = ctx.world
    base = dict(device="cuda", mesh_dp=W, verbose=False)
    n_steps = 3
    cfg = preset("fokkerPlanck32", stats_partitioning="shard_map", **base)
    state, direct = _rank_drive(cfg, n_steps, "19a fokkerPlanck32 N=16384 "
                                "shard_map direct", log)
    if direct["counts"]["persample"] != 2 * n_steps:
        fail(f"19a: plain-mode launches {direct['counts']} on rank "
             f"{ctx.rank}, expected {2 * n_steps}")
    theta = state.get_parameters()
    direct["vs_one_rank"] = _sharded_vs_one_rank(
        ctx, cfg, preset("fokkerPlanck32", device="cuda"), theta, 16384,
        "19a direct, 4 ranks")
    del state

    n_steps, n, c = 2, 262144, 65536
    over = dict(n_samples_tdvp=n, n_samples_obs=n, chunk_size=c)
    cfg = preset("fokkerPlanck32", stats_partitioning="shard_map",
                 gram_backend="tri2", gram_cross="int8", **over, **base)
    _, chunked = _rank_drive(cfg, n_steps, "19b fokkerPlanck32 N=262144 "
                             "chunk 65536 shard_map tri2+int8", log)
    local_chunks = (n // W) // (c // W)
    want = n_steps * 2 * local_chunks
    got = chunked["counts"]
    if (got["persample_split"] != want or got["quant8"] != 2 * want
            or got["persample"] != n_steps * 2):
        fail(f"19b: launches {got} on rank {ctx.rank}, expected {want} "
             f"split, {2 * want} quant8, {n_steps * 2} pilot")
    chunked["vs_one_rank"] = _sharded_vs_one_rank(
        ctx, cfg, preset("fokkerPlanck32", device="cuda", **over), theta, n,
        "19b chunked tri2+int8, 4 ranks")

    # (c) the sharded per-sample wrapper on a rank's rows at the preset's
    # theta, against its plain version, then timed
    flow, theta0, _, eq, dirs = _fp32_problem(ctx.device)
    params = flow.layout.unravel(theta0)
    gen = torch.Generator(device=ctx.device).manual_seed(11)
    x_loc = ctx.local_rows(flow.push(params, flow.latent_sample(
        gen, params, 16384, torch.float32))[0])
    got = persample.per_sample_sharded(ctx, flow, theta0, x_loc, dirs)
    ref = persample.per_sample_plain(flow, theta0.double(), x_loc.double(),
                                     dirs.double())
    max_abs = float((got[3].double() - ref[3]).abs().max())
    for name, a, r in zip(("logp", "g", "quad", "O"), got, ref):
        rel = _rel(a, r)
        if not rel < TOL[name]:
            fail(f"per_sample_sharded {name} on rank {ctx.rank}: {rel:.3e}")
    del got, ref
    ms = _coordinator_times(ctx, [
        ("ms", lambda: persample.per_sample_cuda(flow, theta0, x_loc,
                                                 dirs), 20),
        ("plain_ms", lambda: persample.per_sample_plain(flow, theta0, x_loc,
                                                        dirs), 3)])
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    bound = bounds.persample(bounds.flow_layers(flow), d, P,
                             x_loc.shape[0], k)
    del x_loc
    n_steps = 2
    cfg = preset("fokkerPlanck32", eloc_clip=2.0, **base)
    _, gspmd = _rank_drive(cfg, n_steps, "19c fokkerPlanck32 N=16384 GSPMD "
                           "counterpart, eloc_clip=2", log)
    if gspmd["counts"]["persample_sharded"] != 2 * n_steps:
        fail(f"19c: sharded per-sample launches {gspmd['counts']} on rank "
             f"{ctx.rank}, expected {2 * n_steps}")
    kernel = dict(max_abs_err=max_abs, bound_ms=bound[0], bound_by=bound[1],
                  launches=gspmd["counts"]["persample_sharded"],
                  rows_per_rank=16384 // W, **ms)
    if ctx.rank == 0:
        kernel["share_of_bound"] = bound[0] / ms["ms"]
        print(f"[mesh] per_sample_sharded on a rank's {16384 // W} rows, "
              f"P={P}: max abs err of O {max_abs:.3e}; CUDA kernel "
              f"{ms['ms']:.3f} ms, plain torch.func {ms['plain_ms']:.3f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]}), share "
              f"{bound[0] / ms['ms']:.4f}, the other ranks idle",
              flush=True)
    return dict(direct=direct, chunked=chunked, gspmd=gspmd), kernel


def phase_mesh_metropolis(ctx):
    """Phase 20 on this rank: the sharded Metropolis kernel against its
    plain version and, gathered, against the single launch; timed; then
    VarState.sample on the mesh."""
    W, dev = ctx.world, ctx.device
    C = 8192
    C_loc = C // W
    base = ctx.rank * C_loc
    max_abs = 0.0
    # 128 sweeps, the VarState.sample launch; 136, a last chunk of 8
    for sweeps in (128, 136):
        init_all, u, outside = _metropolis_inputs(dev, C, sweeps)
        init = ctx.local_rows(init_all)
        u_loc = u.reshape(6, sweeps, C)[:, :, base:base + C_loc].reshape(
            6, -1)
        for label, uu, uu_loc in (("external uniforms", u, u_loc),
                                  ("Philox", None, None)):
            s, f, acc = metropolis.metropolis_chain_sharded(
                ctx, 5, init, sweeps, 0.25, BUMP_OFFSET, uu)
            ps, pf, pacc = metropolis.metropolis_chain_plain(
                5, init, sweeps, 0.25, BUMP_OFFSET, uu_loc, chain_base=base)
            (pacc,) = mesh.all_reduce_sum(ctx, [pacc])
            err = max(float((s - ps).abs().max()),
                      float((f - pf).abs().max()))
            stuck = s.reshape(sweeps, C_loc, 2)[:8, ctx.local_rows(outside)]
            rejected = uu is None or torch.equal(
                stuck, init[ctx.local_rows(outside)].expand_as(stuck))
            if int(acc) != int(pacc) or not err <= 2e-6 or not rejected:
                fail(f"metropolis_chain_sharded ({label}, {sweeps} sweeps) "
                     f"on rank {ctx.rank}: accepted {int(acc)} vs plain "
                     f"{int(pacc)}, max abs err {err:.3e}, rim proposals "
                     f"outside the support rejected: {rejected}")
            max_abs = max(max_abs, err)
            gathered = metropolis.gather_sweep_major(ctx, s, sweeps)
            final = mesh.all_gather_rows(ctx, f)
            if ctx.rank == 0:
                single = metropolis.metropolis_chain_cuda(
                    5, init_all, sweeps, 0.25, BUMP_OFFSET, uu)
                same = (torch.equal(gathered, single[0])
                        and torch.equal(final, single[1])
                        and int(acc) == int(single[2]))
                print(f"[mesh] metropolis_chain_sharded, {W} ranks x "
                      f"{C_loc} chains x {sweeps} sweeps, {label}: accepted "
                      f"{int(acc)} (single launch {int(single[2])}), "
                      f"gathered samples and final states bitwise the "
                      f"single launch's: {same}; each rank vs its plain "
                      f"version max abs err {err:.3e}", flush=True)
                if not same:
                    fail(f"the sharded Metropolis kernel ({label}) does not "
                         "replay the single launch")
    sweeps = 128
    init = ctx.local_rows(torch.tensor(BUMP_OFFSET, device=dev).repeat(C, 1))
    u_loc = u_loc[:, :sweeps * C_loc].contiguous()
    ms = _coordinator_times(ctx, [
        ("ms", lambda: metropolis.metropolis_chain_cuda(
            5, init, sweeps, 0.25, BUMP_OFFSET, chain_base=base), 20),
        ("ext_ms", lambda: metropolis.metropolis_chain_cuda(
            5, init, sweeps, 0.25, BUMP_OFFSET, u_loc, chain_base=base), 20),
        ("plain_ms", lambda: metropolis.metropolis_chain_plain(
            5, init, sweeps, 0.25, BUMP_OFFSET, u_loc, chain_base=base), 3)])
    bound = _metropolis_bound(C_loc * sweeps)
    bound_ext = _metropolis_bound(C_loc * sweeps, ext=True)

    cfg = preset("fluidpaper")
    flow, theta = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, latent_name=cfg.latent_name,
                             offset=cfg.offset, out_scale=cfg.init_scale,
                             dtype=torch.float32, device=dev)
    sampler = sampling.Sampler(2, cfg.latent_name, n_chains=C,
                               mcmc_info={"offset": np.asarray(cfg.offset),
                                          "bound": cfg.mcmc_bound}, ctx=ctx)
    state = VarState(flow, theta, sampler=sampler, ctx=ctx)
    n = 2**20
    _zero_counts()
    x, logp = state.sample(n, key=1)
    x2, _ = state.sample(n, key=2)
    counts = _counts()
    rate = sampler.last_info.acceptance_rate
    if (counts["metropolis_sharded"] != 2 or counts["metropolis"] != 2
            or x.shape != (n // W, 2) or not torch.isfinite(x).all()
            or not torch.isfinite(logp).all() or not 0.05 < rate < 0.95):
        fail(f"VarState.sample on the mesh, rank {ctx.rank}: launches "
             f"{counts}, shard {tuple(x.shape)}, acceptance {rate}")
    if ctx.rank == 0:
        print(f"[mesh] per-rank Metropolis launch, {C_loc} chains x "
              f"{sweeps} sweeps: Philox {ms['ms']:.4f} ms (bound "
              f"{bound[0]:.6f} ms, {bound[1]}, share "
              f"{bound[0] / ms['ms']:.4f}; without Philox's multiplies "
              f"{bound[2]:.6f} ms, share {bound[2] / ms['ms']:.4f}), "
              f"external uniforms {ms['ext_ms']:.4f} ms (bound "
              f"{bound_ext[0]:.6f} ms, share "
              f"{bound_ext[0] / ms['ext_ms']:.4f}), plain torch "
              f"{ms['plain_ms']:.3f} ms, the other ranks idle; "
              f"VarState.sample on the "
              f"mesh, 8192 chains: 2 x {n} samples, launches per rank "
              f"{counts['metropolis_sharded']}, acceptance {rate:.4f}",
              flush=True)
    return dict(max_abs_err=max_abs, ms=ms["ms"] if ms else None,
                ext_ms=ms.get("ext_ms"), plain_ms=ms.get("plain_ms"),
                bound_ms=bound[0], bound_by=bound[1],
                bound_without_philox_ms=bound[2], ext_bound_ms=bound_ext[0],
                launches=counts["metropolis_sharded"],
                chains_per_rank=C_loc)


# -- phase K: the rest of the mesh path, in the rank processes of phases
# 19-20 (4 gloo ranks on the one card)


def _rhs_vs_one_rank(ctx, cfg, theta, key, label, bar, keys=("update",)):
    """One rhs() of ``cfg`` on the mesh at theta with key ``key`` (every
    rank draws the same global block) against one rank's, computed by the
    coordinator while the others wait: the update's distance over its
    norm and each other output's max abs difference over its largest
    value, each within ``bar`` (None: printed, not gated); the RHS times
    of both; the per-sample launches of the mesh's RHS; whether every
    rank holds the coordinator's update."""
    state, tdvp = driver.build_problem(cfg)[:2]
    theta_m = theta.to(device=ctx.device, dtype=state.precision.master)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upd, aux = tdvp.rhs(theta_m, 0.0, key)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    same = bool(torch.equal(upd, mesh.broadcast_from_coordinator(upd)))
    # the GSPMD route counts its launches in the sharded wrapper (whose
    # kernel is per_sample_cuda's, counted there too)
    out = dict(ms=ms, launches=counts["persample_sharded" if tdvp._gspmd
                                      else "persample"],
               same_on_every_rank=same, gspmd=tdvp._gspmd, rows=tdvp._rows)
    got = {"update": upd, **{k: aux[k] for k in keys if k != "update"}}
    del tdvp, state, aux
    torch.cuda.synchronize()
    if mesh.is_coordinator():
        one = ParallelCtx.single_device(ctx.device)
        rtdvp = driver.build_problem(cfg, ctx=one)[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_upd, ref_aux = rtdvp.rhs(theta_m, 0.0, key)
        torch.cuda.synchronize()
        out["one_rank_ms"] = (time.perf_counter() - t0) * 1e3
        ref = {"update": ref_upd, **{k: ref_aux[k] for k in keys
                                     if k != "update"}}
        out["rel"] = {k: float((got[k].double() - ref[k].double()).norm()
                               / ref[k].double().norm()) if k == "update"
                      else _rel(got[k], ref[k], ref[k].abs().max())
                      for k in got}
        print(f"[mesh K] {label}: RHS {ms:.1f} ms on 4 ranks, "
              f"{out['one_rank_ms']:.1f} ms on one; against one rank: "
              + ", ".join(f"{k} {v:.3e}" for k, v in out["rel"].items())
              + f" (tol {bar}); per-sample launches on rank 0 "
              f"{out['launches']}; update bitwise on every rank {same}",
              flush=True)
        if bar is not None and not all(v <= bar
                                       for v in out["rel"].values()):
            fail(f"{label} differs from one rank's: {out['rel']}")
        del rtdvp, ref_aux, ref
    if not same or not torch.isfinite(upd).all():
        fail(f"{label}: the update is not finite or differs across ranks")
    torch.cuda.synchronize()
    mesh.sync_global_devices()
    return out


def _release():
    """Hand this rank's cached device memory back before the next run:
    four ranks share the card, and each one's allocator keeps what its
    last run freed."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh.sync_global_devices()


def _peaks(ctx):
    """Every rank's peak device memory in GB (rank order)."""
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                        dtype=torch.float64, device=ctx.device)
    return mesh.all_gather_rows(ctx, peak).tolist()


def phase_mesh_k(ctx, log):
    """Phase K on this rank (4 gloo ranks on the one card), fokkerPlanck32
    at full width through driver.run / driver.build_problem:

    K1. GSPMD statistics at dp=2 x tp=2 for 2 Heun steps: theta bitwise
        across ranks after each step, residual < 1e-3, 2 sharded
        per-sample launches per step on each rank; against one rank's f32
        statistics within 1e-4; the dp-group reduction of the moments
        carries ceil(P/2) P 4 bytes per (P, P) moment.
    K2. auto at dp=2 x tp=2 on the depth-8 flow (P > 16384): GSPMD with
        tp row blocks, 1 step, each rank's peak memory beside a shard_map
        step of the same flow.
    K3. chunked GSPMD at dp=4, sym2 + int8, N=131072 in chunks of 32768,
        2 steps: one plain-mode launch per chunk a rank holds per RHS, no
        split or quant8 launch; against one rank within 1e-4; then one
        f64acc step of the same.
    K4. one RHS each on 4 ranks against one rank's on the same draws: cg
        (1e-3), minSR direct and streaming (chunks of 256) on
        scripts/bench_minsr.py's flow, the default and f64 precisions,
        the host solve (cholesky), with each one's RHS time beside one
        rank's."""
    W = ctx.world
    base = dict(device="cuda", verbose=False)
    out = {}
    _release()

    # K1
    n_steps = 2
    cfg = preset("fokkerPlanck32", stats_partitioning="gspmd", mesh_dp=2,
                 mesh_tp=2, **base)
    log["calls"] = []
    state, k1 = _rank_drive(cfg, n_steps, "K1 fokkerPlanck32 N=16384 GSPMD "
                            "dp2 x tp2 (tp-row Gram)", log)
    calls = log.pop("calls")
    m22 = ParallelCtx.create(dp=2, tp=2, device="cuda")
    dp_pg = mesh._process_group(m22.samples_over_dp())
    P = state.flow.layout.size
    b = -(-P // 2)
    dp_bytes = max(nb for nb, g in calls if g is dp_pg)
    want = (2 * b * P + P + 1) * 4
    if k1["counts"]["persample_sharded"] != 2 * n_steps:
        fail(f"K1: sharded per-sample launches {k1['counts']} on rank "
             f"{ctx.rank}, expected {2 * n_steps}")
    if dp_bytes != want:
        fail(f"K1: the dp-group moments reduction carries {dp_bytes} B, "
             f"expected {want} (S0 and A blocks of {b} x {P}, F0, the "
             "E_loc variance)")
    theta0 = state.get_parameters()
    k1["dp_moments_bytes_per_rhs"] = dp_bytes
    k1["bytes_per_moment"] = b * P * 4
    if mesh.is_coordinator():
        print(f"[mesh K] K1: the dp-group reduction of the moments carries "
              f"{dp_bytes} B per RHS on each rank: {b} x {P} x 4 = "
              f"{b * P * 4} B per (P, P) moment (S0, A), with F0 and the "
              f"E_loc variance", flush=True)
    k1["vs_one_rank"] = _sharded_vs_one_rank(
        ctx, cfg, preset("fokkerPlanck32", device="cuda"), theta0, 16384,
        "K1 GSPMD dp2 x tp2")
    out["K1"] = k1
    del state
    _release()

    # K2
    flow_over = dict(depth=8)
    peaks = {}
    for route in ("auto", "shard_map"):
        cfg = preset("fokkerPlanck32", stats_partitioning=route, mesh_dp=2,
                     mesh_tp=2, **flow_over, **base)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if route == "auto":
            _, tdvp = driver.build_problem(cfg)[:2]
            P2 = tdvp.n_params
            if not (P2 > 16384 and tdvp._gspmd
                    and tdvp._rows == ParallelCtx(
                        dp=2, tp=2, rank=ctx.rank).row_block(P2)):
                fail(f"K2: auto at dp2 x tp2, P={P2}: GSPMD "
                     f"{tdvp._gspmd}, rows {tdvp._rows}")
            del tdvp
        _, rec = _rank_drive(cfg, 1, f"K2 depth-8 flow (P={P2}) dp2 x tp2 "
                             f"{route}", log)
        torch.cuda.synchronize()
        peaks[route] = _peaks(ctx)
        rec["peak_gb_by_rank"] = peaks[route]
        out[f"K2_{route}"] = rec
        _release()
    if mesh.is_coordinator():
        print(f"[mesh K] K2: P={P2}, peak device memory by rank (GB): GSPMD "
              f"tp rows {' '.join(f'{v:.2f}' for v in peaks['auto'])}; "
              f"shard_map {' '.join(f'{v:.2f}' for v in peaks['shard_map'])}"
              , flush=True)

    # K3
    n, c = 131072, 32768
    over = dict(n_samples_tdvp=n, n_samples_obs=16384, chunk_size=c,
                gram_backend="sym2", gram_cross="int8")
    for prec, n_steps in (("high", 2), ("f64acc", 1)):
        cfg = preset("fokkerPlanck32", stats_partitioning="gspmd", mesh_dp=W,
                     gram_precision=prec, **over, **base)
        label = (f"K3 fokkerPlanck32 N={n} chunks of {c} GSPMD dp={W} "
                 f"sym2+int8 {prec}")
        _, rec = _rank_drive(cfg, n_steps, label, log)
        got = rec["counts"]
        held = (n // W) // c or 1
        if (got["persample_sharded"] != 2 * n_steps * held
                or got["persample_split"] or got["quant8"]):
            fail(f"K3 {prec}: launches {got} on rank {ctx.rank}, expected "
                 f"{2 * n_steps * held} plain-mode, no split, no quant8")
        if prec == "high":
            rec["vs_one_rank"] = _sharded_vs_one_rank(
                ctx, cfg, preset("fokkerPlanck32", device="cuda", **over),
                theta0, n, "K3 chunked GSPMD sym2+int8, 4 ranks")
        out[f"K3_{prec}"] = rec
        _release()

    # K4. f32 solves at fokkerPlanck32's condition (~1e5) amplify the
    # sums' order: the default precision is held on its statistics and
    # its update printed; the f64 precision and the host solve take f64
    # statistics and an f64 solve
    k4 = {}
    bench = MINSR_FLOWS["bench_minsr d=32 depth 8 N=1024"]
    for label, over, bar, keys in (
            ("cg", dict(solver_method="cg"), 1e-3, ("update",)),
            ("minsr direct (bench_minsr flow)",
             dict(bench, solver_method="minsr"), 1e-3,
             ("update", "ev")),
            ("minsr streaming, chunks of 256 (bench_minsr flow)",
             dict(bench, solver_method="minsr", chunk_size=256), 1e-3,
             ("update", "ev")),
            ("default precision", dict(gram_precision="default"), None,
             ("update",)),
            ("f64 precision", dict(gram_precision="f64",
                                   precision="tpu_f64stats"), 1e-3,
             ("update",)),
            ("host solve (cholesky)", dict(
                solve_on_device=False, gram_precision="f64",
                precision="tpu_f64stats"), 1e-3, ("update",))):
        cfg = preset("fokkerPlanck32", mesh_dp=W, **{**base, **over})
        theta = theta0
        if "depth" in over:
            theta = driver.build_problem(cfg, ctx=ParallelCtx.single_device(
                "cuda"))[0].get_parameters()
        k4[label] = _rhs_vs_one_rank(ctx, cfg, theta, 77, f"K4 {label}",
                                     bar, keys)
        _release()
        if label == "default precision":
            k4[label]["vs_one_rank"] = _sharded_vs_one_rank(
                ctx, cfg, preset("fokkerPlanck32", device="cuda",
                                 gram_precision="default"), theta, 16384,
                "K4 default precision statistics")
    out["K4"] = k4
    return out



def _rank_allocator():
    """Expandable segments for a rank's caching allocator, set before the
    rank first touches the card: four ranks and the parent share its 80
    GB, and phase K3's chunks (a (16, P, P) f32 block product, then
    smaller blocks) left each rank ~6.7 GB reserved but unallocated, which
    ran the card out of memory."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def _mesh_rank(rank, world, rendezvous, results):
    """One rank of phases 19 and 20 (a spawned process): its outcome goes
    to the ``results`` queue, a traceback on failure."""
    try:
        _rank_allocator()
        mesh.distributed_init(f"file://{rendezvous}", world, rank)
        ctx = ParallelCtx.create(dp=world, device="cuda")
        full_f32_matmuls()
        log = {"s": 0.0, "bytes": 0}
        _time_all_reduces(log)
        paths, ps_kernel = phase_mesh_stats(ctx, log)
        mc_kernel = phase_mesh_metropolis(ctx)
        t0 = time.perf_counter()
        mesh_k = phase_mesh_k(ctx, log)
        mesh_k["seconds"] = time.perf_counter() - t0
        results.put((rank, True, dict(paths=paths, persample_sharded=ps_kernel,
                                      metropolis_sharded=mc_kernel,
                                      mesh_k=mesh_k)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_mesh():
    """Phases 19 and 20: MESH_WORLD rank processes on the one card (spawn:
    CUDA is initialized here; the kernels are built, the ranks only load
    them); each rank's outcome, rank 0's first. A rank that fails or
    outlives the time limit fails the phase, and every rank is stopped."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spawn = multiprocessing.get_context("spawn")
    results = spawn.Queue()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    procs = [spawn.Process(target=_mesh_rank, args=(
        r, MESH_WORLD, os.path.join(tmp, "rendezvous"), results))
        for r in range(MESH_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + 600
        while len(out) < MESH_WORLD:
            try:
                rank, ok, payload = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                fail("the mesh ranks did not finish within 600 s")
            if not ok:
                fail(f"mesh rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phases 19-20: {MESH_WORLD} ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    return [out[r] for r in range(MESH_WORLD)]


# The steppers' stages per step (or per attempt of the adaptive ones)
STAGES = {"fixed_euler": 1, "fixed_heun": 2, "fixed_rk3": 3,
          "adaptive_heun": 5, "adaptive_rk23": 4}


def _step_table(label, arrays):
    """Print each step's t, dt, attempts, error and residual."""
    att = arrays.get("attempts", np.ones(len(arrays["times"]), int))
    err = arrays.get("step_error", np.full(len(arrays["times"]), np.nan))
    for i, t in enumerate(arrays["times"]):
        print(f"{label} step {i}: t {t:.6e} dt {arrays['dt'][i]:.6e} "
              f"attempts {int(att[i])} error {err[i]:.4e} solver_res "
              f"{arrays['solver_res'][i]:.3e}")
    return [int(a) for a in att]


def _matfree_pass_ms(args, reps=10):
    """(matrix-free pass ms, one per-sample launch ms) on a path: one rhs()
    at the preset's initial theta stashes the last stage's samples (and O
    on the direct path), then v^T SExp v for a random v is timed with CUDA
    events, beside the plain-mode kernel at the path's (chunk) batch."""
    cfg = preset(args["preset"], device="cuda", **args["over"])
    state, tdvp = driver.build_problem(cfg)[:2]
    theta = state.get_parameters()
    tdvp.rhs(theta, 0.0, 11)
    v = torch.randn(tdvp.n_params, device=state.device,
                    generator=torch.Generator(
                        device=state.device).manual_seed(12))
    ms = _time_ms(lambda: tdvp.sexp_norm(v), 5 * reps)
    x = tdvp._sexp_ctx[1]
    c = tdvp.cfg.chunk_size or x.shape[0]
    ps_ms = _time_ms(lambda: persample.per_sample_cuda(
        state.flow, state.theta, x[:c], tdvp._hess_dirs), reps)
    return ms, ps_ms


def phase_steppers():
    """G: fokkerPlanck32 at N=16384 (cholesky, so the adaptive S metric is
    the matrix-free one on the kept O) with every stepper but the fixed
    Heun of phase 5, 3 steps each: exactly stages x attempts plain-mode
    launches, each step's attempts, dt, error and residual; adaptive Heun
    once more at a tolerance that rejects the first attempt; the
    matrix-free pass timed beside one per-sample launch."""
    out = {}
    for name in ("fixed_euler", "fixed_rk3", "adaptive_heun",
                 "adaptive_rk23"):
        label = f"fokkerPlanck32 N=16384 {name}"
        t0 = time.perf_counter()
        _, arrays, counts = _drive(["fokkerPlanck32", "--stepper", name],
                                   label, 3)
        wall = time.perf_counter() - t0
        att = _step_table(label, arrays)
        want = STAGES[name] * sum(att)
        if counts["persample"] != want:
            fail(f"{label}: {counts['persample']} per-sample launches, "
                 f"expected {STAGES[name]} x {sum(att)} attempts")
        if name.startswith("adaptive") and not np.isfinite(
                arrays["step_error"]).all():
            fail(f"{label}: non-finite step error")
        out[name] = dict(launches=counts["persample"], attempts=att,
                         rhs_per_step=[STAGES[name] * a for a in att],
                         dt=arrays["dt"].tolist(),
                         step_error=arrays.get("step_error",
                                               np.array([])).tolist(),
                         wall_s=wall)
    # a tolerance below the ~1.1e-4 error of a first attempt at dt0 = 2e-3:
    # the first step rejects at least one attempt (the keys 5 * attempt +
    # stage, the chain state and the kept O of a discarded attempt) and
    # retries at a smaller dt
    label = "fokkerPlanck32 N=16384 adaptive_heun tol=2e-5"
    cfg = preset("fokkerPlanck32", device="cuda", stepper="adaptive_heun",
                 tol=2e-5)
    _, arrays, counts = _drive(None, label, 2, cfg=cfg)
    att = _step_table(label, arrays)
    if counts["persample"] != 5 * sum(att):
        fail(f"{label}: {counts['persample']} per-sample launches, "
             f"expected 5 x {sum(att)} attempts")
    if att[0] < 2 or not arrays["dt"][0] < cfg.dt0:
        fail(f"{label}: the first step took {att[0]} attempts and dt "
             f"{arrays['dt'][0]}; a retry at a dt below {cfg.dt0} expected")
    if not (np.isfinite(arrays["step_error"]).all()
            and (arrays["step_error"] <= cfg.tol).all()):
        fail(f"{label}: accepted errors {arrays['step_error']} above tol")
    out["adaptive_heun_retry"] = dict(
        launches=counts["persample"], attempts=att,
        dt=arrays["dt"].tolist(), step_error=arrays["step_error"].tolist())
    ms, ps_ms = _matfree_pass_ms(dict(preset="fokkerPlanck32", over=dict(
        stepper="adaptive_heun")))
    print(f"fokkerPlanck32 N=16384 matrix-free S metric (one product with "
          f"the kept O): {ms:.3f} ms, one per-sample launch {ps_ms:.3f} ms "
          f"(CUDA events)")
    out["matfree_ms"] = {"direct N=16384": ms}
    out["persample_ms"] = {"N=16384": ps_ms}
    return out


def phase_exact_t_end_and_dispatch(out):
    """G: --exact-t-end lands fokkerPlanck32 on t_end = 5e-3 (dt 2e-3,
    2e-3, then 1e-3); --steps-per-dispatch 3 against 1 on fixed_heun and
    adaptive_heun, 3 steps without verbose output (with it every step
    reads its residual and the NaN flag): theta bit for bit (else the
    largest difference is printed and the phase fails)."""
    _, arrays, _ = _drive(["fokkerPlanck32", "--t-end", "5e-3",
                           "--exact-t-end"], "fokkerPlanck32 exact_t_end",
                          3)
    end = float(arrays["times"][-1] + arrays["dt"][-1])
    print(f"fokkerPlanck32 --t-end 5e-3 --exact-t-end: {len(arrays['dt'])} "
          f"steps, dt {arrays['dt'].tolist()}, ends at {end!r}")
    if abs(end - 5e-3) > 1e-15 or (arrays["times"] >= 5e-3).any():
        fail(f"--exact-t-end ended at {end!r}, not on t_end 5e-3")
    out["exact_t_end"] = dict(dt=arrays["dt"].tolist(), end=end)
    for name in ("fixed_heun", "adaptive_heun"):
        thetas = {}
        for k in ("1", "3"):
            # no callbacks: _drive's waits for the card after every step
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, rec = driver.run(preset(
                "fokkerPlanck32", device="cuda", stepper=name,
                steps_per_dispatch=int(k), verbose=False), max_steps=3)
            torch.cuda.synchronize()
            arrays = rec.as_arrays()
            print(f"fokkerPlanck32 {name} --steps-per-dispatch {k}: 3 "
                  f"steps in {time.perf_counter() - t0:.3f} s, per-sample "
                  f"wrapper calls {_counts()['persample']} (a graph "
                  f"replay calls none), solver_res "
                  f"{arrays['solver_res'].tolist()}")
            if arrays["nan"].any() or not (arrays["solver_res"]
                                           < 1e-3).all():
                fail(f"{name} --steps-per-dispatch {k}: NaN or residual")
            thetas[k] = (state.get_parameters(), arrays)
        (t1, a1), (t3, a3) = thetas["1"], thetas["3"]
        diff = float((t1 - t3).abs().max())
        same_rows = all(np.array_equal(a1[k], a3[k]) for k in a1)
        print(f"fokkerPlanck32 {name} --steps-per-dispatch 3 vs 1: theta "
              f"bitwise equal {torch.equal(t1, t3)} (largest difference "
              f"{diff:.3e}), recorded rows equal {same_rows}")
        if not (torch.equal(t1, t3) and same_rows):
            fail(f"{name}: --steps-per-dispatch 3 is not the K=1 run "
                 f"(theta differs by up to {diff})")
        out[f"dispatch_{name}"] = dict(theta_bitwise=True)
    out["host_waits"] = _host_waits()


def _host_waits():
    """The synchronizing CUDA operations inside one fused Heun pair and one
    fused adaptive-Heun attempt of fokkerPlanck32 at N=16384, and one Heun
    pair of the chunked tri2 + int8 statistics at N=131072, as torch's sync
    debug mode reports them (the attempt's error read by the stepper is
    outside); printed with where they come from."""
    state, tdvp = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", stepper="adaptive_heun"))[:2]
    chunked = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", n_samples_tdvp=131072,
        n_samples_obs=131072, chunk_size=65536, gram_backend="tri2",
        gram_cross="int8"))[1]
    theta = state.get_parameters()
    found = {}
    for label, call in (
            ("heun_pair", lambda: tdvp.heun_pair(theta, 0.0, 2e-3, 5)),
            ("heun_attempt", lambda: tdvp.heun_attempt(theta, 0.0, 2e-3, 5)),
            ("chunked heun_pair", lambda: chunked.heun_pair(
                theta, 0.0, 2e-3, 5))):
        found[label] = waits = _sync_sites(call)
        print(f"host waits inside one fused {label}: "
              f"{len(waits)} {sorted(set(waits))}")
    return found


def _sync_sites(call):
    """The file:line of every synchronizing CUDA operation in ``call()``
    (after a warm-up call), as torch's sync debug mode reports them."""
    call()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def _sync_stacks(call):
    """(site, Python stack) of every synchronizing CUDA operation in
    ``call()`` (after a warm-up call), as torch's sync debug mode reports
    them, the stack taken when the warning is raised."""
    call()
    torch.cuda.synchronize()
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            found.append((f"{os.path.relpath(filename)}:{lineno}",
                          "".join(traceback.format_stack(limit=9)[:-1])))

    # the mode is set before the warnings are caught: setting it may warn
    # itself (torch/cuda/__init__.py), which is no host wait
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return found


def phase_sexp_batch(theta, theta_student, out):
    """G: one batch at the theta phase 5 ends on, with the dense SExp: the
    direct statistics at N=16384 through syrk (weighted with logp^2) and
    the chunked ones at N=131072 in chunks of 65536 through tri2 + int8
    (the SExp moments from the split pair), each within 1e-4 of the f32
    Gram's on the same draws; the matrix-free v^T SExp v on the direct f32
    path against the dense one, within 1e-4 relative. Then the syrk SExp
    once more on the Student-t + global-affine flow at the theta phase 16
    ends on, where logp^2 is largest on the heavy tails."""
    res = {}
    student = dict(latent_name="Student_t", global_affine=True)
    for n, c, backends, theta, flow_over in (
            (16384, 0, ("syrk", "auto"), theta, {}),
            (131072, 65536, ("tri2", "auto"), theta, {}),
            (16384, 0, ("syrk", "auto"), theta_student, student)):
        sts = {}
        for backend in backends:
            over = dict(gram_cross="int8") if backend == "tri2" else {}
            cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                         n_samples_obs=n, chunk_size=c, gram_backend=backend,
                         **over, **flow_over)
            state, tdvp = driver.build_problem(cfg)[:2]
            tdvp = TDVP(state, tdvp.equation, dataclasses.replace(
                tdvp.cfg, compute_sexp=True, sexp_mode="matfree"),
                n_samples=n, n_samples_obs=n)
            theta_c = theta.to(device=state.device, dtype=torch.float32)
            params = state.flow.layout.unravel(theta_c)
            gen = torch.Generator(device=state.device).manual_seed(9)
            x, _ = state.flow.push(params, state.flow.latent_sample(
                gen, params, n, torch.float32))
            _zero_counts()
            fn = tdvp._chunked_stats if c else tdvp._direct_stats
            st = fn(theta_c, 0.0, x)
            torch.cuda.synchronize()
            sts[backend] = (st, _counts())
            if backend == "auto" and not c and not flow_over:
                v = torch.randn(tdvp.n_params, device=state.device,
                                generator=torch.Generator(
                                    device=state.device).manual_seed(10))
                quad = float(tdvp._sexp_quad(theta_c, x, st["logp"], None,
                                             st["O"], v))
                vd = v.double()
                dense = float(vd @ (st["SExp"].double() @ vd))
                rel = abs(quad - dense) / abs(dense)
                print(f"matrix-free v^T SExp v {quad:.9e} vs dense "
                      f"{dense:.9e} at N={n}: relative {rel:.3e} (tol 1e-4)")
                if not rel <= 1e-4:
                    fail(f"matrix-free S metric off the dense one by {rel}")
                res["matfree_vs_dense"] = rel
            del x
        full = sts["auto"][0]["SExp"]
        name = ("chunked tri2+int8" if c else
                "syrk Student-t + global affine" if flow_over else "syrk")
        got, counts = sts[backends[0]]
        rel = _rel(got["SExp"], full, full.abs().max())
        print(f"{name} SExp vs f32 Gram at N={n}: max abs diff / max "
              f"{rel:.3e} (tol 1e-4); launches {counts}")
        if not rel <= 1e-4:
            fail(f"{name} SExp differs from the f32 Gram's: {rel}")
        want = ({"syrk": 3} if not c else
                {"persample_split": n // c, "quant8": 2 * (n // c)})
        if any(counts[k] != v for k, v in want.items()):
            fail(f"{name} SExp batch launches {counts}, expected {want}")
        res[f"{name}_vs_f32"] = rel
        if not c and not flow_over:
            out.setdefault("launches", {})["syrk"] = counts["syrk"]
        del sts
    out["sexp_batch"] = res


def phase_steppers_production(out):
    """G: one adaptive_heun step at the production point (N=524288 in
    chunks of 65536, tri2 + int8; cholesky, so the matrix-free S metric
    re-makes O chunk by chunk with the plain-mode kernel): per attempt 5 x
    8 split and 5 x 16 quant8 launches, 5 pilots and 8 plain-mode launches
    for the metric; the matrix-free pass timed there."""
    n, c = 524288, 65536
    args = ["fokkerPlanck32", "--samples", str(n), "--chunk-size", str(c),
            "--gram-backend", "tri2", "--gram-cross", "int8", "--stepper",
            "adaptive_heun"]
    label = f"fokkerPlanck32 N={n} chunked tri2+int8 adaptive_heun"
    t0 = time.perf_counter()
    _, arrays, counts = _drive(args, label, 1)
    wall = time.perf_counter() - t0
    att = sum(_step_table(label, arrays))
    chunks = n // c
    want = {"persample_split": 5 * chunks * att,
            "quant8": 10 * chunks * att, "persample": (5 + chunks) * att}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")
    ms, ps_ms = _matfree_pass_ms(dict(preset="fokkerPlanck32", over=dict(
        n_samples_tdvp=n, n_samples_obs=n, chunk_size=c, gram_backend="tri2",
        gram_cross="int8", stepper="adaptive_heun")), reps=3)
    print(f"{label}: matrix-free S metric ({chunks} plain-mode launches of "
          f"{c} and their products) {ms:.3f} ms, one per-sample launch at "
          f"{c} {ps_ms:.3f} ms (CUDA events)")
    out["production_adaptive_heun"] = dict(
        attempts=att, launches={k: counts[k] for k in want}, wall_s=wall)
    out["matfree_ms"][f"chunked N={n}"] = ms
    out["persample_ms"][f"N={c}"] = ps_ms
    return counts


def phase_fluidpaper_adaptive(out):
    """G: fluidpaper with adaptive_heun (eigh: the dense SExp; the torch
    chain in every stage) for 3 steps: the recorded proposals are the
    budget x 5 stages x attempts, acceptance in (0.05, 0.95)."""
    _, arrays, _ = _drive(["fluidpaper", "--stepper", "adaptive_heun"],
                          "fluidpaper adaptive_heun", 3, dim=2)
    att = np.asarray(_step_table("fluidpaper adaptive_heun", arrays))
    n = driver.build_problem(preset("fluidpaper",
                                    device="cuda"))[1].n_samples
    rate = _acceptance(arrays)
    print(f"fluidpaper adaptive_heun: acceptance {rate:.4f}, proposals per "
          f"step {arrays['mcmc_proposed'].tolist()} for attempts "
          f"{att.tolist()}")
    if not (np.array_equal(arrays["mcmc_proposed"], 5 * n * att)
            and 0.05 < rate < 0.95):
        fail("fluidpaper adaptive_heun: acceptance counts off")
    out["fluidpaper_adaptive_heun"] = dict(attempts=att.tolist(),
                                           acceptance=rate)


# --------------------------------------------------------------------------
# H: the solvers and Gram precisions (phases 26-30)
# --------------------------------------------------------------------------


def _batch(state, theta, n, seed):
    """(theta_c, x): f32 theta on the card and n pushed draws of a fixed
    generator seed."""
    theta_c = theta.to(device=state.device, dtype=torch.float32)
    params = state.flow.layout.unravel(theta_c)
    gen = torch.Generator(device=state.device).manual_seed(seed)
    return theta_c, state.flow.push(params, state.flow.latent_sample(
        gen, params, n, torch.float32))[0]


def _cos_rel(u, ref):
    u, ref = u.double(), ref.double()
    return (float(u @ ref / (u.norm() * ref.norm())),
            float((u - ref).norm() / ref.norm()))


def phase_cg(theta5):
    """H1 (phase 26): --solver cg at fokkerPlanck32's N=16384, direct: 3
    fixed-Heun steps through the CLI (2 plain-mode launches per step,
    lambda_max recorded and no spectrum); one RHS at the theta phase 5
    ends on against the Cholesky solve on the same draws at the JAX
    test's setting (svd_tol 1e-5, 600 iterations, cg_tol 1e-10;
    tests/test_tdvp.py:215-239): cosine > 0.999, residual below 1e-3,
    lambda_max within 3e-2; the update, 2e-2, is held on one batch's O
    rows against an f64 solve of the same Tikhonov system (S and F formed
    in f64, cg's lambda_max). The f32 Cholesky solve is not the
    reference there: at a condition of ~1e5 f32 rounding moves its
    solution by ~2e-2, while CG reads O and never forms S (an H100 80GB
    HBM3 at 700 W); its gap is printed beside. Then the CG solve timed with
    CUDA events at the CLI defaults, its iterations and the host
    waits of one RHS; one adaptive-Heun step with the matrix-free S
    metric (5 launches per attempt)."""
    n_steps = 3
    label = "fokkerPlanck32 N=16384 cg"
    _, arrays, counts = _drive(["fokkerPlanck32", "--solver", "cg"], label,
                               n_steps)
    if counts["persample"] != 2 * n_steps:
        fail(f"{label}: {counts['persample']} plain-mode launches, "
             f"expected {2 * n_steps}")
    if "ev" in arrays or "ev_topk" in arrays:
        fail(f"{label} recorded a spectrum")
    print(f"{label}: lambda_max per step {arrays['lambda_max'].tolist()}")
    out = dict(launches=counts["persample"])
    rhs = {}
    for method, extra in (("cholesky", {}), ("cg", dict(cg_maxiter=600,
                                                        cg_tol=1e-10))):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", solver_method=method,
            svd_tol=1e-5, **extra))[:2]
        theta_c = theta5.to(device=state.device, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = tdvp._rhs_impl(theta_c, 0.0, 21)
        torch.cuda.synchronize()
        rhs[method] = aux
        print(f"one {method} RHS at svd_tol 1e-5 (phase 5's theta): "
              f"{time.perf_counter() - t0:.3f} s, solver_res "
              f"{float(aux['solver_res']):.3e}, lambda_max "
              f"{float(aux['lambda_max']):.6e}" + (
                  f", {int(aux['_cg_iters'])} iterations"
                  if method == "cg" else ""))
    cos, rel = _cos_rel(rhs["cg"]["update"], rhs["cholesky"]["update"])
    lam = abs(float(rhs["cg"]["lambda_max"])
              / float(rhs["cholesky"]["lambda_max"]) - 1.0)
    res = float(rhs["cg"]["solver_res"])
    print(f"cg vs cholesky on the same draws: cosine {cos:.6f} (gate "
          f"0.999), lambda_max relative {lam:.3e} (3e-2), residual "
          f"{res:.3e} (1e-3), update relative {rel:.3e}")
    out.update(vs_cholesky=dict(cosine=cos, update_rel=rel, residual=res,
                                lambda_max_rel=lam))
    # one batch's O rows: CG and the f32 Cholesky solve against an f64
    # solve of the same Tikhonov system (S and F formed in f64 from the
    # same rows, cg's lambda_max), at the JAX test's setting and at the
    # CLI defaults
    state, tdvp = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", solver_method="cg"))[:2]
    theta_c, x = _batch(state, theta5, tdvp.n_samples, 22)
    _, eloc, O = tdvp._per_sample_batch(theta_c, x, 0.0)
    O_c, e_c = O - O.mean(0), eloc - eloc.mean()
    del O
    n = O_c.shape[0]
    O64 = O_c.double()
    S64, F64 = O64.T @ O64 / n, e_c.double() @ O64 / n
    del O64
    S32, F32 = O_c.T @ O_c / n, e_c @ O_c / n
    acc = {}
    for setting, cfg in (
            ("svd_tol 1e-5, 600 iterations", dataclasses.replace(
                tdvp.cfg, svd_tol=1e-5, cg_maxiter=600, cg_tol=1e-10)),
            ("the CLI defaults", tdvp.cfg)):
        u, _, lam_max, _, iters = tdvp_mod._solve_cg(O_c, e_c, cfg, "high")
        u_ref = tdvp_mod._solve_cholesky(S64, F64, cfg, lam_max=lam_max)[0]
        u_chol = tdvp_mod._solve_cholesky(S32, F32, cfg, lam_max=lam_max)[0]
        acc[setting] = err = {
            k: float((v.double() - u_ref).norm() / u_ref.norm())
            for k, v in (("cg", u), ("cholesky_f32", u_chol))}
        print(f"{label}, {setting} (svd_tol {cfg.svd_tol:.3e}): against an "
              f"f64 solve of the same Tikhonov system, cg after "
              f"{int(iters)} iterations {err['cg']:.3e} (2e-2 at 1e-5), the "
              f"f32 Cholesky solve {err['cholesky_f32']:.3e}")
    del S64, S32
    out["vs_f64_solve"] = acc
    if not (cos > 0.999 and res < 1e-3 and lam < 3e-2
            and acc["svd_tol 1e-5, 600 iterations"]["cg"] < 2e-2):
        fail("cg disagrees with the Cholesky solve")
    # the CG solve alone at the CLI defaults
    iters = int(tdvp_mod._solve_cg(O_c, e_c, tdvp.cfg, "high")[4])
    ms = _time_ms(lambda: tdvp_mod._solve_cg(O_c, e_c, tdvp.cfg, "high"),
                  3)
    del O_c
    waits = _sync_sites(lambda: tdvp._rhs_impl(theta_c, 0.0, 23))
    print(f"{label}: the CG solve {ms:.3f} ms for {iters} iterations "
          f"(cg_maxiter {tdvp.cfg.cg_maxiter}, cg_tol {tdvp.cfg.cg_tol}, "
          f"CUDA events), {ms / max(iters, 1):.4f} ms per iteration; host "
          f"waits in one RHS: {len(waits)} {sorted(set(waits))}")
    if len(waits) > -(-tdvp.cfg.cg_maxiter // tdvp_mod.CG_CHECK_EVERY) + 2:
        fail(f"{label}: {len(waits)} host waits in one RHS")
    out.update(solve_ms=ms, iterations=iters, host_waits_per_rhs=len(waits))
    label = "fokkerPlanck32 N=16384 cg adaptive_heun"
    _, arrays, counts = _drive(["fokkerPlanck32", "--solver", "cg",
                                "--stepper", "adaptive_heun"], label, 1)
    att = sum(_step_table(label, arrays))
    if counts["persample"] != 5 * att:
        fail(f"{label}: {counts['persample']} launches for {att} attempts")
    out["adaptive_heun"] = dict(attempts=att, launches=counts["persample"])
    return out


MINSR_FLOWS = {
    # the preset's flow at N=2048 < P=9264
    "fokkerPlanck32 N=2048": dict(n_samples_tdvp=2048, n_samples_obs=2048),
    # scripts/bench_minsr.py's default: d=32, depth 8, hidden (32,),
    # diffusion, N=1024; P=34,864 is above auto's kernel range (32768)
    "bench_minsr d=32 depth 8 N=1024": dict(
        depth=8, hidden=(32,), equation="diffusion", equation_params={},
        n_samples_tdvp=1024, n_samples_obs=1024, per_sample_backend="cuda"),
}


def _minsr_explicit(cfg, tdvp, theta, label):
    """One batch's direct minSR against explicit P-space forms on the same
    O rows: the residual ||S u - F|| / ||F|| by f64 matvecs with O (gate:
    within a factor 1.5 of the kernel-space one), and the leading
    eigenvalues of S = O_c^T O_c / N by the Cholesky path's randomized
    top-k Ritz routine run to 16 subspace iterations (the top 8 within
    1e-2 of the largest; at the path's own 2 iterations the Ritz values
    fall ~3-4% short of S's, printed beside); the N x N
    eigh, the RHS and, for comparison, a Cholesky RHS (``cfg`` with
    solver_method cholesky) timed."""
    n = tdvp.n_samples
    theta_c, x = _batch(tdvp.state, theta, n, 31)
    _, eloc, O = tdvp._per_sample_batch(theta_c, x, 0.0)
    O_c, e_c = O - O.mean(0), eloc - eloc.mean()
    del O
    sdt = tdvp.precision.solve
    u, ev, _, res, _ = tdvp_mod._solve_minsr(O_c, e_c, tdvp.cfg, "high", sdt)
    O64 = O_c.double()
    F = e_c.double() @ O64 / n
    Su = (O64 @ u.double()) @ O64 / n
    res_p = float((Su - F).norm() / F.norm())
    del O64
    S = O_c.T @ O_c / n
    top = {}
    for n_iter in (2, 16):
        ritz, _ = tdvp_mod._randomized_topk_eigh(
            S, 64, torch.Generator(device=S.device).manual_seed(5),
            n_iter=n_iter)
        top[n_iter] = float((ev[-8:].double() - ritz[-8:].double()).abs()
                            .max() / ritz[-1].double())
    del S
    T = O_c @ O_c.T
    eigh_ms = _time_ms(lambda: torch.linalg.eigh(T.to(sdt)), 3)
    rhs_ms = _time_ms(lambda: tdvp._rhs_impl(theta_c, 0.0, 32), 3)
    del T
    chol = driver.build_problem(dataclasses.replace(
        cfg, solver_method="cholesky"))[1]
    chol_ms = _time_ms(lambda: chol._rhs_impl(theta_c, 0.0, 32), 2)
    del chol
    print(f"{label} minsr: residual kernel-space {float(res):.4e} vs "
          f"P-space {res_p:.4e}; top-8 ev vs the Ritz values of S "
          f"{top[16]:.3e} of the largest at 16 subspace iterations "
          f"(1e-2), {top[2]:.3e} at the Cholesky path's 2; ev[-3:] "
          f"{ev[-3:].tolist()}; N x N eigh {eigh_ms:.3f} ms, RHS "
          f"{rhs_ms:.3f} ms, a Cholesky RHS {chol_ms:.3f} ms (CUDA events)")
    ratio = float(res) / res_p
    if not (top[16] < 1e-2 and 1 / 1.5 < ratio < 1.5):
        fail(f"{label}: minsr diagnostics off the explicit ones "
             f"(ev {top}, residual ratio {ratio})")
    return dict(residual=float(res), residual_pspace=res_p,
                top8_ev=top[16], top8_ev_ritz2=top[2],
                eigh_ms=eigh_ms, rhs_ms=rhs_ms, cholesky_rhs_ms=chol_ms)


def phase_minsr():
    """H2 and H3 (phases 27-28): minSR in its regime, P > N, on two flows
    (MINSR_FLOWS). H2: 3 fixed-Heun steps each with exactly 1 plain-mode
    launch per RHS, and one batch's kernel-space diagnostics against
    explicit P-space ones (_minsr_explicit). H3: the streaming solve at
    chunk_size N/4, 3 steps with exactly 4 * 7 / 2 + 4 = 18 launches per
    RHS, and one RHS against the direct one on the same draws: the
    spectrum within 1e-4 of its largest value, the residuals within a
    factor 2, the update within 1e-3. The JAX package bounds the update at
    2e-4 in f64, where the regularized kernel inverse amplifies T's last
    bits by up to ~1/svd_tol on threshold modes; in f32 that could reach
    eps_f32 / svd_tol = 8e-3, but the chunked T's blocks are the direct
    T's dot products to a few ulp and the measured gap is 3e-6 to 9e-6
    (an H100 80GB HBM3 at 700 W): 1e-3 keeps a hundredfold margin and still
    catches a wrong block."""
    out = {}
    for name, over in MINSR_FLOWS.items():
        n = over["n_samples_tdvp"]
        res = {}
        for chunk in (0, n // 4):
            cfg = preset("fokkerPlanck32", device="cuda",
                         solver_method="minsr", chunk_size=chunk, **over)
            label = f"{name} minsr" + (f" chunk {chunk}" if chunk else "")
            state, arrays, counts = _drive(None, label, 3, cfg=cfg)
            per_rhs = 18 if chunk else 1
            if counts["persample"] != 2 * 3 * per_rhs:
                fail(f"{label}: {counts['persample']} launches, expected "
                     f"{per_rhs} per RHS")
            if arrays["ev"].shape != (3, n):
                fail(f"{label}: ev of shape {arrays['ev'].shape}")
            tdvp = driver.build_problem(cfg)[1]
            if not chunk:
                res["explicit"] = _minsr_explicit(
                    cfg, tdvp, state.get_parameters(), name)
                theta = state.get_parameters()
            theta_c = theta.to(device=state.device, dtype=torch.float32)
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            aux = tdvp._rhs_impl(theta_c, 0.0, 33)
            torch.cuda.synchronize()
            res[chunk] = dict(aux=aux, s=time.perf_counter() - t0,
                              launches=_counts()["persample"])
        d, c = res[0]["aux"], res[n // 4]["aux"]
        ev = float((c["ev"] - d["ev"]).abs().max() / d["ev"][-1].abs())
        r_d, r_c = float(d["solver_res"]), float(c["solver_res"])
        cos, rel = _cos_rel(c["update"], d["update"])
        print(f"{name} streaming (chunk {n // 4}, {res[n // 4]['launches']} "
              f"launches, {res[n // 4]['s']:.3f} s) vs direct "
              f"({res[0]['s']:.3f} s) on the same draws: spectrum "
              f"{ev:.3e} of the largest (1e-4), residual {r_c:.4e} vs "
              f"{r_d:.4e}, update relative {rel:.3e} (1e-3), cosine "
              f"{cos:.6f}, tdvp_error {float(c['tdvp_error']):.6e} vs "
              f"{float(d['tdvp_error']):.6e}")
        if not (ev < 1e-4 and 0.5 < r_c / r_d < 2.0 and rel < 1e-3):
            fail(f"{name}: streaming minsr off the direct solve")
        out[name] = dict(res["explicit"], streaming=dict(
            spectrum=ev, residual=r_c, residual_direct=r_d, update_rel=rel,
            cosine=cos, s=res[n // 4]["s"], direct_s=res[0]["s"],
            launches_per_rhs=res[n // 4]["launches"]))
    return out


def phase_precisions_direct(theta5):
    """H4a (phase 29): the direct statistics at N=16384 on the theta phase
    5 ends on, under --precision tpu_f64stats: gram_precision f64 (the
    plain-mode kernel, f64 products) and default (one bf16 pass) against
    high (the f32 product) on the same draws: S0 and F0 of f64 within
    1e-4 of f32's largest entry, default's gap printed (bf16's ~1e-3
    class expected, gate 1e-2 and above 1e-6, which shows the bf16 pass
    ran); the f64 Cholesky solve's residual against S and against the
    Tikhonov system S + lam I it solves."""
    sts, out = {}, {}
    for mode in ("high", "f64", "default"):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", precision="tpu_f64stats",
            gram_precision=mode))[:2]
        theta_c, x = _batch(state, theta5, tdvp.n_samples, 41)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdvp._direct_stats(theta_c, 0.0, x)
        torch.cuda.synchronize()
        print(f"direct statistics N={tdvp.n_samples} gram_precision {mode}: "
              f"{time.perf_counter() - t0:.3f} s, S0 {st['S0'].dtype}")
        sts[mode] = (st, tdvp)
    ref = sts["high"][0]
    for mode in ("f64", "default"):
        st = sts[mode][0]
        gaps = {k: _rel(st[k], ref[k], ref[k].abs().max())
                for k in ("S0", "F0")}
        print(f"gram_precision {mode} vs high: S0 {gaps['S0']:.3e}, F0 "
              f"{gaps['F0']:.3e} of the largest entry")
        out[f"{mode}_vs_high"] = gaps
    if not max(out["f64_vs_high"].values()) < 1e-4:
        fail("f64 statistics off the f32 ones")
    if not 1e-6 < max(out["default_vs_high"].values()) < 1e-2:
        fail("the default statistics are not one bf16 pass")
    st, tdvp = sts["f64"]
    aux = tdvp._solve_device(st["S0"], st["S0"], st["F0"], st,
                             tdvp.n_samples, 42)
    S, F, u = st["S0"], st["F0"], aux["update"]
    lam = tdvp.cfg.svd_tol * float(aux["lambda_max"])
    tik = float((S @ u + lam * u - F).norm() / F.norm())
    res = float(aux["solver_res"])
    print(f"f64 statistics + f64 Cholesky (svd_tol {tdvp.cfg.svd_tol:.1e}):"
          f" residual against S {res:.3e}, against S + lam I {tik:.3e}")
    if not (res < 1e-3 and math.isfinite(tik)):
        fail("the f64 solve's residual")
    out.update(residual=res, residual_tikhonov=tik)
    return out


def _f64acc_ordering(chunk=64, n=8192, seed=3):
    """The JAX package's f64acc ordering test on the card, on its problem
    (tests/test_tdvp.py:1410-1460: the near-initial d=4 flow of depth 4,
    output weights 1e-5, diffusion, f32 compute) at n = 8192 in chunks of
    ``chunk``, every mode contracting the same O rows (made once, as in
    tests/test_torch_solvers.py): (max |S0 - S0_f64| under f64acc, under
    high, max |S0_f64|)."""
    from vmc_pde_torch.models.state import VarState
    from vmc_pde_torch.sampling.sampler import Sampler
    from vmc_pde_torch.solver.tdvp import TDVPConfig
    from vmc_pde_torch.utils.dtypes import Precision

    dev = torch.device("cuda")
    flow, theta = build_flow(1, 4, depth=4, out_scale=1e-5,
                             dtype=torch.float32, device=dev)
    prec = Precision.tpu_default()
    S, rows = {}, None
    for mode in ("f64acc", "high", "f64"):
        state = VarState(flow, theta, sampler=Sampler(4, dtype=torch.float32),
                         precision=prec)
        t = TDVP(state, make_equation("diffusion", 4),
                 TDVPConfig(gram_precision=mode, chunk_size=chunk),
                 n_samples=n, precision=prec)
        if rows is None:
            params = flow.layout.unravel(theta)
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = flow.push(params, flow.latent_sample(gen, params, n,
                                                     torch.float32))[0]
            rows = t._per_sample_batch(theta, x, 0.0)

        def per_sample(theta_c, xc, t_):
            i = ((xc.data_ptr() - x.data_ptr())
                 // (x.stride(0) * x.element_size()))
            return tuple(v[i:i + xc.shape[0]] for v in rows)

        t._per_sample_batch = per_sample
        S[mode] = t._chunked_stats(theta, 0.0, x)["S0"].double()
    ref = S.pop("f64")
    return (float((S["f64acc"] - ref).abs().max()),
            float((S["high"] - ref).abs().max()), float(ref.abs().max()))


# phase 29's gates at the production point, set from 10 (theta, batch)
# draws on an H100 80GB HBM3 at 700 W: f64acc / high 0.999935-1.000065 in
# the Frobenius distance to chunked f64, f64acc's distance
# 9.970e-6-1.0094e-5
F64ACC_OVER_HIGH = 1.001
F64ACC_FRO = 1.2e-5


def phase_f64acc_production(theta5):
    """H4b (phase 29): f64acc at the production point (N=524288 in chunks
    of 65536, tri2 + int8) for 3 fixed-Heun steps: exactly 16 split, 32
    quant8 and 2 pilot launches per step; then on one batch the statistics
    under f64acc, under high (the same split chunks, f32 sums) and under
    chunked f64 (the plain-mode kernel and f64 products), their distances
    to f64 (Frobenius and largest entry). At the production point the
    split's own error (1e-5 class) dwarfs the f32 sums' (7e-8), and the
    two are not independent: f64acc nearer f64 than high held for 5 of 10
    (theta, batch) pairs on an H100, so the gate there is set from
    those draws: f64acc's Frobenius distance at most F64ACC_OVER_HIGH
    times high's (measured up to 1.000065) and below F64ACC_FRO (measured
    9.970e-6 to 1.0094e-5). The ordering itself is gated on the JAX test's
    own problem (tests/test_tdvp.py:1410-1460) on the card, in chunks of
    64 (_f64acc_ordering): f64acc at least 4x closer to f64 than high in
    the largest entry, and within 1e-6 of the largest value (10-15x over
    5 draws)."""
    n, c = 524288, 65536
    label = f"fokkerPlanck32 N={n} chunked tri2+int8 f64acc"
    args = ["fokkerPlanck32", "--samples", str(n), "--chunk-size", str(c),
            "--gram-backend", "tri2", "--gram-cross", "int8",
            "--gram-precision", "f64acc"]
    _, _, counts = _drive(args, label, 3)
    want = {"persample_split": 3 * 16, "quant8": 3 * 32, "persample": 3 * 2}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")
    S, times = {}, {}
    for mode, over in (("f64acc", dict(gram_backend="tri2",
                                       gram_cross="int8")),
                       ("high", dict(gram_backend="tri2", gram_cross="int8")),
                       ("f64", {})):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", n_samples_tdvp=n,
            n_samples_obs=n, chunk_size=c, gram_precision=mode, **over))[:2]
        theta_c, x = _batch(state, theta5, n, 43)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S[mode] = tdvp._chunked_stats(theta_c, 0.0, x)["S0"].double()
        torch.cuda.synchronize()
        times[mode] = time.perf_counter() - t0
        del x
    ref = S.pop("f64")
    fro = {m: float((v - ref).norm() / ref.norm()) for m, v in S.items()}
    mx = {m: _rel(v, ref, ref.abs().max()) for m, v in S.items()}
    acc_only = float((S["high"] - S["f64acc"]).norm() / ref.norm())
    print(f"{label}: statistics of one batch in {times} s; against chunked "
          f"f64, Frobenius f64acc {fro['f64acc']:.4e}, high "
          f"{fro['high']:.4e} (ratio {fro['f64acc'] / fro['high']:.6f}; "
          f"gates {F64ACC_OVER_HIGH} and {F64ACC_FRO:.1e}), largest entry "
          f"f64acc {mx['f64acc']:.4e}, high {mx['high']:.4e}; the f32 sums "
          f"alone (high - f64acc) {acc_only:.4e}")
    if not (fro["f64acc"] <= F64ACC_OVER_HIGH * fro["high"]
            and fro["f64acc"] < F64ACC_FRO):
        fail(f"{label}: f64acc's distance to chunked f64 {fro['f64acc']:.4e}"
             f" against high's {fro['high']:.4e}")
    err_acc, err_hi, scale = _f64acc_ordering(64)
    print(f"f64acc ordering on the JAX test's problem (n=8192, chunks of "
          f"64): max |S0 - S0_f64| f64acc {err_acc:.4e}, high {err_hi:.4e} "
          f"({err_hi / err_acc:.1f}x; gate 4x), of a largest value "
          f"{scale:.4e} (gate 1e-6: {err_acc / scale:.2e})")
    if not (err_acc < err_hi / 4 and err_acc < 1e-6 * scale):
        fail("f64acc is not 4x closer to the f64 statistics than high")
    return dict(launches=counts, stats_s=times, frobenius=fro, max_abs=mx,
                f32_sums_only=acc_only,
                jax_test_ordering=dict(f64acc=err_acc, high=err_hi,
                                       largest=scale))


def phase_host_solve(theta5):
    """H5 (phase 30): the host f64 solve. mwe in f64 with --host-solve (the
    eigh branch) for 10 steps: residual below 1e-10; then one
    fokkerPlanck32 RHS under tpu_f64stats with the host solve (Cholesky
    branch: numpy f64, lambda_max by power iteration at P > 512) against
    the device's f64 Cholesky solve on the same draws with the same
    power-iteration lambda_max (spectrum_topk=0): within 1e-6."""
    _, arrays, _ = _drive(["mwe", "--precision", "f64", "--host-solve"],
                          "mwe f64 --host-solve", 10, dim=2)
    res = float(arrays["solver_res"].max())
    if not res < 1e-10:
        fail(f"mwe --host-solve residual {res}")
    out = dict(mwe_residual=res)
    aux = {}
    for on_device in (False, True):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", precision="tpu_f64stats",
            solve_on_device=on_device))[:2]
        if on_device:
            # the power-iteration lambda_max of the host solve, not the
            # top-k Ritz one
            tdvp = TDVP(state, tdvp.equation, dataclasses.replace(
                tdvp.cfg, spectrum_topk=0), n_samples=tdvp.n_samples)
        theta_c = theta5.to(device=state.device, dtype=torch.float32)
        a = tdvp._rhs_impl(theta_c, 0.0, 51)
        if not on_device:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.update(tdvp._host_solve(a))
            out["host_solve_s"] = time.perf_counter() - t0
        aux[on_device] = a
    cos, rel = _cos_rel(aux[False]["update"], aux[True]["update"])
    lam = abs(float(aux[False]["lambda_max"])
              / float(aux[True]["lambda_max"]) - 1.0)
    print(f"fokkerPlanck32 host solve (numpy f64, P={tdvp.n_params}): "
          f"{out['host_solve_s']:.3f} s; against the device f64 solve: "
          f"update relative {rel:.3e} (1e-6), lambda_max {lam:.3e}, "
          f"residual {float(aux[False]['solver_res']):.4e} vs "
          f"{float(aux[True]['solver_res']):.4e}")
    if not rel < 1e-6:
        fail("the host solve differs from the device solve")
    out.update(update_rel=rel, lambda_max_rel=lam)
    return out


def phase_solvers(theta5):
    """H1-H5 (phases 26-30); returns their records and the kernels'
    launches by path."""
    out = {"cg": phase_cg(theta5), "minsr": phase_minsr(),
           "precisions_direct": phase_precisions_direct(theta5),
           "f64acc_production": phase_f64acc_production(theta5),
           "host_solve": phase_host_solve(theta5)}
    prod = out["f64acc_production"]["launches"]
    paths = {"fokkerPlanck32 N=16384 cg": out["cg"]["launches"],
             "fokkerPlanck32 N=16384 cg adaptive_heun":
                 out["cg"]["adaptive_heun"]["launches"],
             "fokkerPlanck32 N=524288 chunked tri2+int8 f64acc (pilots)":
                 prod["persample"]}
    for name in MINSR_FLOWS:
        paths[f"{name} minsr"] = 6
        paths[f"{name} minsr streaming, 4 chunks"] = 108
    split = {"fokkerPlanck32 N=524288 chunked tri2+int8 f64acc":
             prod["persample_split"]}
    q8 = {"fokkerPlanck32 N=524288 chunked tri2+int8 f64acc":
          prod["quant8"]}
    return out, paths, split, q8


# -- phase I (31-35): randomized QMC, the Hessian block mode and the MC
# sphere integrals

QMC_N = 524288  # the production point's batch


def _chi2_bound(x, bits, nu):
    """Per-sample bound on the relative gap of two f64 chi^2 inversions of
    the same 30-bit uniforms: 1e-10 plus the inversion's conditioning,
    16 eps u / (x pdf(x)) (tests/test_torch_qmc.py), computed in f64 on the
    host, for every nu (the last Newton steps run on the port's own
    P(k, x), sampling/qmc.py)."""
    from scipy.stats import chi2 as schi2

    u = (bits.astype(np.float64) + 0.5) * 2.0**-30
    return 1e-10 + 16 * np.finfo(np.float64).eps * u / (x * schi2.pdf(x, nu))


def phase_qmc_draws():
    """I1 (phase 31): the QMC draws on the card against the CPU: the same
    words at d=33 and n=524288 (the joint Student-t net of fokkerPlanck32's
    production batch) give the same scrambled bits bit for bit;
    _mirrored_ndtri in f32 on the card within 8 f32 ulps of max(|z|, 1) of
    the CPU's f64 value; chi2_from_bits for nu in {1.05, 2.5, 50} within
    _chi2_bound of the CPU's; the Sobol generation (d=32 and 33), the
    normals and the Newton solve at N=524288 timed with CUDA events."""
    from vmc_pde_torch.sampling import qmc

    n, d = QMC_N, 33
    lms, shift = qmc.draw_words(torch.Generator().manual_seed(5), d)
    cpu = qmc.scrambled_bits_from_words(n, lms, shift)
    dev = qmc.scrambled_bits_from_words(n, lms.cuda(), shift.cuda())
    if not torch.equal(dev.cpu(), cpu):
        fail("the scrambled Sobol bits differ between the card and the CPU")
    z32 = qmc._mirrored_ndtri(dev, torch.float32).cpu().double()
    z64 = qmc._mirrored_ndtri(cpu, torch.float64)
    ulps = float(((z32 - z64).abs() / (z64.abs().clamp_min(1.0)
                                       * 2.0**-23)).max())
    print(f"QMC at d={d}, n={n}: scrambled bits on the card equal the "
          f"CPU's; f32 normals on the card within {ulps:.3f} f32 ulps of "
          f"max(|z|, 1) of the CPU's f64 (bound 8), |z| up to "
          f"{float(z64.abs().max()):.4f}")
    if not ulps <= 8.0:
        fail(f"the f32 QMC normals on the card are {ulps} ulps off")
    out = dict(bits_equal=True, ndtri_f32_ulps=ulps)
    col = cpu[:, d - 1]
    for nu in (1.05, 2.5, 50.0):
        x_dev = qmc.chi2_from_bits(col.cuda(), nu, dtype=torch.float64)
        x_cpu = qmc.chi2_from_bits(col, nu, dtype=torch.float64).numpy()
        rel = np.abs(x_dev.cpu().numpy() - x_cpu) / x_cpu
        worst = float((rel / _chi2_bound(x_cpu, col.numpy(), nu)).max())
        print(f"chi2_from_bits nu={nu}: card vs CPU, largest relative gap "
              f"{rel.max():.3e}, largest share of its bound {worst:.3f}")
        if not worst <= 1.0:
            fail(f"chi2_from_bits nu={nu} differs on the card: {rel.max()}")
        out[f"chi2_nu{nu}_max_rel"] = float(rel.max())
    gen = torch.Generator(device="cuda")
    times = {}
    for label, fn in (
            ("scrambled bits d=32", lambda: qmc.scrambled_bits(
                gen.manual_seed(1), 32, n)),
            ("scrambled bits d=33", lambda: qmc.scrambled_bits(
                gen.manual_seed(1), 33, n)),
            ("normals f32 d=32", lambda: qmc.normal(gen.manual_seed(1), n,
                                                    32)),
            ("chi2 Newton (25 + 2 polishing steps, f64)",
             lambda: qmc.chi2_from_bits(dev[:, d - 1], 2.0,
                                        dtype=torch.float32)),
            ("chi2 Newton nu=50", lambda: qmc.chi2_from_bits(
                dev[:, d - 1], 50.0, dtype=torch.float32))):
        times[label] = _time_ms(fn, 10)
    # the same draws without the polishing steps, in this call
    polish, qmc._POLISH_STEPS = qmc._POLISH_STEPS, 0
    try:
        for nu in (2.0, 50.0):
            times[f"chi2 Newton nu={nu:g} (25 steps, no polishing)"] = \
                _time_ms(lambda: qmc.chi2_from_bits(
                    dev[:, d - 1], nu, dtype=torch.float32), 10)
    finally:
        qmc._POLISH_STEPS = polish
    print(f"QMC at N={n} on the card: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()))
    out["ms"] = times
    return out


def _step_mean(label):
    steps = STEP_TIMES[label]
    return float(np.mean(steps[1:])) if len(steps) > 1 else float(steps[0])


def _f0_spread(theta5, qmc_on, n=16384, reps=8):
    """F0 at theta5 over ``reps`` randomizations of n draws: the norm of
    its per-entry standard deviation over the norm of its mean."""
    state, tdvp = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", qmc=qmc_on, n_samples_tdvp=n,
        n_samples_obs=n))[:2]
    F = []
    for s in range(reps):
        theta_c, x = _batch(state, theta5, n, 60 + s)
        F.append(tdvp._direct_stats(theta_c, 0.0, x)["F0"].double())
    F = torch.stack(F)
    return float(F.std(0).norm() / F.mean(0).norm())


def phase_qmc_paths(theta5):
    """I2 (phase 32): fokkerPlanck32 --qmc through driver.main at N=16384
    for 5 fixed-Heun steps (exactly 10 plain-mode launches) and at the
    production point (N=524288 in chunks of 65536, tri2 + int8) for 3
    steps (exactly 48 split, 96 quant8 and 6 pilot launches); no NaN,
    residual below 1e-3 (_drive), each mean step beside the pseudo-random
    run's of phases 5 and 7; then the spread of F0 over 8 randomizations
    at the theta phase 5 ends on, QMC against pseudo-random draws at
    N=16384 (printed, no gate)."""
    out = {}
    label = "fokkerPlanck32 --qmc N=16384"
    _, _, counts = _drive(["fokkerPlanck32", "--qmc"], label, 5)
    if counts["persample"] != 10 or counts["persample_split"]:
        fail(f"{label}: launches {counts}, expected 10 plain-mode")
    out["direct"] = dict(launches=counts["persample"],
                         s_per_step=_step_mean(label),
                         prng_s_per_step=_step_mean(MAIN_LABEL))
    plabel = "fokkerPlanck32 --qmc N=524288 chunked tri2+int8"
    _, _, counts = _drive(
        ["fokkerPlanck32", "--qmc", "--samples", str(QMC_N), "--chunk-size",
         "65536", "--gram-backend", "tri2", "--gram-cross", "int8"],
        plabel, 3)
    want = dict(persample_split=48, quant8=96, persample=6)
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{plabel}: launches {counts}, expected {want}")
    out["production"] = dict(launches=want, s_per_step=_step_mean(plabel),
                             prng_s_per_step=_step_mean(CHUNKED_LABEL))
    for key, lab in (("direct", label), ("production", plabel)):
        o = out[key]
        print(f"{lab}: {o['s_per_step']:.4f} s per step against "
              f"{o['prng_s_per_step']:.4f} s with pseudo-random draws "
              f"(ratio {o['s_per_step'] / o['prng_s_per_step']:.4f})")
    spread = {name: _f0_spread(theta5, on)
              for name, on in (("qmc", True), ("prng", False))}
    print(f"F0 at phase 5's theta, N=16384, 8 randomizations: relative "
          f"spread QMC {spread['qmc']:.4e}, pseudo-random "
          f"{spread['prng']:.4e} (ratio "
          f"{spread['prng'] / spread['qmc']:.3f})")
    out["f0_spread"] = spread
    return out


def phase_qmc_student(dev):
    """I3 (phase 33): the Student-t + global affine fokkerPlanck32 with
    --qmc through driver.run at N=16384 for 4 steps (exactly 8 plain-mode
    launches); then the kernel held to plain f32 on QMC draws of the
    joint (d+1)-column net at phase 15's perturbed theta (nu = 2.5) with
    phase 15's grading (GRADE_Q, GRADE_MAX), the largest |x| of the QMC
    and the pseudo-random draws printed."""
    n_steps = 4
    label = "fokkerPlanck32 Student-t + global affine --qmc N=16384"
    cfg = preset("fokkerPlanck32", latent_name="Student_t",
                 global_affine=True, qmc=True, device="cuda")
    state, _, counts = _drive(None, label, n_steps, cfg=cfg)
    if not state.flow.qmc or counts["persample"] != 2 * n_steps:
        fail(f"{label}: launches {counts}, expected {2 * n_steps}")
    flow, _, perturbed, dirs = _student_problem(dev)
    params = flow.layout.unravel(perturbed)
    reach = {}
    for name, f in (("qmc", dataclasses.replace(flow, qmc=True)),
                    ("prng", flow)):
        gen = torch.Generator(device=dev).manual_seed(12)
        x, _ = f.push(params, f.latent_sample(gen, params, 16384,
                                              torch.float32))
        reach[name] = float(x.abs().max())
        if name == "qmc":
            err = _persample_vs_plain(flow, perturbed, x, dirs,
                                      "Student-t perturbed, QMC draws",
                                      grade=True)
    print(f"Student-t perturbed theta, N=16384: largest |x| of the QMC "
          f"draws {reach['qmc']:.2f}, of the pseudo-random ones "
          f"{reach['prng']:.2f}")
    return dict(launches=counts["persample"], s_per_step=_step_mean(label),
                max_abs_err_O=err, max_abs_x=reach)


def _eloc_block_vs_trace(name, precision, theta=None, n=16384, seed=70):
    """E_loc of one batch under hessian_mode block and trace on the same
    draws (``theta``: f32 on the card, default the preset's initial one),
    and the f64 trace-mode E_loc of the plain pipeline on them."""
    out = {}
    for mode in ("block", "trace"):
        state, tdvp = driver.build_problem(preset(
            name, device="cuda", precision=precision, hessian_mode=mode,
            n_samples_tdvp=n, n_samples_obs=n))[:2]
        th = state.theta if theta is None else theta
        theta_c, x = _batch(state, th, n, seed)
        theta_c, x = theta_c.to(state.theta.dtype), x.to(state.theta.dtype)
        out[mode] = tdvp._per_sample_batch(theta_c, x, 0.1)[1]
        out[f"{mode}_tdvp"] = tdvp
    eq = out["trace_tdvp"].equation
    dirs = torch.as_tensor(eq.hessian_trace_dirs(state.flow.dim),
                           dtype=torch.float64, device=x.device)
    _, g, quad, _ = persample.per_sample_plain(state.flow, theta_c.double(),
                                               x.double(), dirs)
    out["f64"] = eq.eloc(x.double(), g, quad, 0.1)
    return out


def phase_hessian_block(theta5):
    """I4 (phase 34): fokkerPlanck32 --hessian-mode block at N=16384, the
    16 x 16 momentum block on the torch.func pipeline: 2 steps through
    the CLI with no per-sample launch (4 of the Jacobi eigensolve, one a
    RHS), no NaN, residual below 1e-3, timed;
    on one batch at the theta phase 5 ends on, the block-mode E_loc (f32,
    torch.func) and the trace-mode one (f32, the kernel) against the f64
    plain pipeline's, the block within 4 times the kernel's error or
    1e-5 of the largest value; mwe and diffusion_anisotropic in f64,
    block against trace on the same draws, within 1e-10."""
    label = "fokkerPlanck32 --hessian-mode block N=16384"
    _, _, counts = _drive(["fokkerPlanck32", "--hessian-mode", "block"],
                          label, 2)
    # no per-sample kernel; the top-k Ritz solve's Jacobi kernel, once a
    # RHS
    if any(v for k, v in counts.items() if k != "jacobi") or \
            counts["jacobi"] != 4:
        fail(f"{label} launched kernels: {counts}")
    e = _eloc_block_vs_trace("fokkerPlanck32", "tpu", theta=theta5)
    if e["block_tdvp"].uses_kernel or not e["trace_tdvp"].uses_kernel:
        fail("the block mode must run the torch.func pipeline, trace mode "
             "the kernel")
    scale = e["f64"].abs().max()
    err_b, err_t = (_rel(e[m], e["f64"], scale) for m in ("block", "trace"))
    print(f"fokkerPlanck32 N=16384 E_loc against the f64 plain pipeline: "
          f"block (f32 torch.func) {err_b:.3e}, trace (f32 kernel) "
          f"{err_t:.3e} of the largest value (bound max(4 x trace, 1e-5))")
    if not err_b <= max(4.0 * err_t, 1e-5):
        fail(f"block-mode E_loc off by {err_b}")
    out = dict(launches=0, s_per_step=_step_mean(label),
               prng_trace_s_per_step=_step_mean(MAIN_LABEL),
               eloc_err_block_f32=err_b, eloc_err_trace_kernel=err_t)
    for name in ("mwe", "diffusion_anisotropic"):
        e = _eloc_block_vs_trace(name, "f64", n=4096)
        rel = _rel(e["block"], e["trace"])
        print(f"{name} f64 N=4096: block against trace E_loc {rel:.3e} "
              f"(tol 1e-10)")
        if not rel < 1e-10:
            fail(f"{name}: block E_loc differs from trace: {rel}")
        out[f"{name}_block_vs_trace"] = rel
    print(f"{label}: {out['s_per_step']:.4f} s per step against "
          f"{out['prng_trace_s_per_step']:.4f} s in trace mode (the kernel)")
    return out


def phase_integrals():
    """I5 (phase 35): mwe in f64 with integrals=True (dt 1e-2) for 10
    steps: each of the three integrals within 5 Monte Carlo standard
    errors of 1 - exp(-r^2 / (2 sigma^2(t))), sigma^2(t) = 1 + 2t (the
    standard error from p's first two moments on a 2-D ball); then
    fokkerPlanck32 at N=16384 with integrals=True for 3 steps (exactly 6
    plain-mode launches): finite values in [0, 1 + 5 SE], SE from p's
    spread on one ball batch at the last theta, and the step time beside
    phase 5's."""
    n = 4096
    cfg = preset("mwe", device="cuda", precision="f64", n_samples_tdvp=n,
                 n_samples_obs=n, integrals=True, verbose=False, dt0=1e-2)
    _, a, _ = _drive(None, "mwe f64 integrals", 10, dim=2, cfg=cfg)
    s2 = 1.0 + 2.0 * a["times"]
    out = {}
    for label, lim in (("1", 1.0), ("0.5", 0.5), ("0.1", 0.1)):
        r2 = lim**2 * 10.0
        est = a[f"integral_{label}sigma"]
        exact = 1.0 - np.exp(-r2 / (2.0 * s2))
        m1 = exact / (math.pi * r2)
        m2 = (1.0 - np.exp(-r2 / s2)) / (4.0 * math.pi**2 * s2 * r2)
        se = math.pi * r2 * np.sqrt((m2 - m1**2) / n)
        z = float((np.abs(est - exact) / se).max())
        print(f"mwe integral_{label}sigma: last {est[-1]:.5f} vs "
              f"{exact[-1]:.5f}, largest gap {z:.2f} SE over 10 steps")
        if not z < 5.0:
            fail(f"mwe integral_{label}sigma misses its closed form")
        out[f"mwe_{label}sigma_max_se"] = z
    label = "fokkerPlanck32 integrals N=16384"
    state, a, counts = _drive(None, label, 3, cfg=preset(
        "fokkerPlanck32", device="cuda", integrals=True))
    if counts["persample"] != 6:
        fail(f"{label}: launches {counts}, expected 6 plain-mode")
    params = state.params
    gen = torch.Generator(device="cuda").manual_seed(80)
    ball = tdvp_mod.unit_ball(gen, 16384, 32, torch.float32, state.device)
    for label_i, lim in (("1", 1.0), ("0.5", 0.5), ("0.1", 0.1)):
        r = lim * math.sqrt(10.0)
        p = torch.exp(state.flow.log_prob(params, r * ball)).double()
        se = float(p.std()) * tdvp_mod._ball_volume(32, r) / math.sqrt(16384)
        v = a[f"integral_{label_i}sigma"]
        print(f"fokkerPlanck32 integral_{label_i}sigma per step "
              f"{' '.join(f'{x:.4e}' for x in v)} (SE {se:.2e})")
        if not (np.isfinite(v).all() and (v >= 0).all()
                and (v <= 1.0 + 5 * se).all()):
            fail(f"fokkerPlanck32 integral_{label_i}sigma out of range")
    out["fokkerPlanck32"] = dict(
        launches=counts["persample"], s_per_step=_step_mean(label),
        prng_s_per_step=_step_mean(MAIN_LABEL))
    print(f"{label}: {out['fokkerPlanck32']['s_per_step']:.4f} s per step "
          f"against {out['fokkerPlanck32']['prng_s_per_step']:.4f} s "
          f"without the integrals")
    return out


def phase_qmc_hessian_integrals(dev, theta5):
    """I1-I5 (phases 31-35); returns their records and the kernels'
    launches by path."""
    out = {"qmc_draws": phase_qmc_draws(),
           "qmc_paths": phase_qmc_paths(theta5),
           "qmc_student": phase_qmc_student(dev),
           "hessian_block": phase_hessian_block(theta5),
           "integrals": phase_integrals()}
    prod = "fokkerPlanck32 N=524288 chunked tri2+int8 --qmc"
    paths = {"fokkerPlanck32 --qmc": out["qmc_paths"]["direct"]["launches"],
             f"{prod} (pilots)": 6,
             "fokkerPlanck32 Student-t + global affine --qmc":
                 out["qmc_student"]["launches"],
             "fokkerPlanck32 --hessian-mode block": 0,
             "fokkerPlanck32 integrals":
                 out["integrals"]["fokkerPlanck32"]["launches"]}
    return out, paths, {prod: 48}, {prod: 96}


# -- phase J (36-40): the run state -----------------------------------------
# --seed, checkpoints and --resume, the async recorder, the profiler window,
# and the pretrain -> --init-params handoff, all on fokkerPlanck32 at the
# preset's full width (d=32, depth 4, hidden (16,), P=9264, N=16384)


class _H5Store:
    """An in-memory stand-in for h5py (a card's host may have none):
    ``File(path, "w")`` as a context manager with ``create_dataset``, and
    ``File(path, "r")`` with ``keys()`` and ``[key]``; the datasets stay
    in ``files[path]``, where the phases read them back. store_infos and
    load_infos (utils/infos.py) are its users: every driver run with a
    workdir ends in store_infos; the CPU tests hold the real HDF5 path."""

    def __init__(self):
        self.files = {}
        store = self

        class File:
            def __init__(self, path, mode="r"):
                path = os.path.abspath(path)
                if mode == "w":
                    store.files[path] = {}
                elif mode != "r":
                    raise ValueError(f"the stand-in has no mode {mode!r}")
                self.data = store.files[path]

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def create_dataset(self, key, data):
                self.data[key] = np.array(data)

            def keys(self):
                return self.data.keys()

            def __getitem__(self, key):
                return self.data[key]

        self.File = File

    def read(self, wdir, name="infos.hdf5"):
        return self.files[os.path.abspath(os.path.join(wdir, name))]


def _h5_stand_in():
    """Install the stand-in as the module h5py for the rest of the script
    (phase J's driver runs write infos.hdf5 through it)."""
    import types

    store = _H5Store()
    module = types.ModuleType("h5py")
    module.File = store.File
    sys.modules["h5py"] = module
    print("phase J: driver runs with a workdir write infos.hdf5 through an "
          "in-memory stand-in for h5py.File (the datasets are read back "
          "from it); the CPU tests hold the real HDF5 path")
    return store


# the theta after every step of a _drive run, by its label (_keep_thetas)
RUN_THETAS = {}


def _keep_thetas(label):
    RUN_THETAS[label] = thetas = []
    return lambda n, t, state, info: thetas.append(
        state.get_parameters().clone())


def phase_seed_and_aliases():
    """J1 (phase 36): ``--seed 3`` for 2 steps twice, theta bit for bit
    equal, and unequal to the default seed's; ``--per-sample-backend
    pallas`` for 1 step: exactly 2 plain-mode launches."""
    finals = {}
    for label, extra in (("seed 3", ["--seed", "3"]),
                         ("seed 3 again", ["--seed", "3"]),
                         ("default seed", [])):
        full = f"fokkerPlanck32 {label}"
        state, _, counts = _drive(["fokkerPlanck32"] + extra, full, 2)
        if counts["persample"] != 4:
            fail(f"{full}: launches {counts}, expected 4 plain-mode")
        finals[label] = state.get_parameters()
    same = torch.equal(finals["seed 3"], finals["seed 3 again"])
    apart = float((finals["seed 3"] - finals["default seed"]).abs().max())
    print(f"--seed 3 twice: theta bitwise equal {same}; against the default "
          f"seed's, largest |difference| {apart:.3e}")
    if not same or apart == 0.0:
        fail("--seed does not fix the run, or does not change it")
    _, _, counts = _drive(["fokkerPlanck32", "--per-sample-backend",
                           "pallas"], "fokkerPlanck32 pallas alias", 1)
    if counts["persample"] != 2:
        fail(f"--per-sample-backend pallas: launches {counts}, expected 2")
    return dict(seed_bitwise=same, vs_default_max_abs=apart,
                pallas_alias_launches=counts["persample"])


def phase_checkpoint_resume(h5, root):
    """J2 (phase 37): run A, 4 steps with ``--checkpoint-every 1``; run B
    in a fresh workdir holding only A's ckpt_00000002.npz as
    ckpt_latest.npz, ``--resume --checkpoint-every 1`` for 2 steps:
    B's checkpoint after step 4 (theta, t, dt) equals A's bit for bit, or,
    where the card's path is not deterministic, within 1e-6 of the
    largest |delta theta| of one of A's steps; launches exactly 8 and 4;
    one checkpoint write (74 KB, twice: the step's file and
    ckpt_latest.npz) timed, and A's step time beside phase 5's."""
    from vmc_pde_torch.utils import checkpoint

    wa, wb = os.path.join(root, "A"), os.path.join(root, "B")
    la, lb = "fokkerPlanck32 --checkpoint-every 1", \
        "fokkerPlanck32 --resume from step 2"
    _, _, ca = _drive(["fokkerPlanck32", "--workdir", wa,
                       "--checkpoint-every", "1"], la, 4,
                      callbacks=[_keep_thetas(la)])
    os.makedirs(wb)
    shutil.copy(os.path.join(wa, "ckpt_00000002.npz"),
                os.path.join(wb, "ckpt_latest.npz"))
    _, _, cb = _drive(["fokkerPlanck32", "--workdir", wb, "--resume",
                       "--checkpoint-every", "1"], lb, 2)
    if (ca["persample"], cb["persample"]) != (8, 4):
        fail(f"checkpoint/resume launches {ca['persample']} and "
             f"{cb['persample']}, expected 8 and 4")
    if sorted(h5.read(wb)) != sorted(h5.read(wa)) or \
            h5.read(wb)["times"].shape != (2,):
        fail("the resumed run's infos.hdf5 rows are not the expected ones")
    a = checkpoint.load_checkpoint(os.path.join(wa, "ckpt_00000004.npz"))
    b = checkpoint.load_checkpoint(os.path.join(wb, "ckpt_00000004.npz"))
    gap = float(np.abs(a["theta"] - b["theta"]).max())
    steps = RUN_THETAS[la]
    step_size = max(float((steps[i + 1] - steps[i]).abs().max())
                    for i in range(3))
    exact = gap == 0.0 and (a["t"], a["dt"]) == (b["t"], b["dt"])
    print(f"resume from step 2: after step 4 theta differs by {gap:.3e} "
          f"(bitwise equal: {exact}; largest |delta theta| of a step "
          f"{step_size:.3e}); t {a['t']!r} vs {b['t']!r}, dt {a['dt']!r} "
          f"vs {b['dt']!r}")
    if (a["t"], a["dt"], a["step"]) != (b["t"], b["dt"], b["step"]):
        fail("the resumed run ends at another t, dt or step")
    if not exact:
        # name what is not deterministic: the per-sample kernel twice on
        # the same draws, and the whole RHS twice on one theta
        state, tdvp = driver.build_problem(preset("fokkerPlanck32",
                                                  device="cuda"))[:2]
        theta = torch.as_tensor(a["theta"], device="cuda")
        flow, theta32 = state.flow, theta.float()
        x, _ = state.sample(16384, 5)
        dirs = torch.as_tensor(make_equation(
            "advection_hamiltonian_wDiss", 32, T=10.0,
            coupled=True).hessian_trace_dirs(32), dtype=torch.float32,
            device="cuda")
        o1 = persample.per_sample(flow, theta32, x, dirs)[3]
        o2 = persample.per_sample(flow, theta32, x, dirs)[3]
        u1, _ = tdvp.rhs(theta, 0.0, 5)
        u2, _ = tdvp.rhs(theta, 0.0, 5)
        print(f"not bitwise: the per-sample kernel twice on one batch, O "
              f"differs by {float((o1 - o2).abs().max()):.3e}; one RHS "
              f"twice on one theta, the update by "
              f"{float((u1 - u2).abs().max()):.3e}")
        if not gap <= 1e-6 * step_size:
            fail(f"resumed theta differs by {gap} (step size {step_size})")
    theta = steps[-1]
    write_ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(os.path.join(root, "timed"), i, 0.0,
                                   theta, 2e-3)
        write_ms.append(1e3 * (time.perf_counter() - t0))
    size = os.path.getsize(os.path.join(root, "timed", "ckpt_00000004.npz"))
    out = dict(bitwise=exact, max_abs_gap=gap, step_max_abs=step_size,
               launches=[ca["persample"], cb["persample"]],
               write_ms=write_ms, file_bytes=size,
               s_per_step=_step_mean(la), plain_s_per_step=_step_mean(
                   MAIN_LABEL))
    print(f"one checkpoint write ({size} B, twice): "
          f"{' '.join(f'{x:.2f}' for x in write_ms)} ms; step "
          f"{out['s_per_step']:.4f} s with --checkpoint-every 1 against "
          f"{out['plain_s_per_step']:.4f} s (phase 5)")
    return out


def phase_recorder(root):
    """J3 (phase 38): ``--async-recorder`` for 3 steps: log_to_infos of
    metrics.bin equals the run's InfoRecorder rows exactly for every
    key whose rows are numbers, and for dist_params; the step time beside
    phase 5's; the host waits of one step's record_dict (torch's sync
    debug mode)."""
    from vmc_pde_torch.utils.recorder import AsyncRecorder, log_to_infos

    wdir = os.path.join(root, "rec")
    label = "fokkerPlanck32 --async-recorder"
    last = {}
    _, rows, counts = _drive(
        ["fokkerPlanck32", "--workdir", wdir, "--async-recorder"], label, 3,
        callbacks=[lambda n, t, state, info: last.update(
            n=n, t=t, info=info,
            dist=state.params["latent"]["dist_params"])])
    if counts["persample"] != 6:
        fail(f"{label}: launches {counts}, expected 6")
    logged = log_to_infos(os.path.join(wdir, "metrics.bin"))
    keys = [k for k, v in rows.items() if v.ndim == 1
            and not k.startswith("grid_integral")] + ["dist_params"]
    for key in keys:
        want = rows[key].astype(np.float64)
        got = np.asarray(logged[key], dtype=np.float64).reshape(want.shape)
        if not np.array_equal(got, want):
            fail(f"metrics.bin's {key} differs from the run's rows")
    probe = AsyncRecorder(os.path.join(root, "probe.bin"))
    record = {"times": last["t"], "dt": 2e-3, **{
        k: v for k, v in last["info"].items() if k not in ("update", "SExp")},
        "dist_params": last["dist"]}
    stacks = _sync_stacks(lambda: probe.record_dict(last["n"], record))
    probe.close()
    waits = [site for site, _ in stacks]
    for site, stack in stacks:
        print(f"a synchronizing call in record_dict at {site}:\n{stack}")
    out = dict(keys_exact=sorted(keys), s_per_step=_step_mean(label),
               plain_s_per_step=_step_mean(MAIN_LABEL),
               host_waits_per_step=len(waits), wait_sites=sorted(set(waits)))
    print(f"metrics.bin equals the run's rows for {len(keys)} keys; step "
          f"{out['s_per_step']:.4f} s with the recorder against "
          f"{out['plain_s_per_step']:.4f} s (phase 5); host waits in one "
          f"step's record_dict: {len(waits)} {sorted(set(waits))}")
    return out


def phase_profiler_window(root):
    """J4 (phase 39): ``run(preset(..., profile_dir=d, profile_steps=(1,
    3)))`` for 4 steps: one Chrome trace, holding exactly 4 launches of
    the per-sample kernel (steps 1 and 2, two RHS each) by its kernel
    name."""
    pdir = os.path.join(root, "prof")
    label = "fokkerPlanck32 profile_steps (1, 3)"
    _, _, counts = _drive(None, label, 4, cfg=preset(
        "fokkerPlanck32", device="cuda", profile_dir=pdir,
        profile_steps=(1, 3)))
    files = os.listdir(pdir)
    if files != ["trace_rank0.json"]:
        fail(f"profiler window wrote {files}")
    path = os.path.join(pdir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ps = [e for e in kernels if "persample_kernel" in e.get("name", "")]
    out = dict(trace_bytes=os.path.getsize(path), kernel_events=len(kernels),
               persample_events=len(ps), launches=counts["persample"],
               persample_device_ms=[e.get("dur", 0) / 1e3 for e in ps],
               s_per_step=_step_mean(label))
    each = " ".join(f"{x:.3f}" for x in out["persample_device_ms"])
    print(f"profiler window (1, 3): {out['trace_bytes']} B, "
          f"{len(kernels)} kernel events, {len(ps)} of the per-sample "
          f"kernel ({each} ms each)")
    if len(ps) != 4 or counts["persample"] != 8:
        fail(f"the trace holds {len(ps)} per-sample launches (expected 4; "
             f"{counts['persample']} in the run)")
    return out


def phase_pretrain_handoff(root):
    """J5 (phase 40): pretrain.train on fokkerPlanck32's flow (f32, the
    preset's seed) to normal_superpos in d=32, 16384 points, batches of
    1024, 2 epochs (32 Adam steps; the second resumed from the first's
    checkpoint, each timed): the loss falls; then the driver with
    ``--init-params <workdir>/pretrain_ckpt.npz`` for 2 steps: the theta
    handed to its first step is the pretrained one bit for bit, exactly
    4 plain-mode launches, no NaN. Its residual is this flow's Tikhonov
    bias, 3.3e-3 on the H100 (above the 1e-3 of the other runs): held
    instead to an f64 solve of the same system (_tikhonov_residuals)."""
    from vmc_pde_torch.pretrain import train as pretrain

    wdir = os.path.join(root, "pre")
    state = driver.build_problem(preset("fokkerPlanck32", device="cuda"))[0]
    t0 = time.perf_counter()
    data, _ = pretrain.gen_data((16384, 32), mode="normal_superpos",
                                dtype=torch.float32, device="cuda")
    gen_s = time.perf_counter() - t0
    # the first epoch (with the warm-up), then the second resumed from
    # its checkpoint
    losses, epoch_s = [], []
    for epochs, resume in ((1, False), (2, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += pretrain.train(state, data, batchsize=1024, epochs=epochs,
                                 workdir=wdir, checkpoint_every=1,
                                 resume=resume)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    print(f"pretrain on fokkerPlanck32's flow: gen_data {gen_s:.2f} s; "
          f"epochs of 16 Adam steps {epoch_s[0]:.3f} s (the first, with "
          f"the warm-up) and {epoch_s[1]:.3f} s (resumed from the first's "
          f"checkpoint); loss {losses[0]:.4f} -> {losses[1]:.4f}")
    if not losses[1] < losses[0]:
        fail(f"pretraining loss does not fall: {losses}")
    ckpt = os.path.join(wdir, "pretrain_ckpt.npz")
    with np.load(ckpt) as z:
        pretrained = torch.as_tensor(z["theta"])
    seen = {}
    build_problem = driver.build_problem

    def spy(cfg, ctx=None):
        out = build_problem(cfg, ctx)
        step = out[2].step

        def first(t, f, y, key, **kw):
            seen.setdefault("theta0", y.detach().cpu().clone())
            return step(t, f, y, key, **kw)

        out[2].step = first
        return out

    driver.build_problem = spy
    try:
        label = "fokkerPlanck32 --init-params pretrain_ckpt.npz"
        _, rows, counts = _drive(["fokkerPlanck32", "--init-params", ckpt],
                                 label, 2, max_res=None)
    finally:
        driver.build_problem = build_problem
    tikhonov = _tikhonov_residuals(pretrained, rows["solver_res"])
    start = seen["theta0"]
    exact = bool(torch.equal(start.to(pretrained.dtype), pretrained))
    print(f"{label}: the first step starts from the pretrained theta "
          f"bitwise {exact}; launches {counts['persample']}")
    if not exact or counts["persample"] != 4:
        fail("--init-params did not start from the pretrained theta, or "
             f"launched {counts['persample']} times (expected 4)")
    return dict(losses=losses, epoch_s=epoch_s, gen_data_s=gen_s,
                init_bitwise=exact,
                launches=counts["persample"],
                solver_res=rows["solver_res"].tolist(), tikhonov=tikhonov)


def _tikhonov_residuals(theta, path_res):
    """The pretrained flow's residual, taken apart on one batch of 16384
    draws at ``theta``: the path's f32 Cholesky solve of (S + lambda I) u
    = F and an f64 solve of the same system (S and F formed in f64 from
    the same O rows, the f32 solve's lambda_max), each one's residual
    ||S u - F|| / ||F|| against the f64 S and F. The exact solution's
    residual is lambda ||u|| / ||F||, the Tikhonov shift's bias, which no
    solve of this system goes below; the f32 residual must lie within 10%
    of it, the driver's two recorded ones within 25% (another batch)."""
    state, tdvp = driver.build_problem(preset("fokkerPlanck32",
                                              device="cuda"))[:2]
    theta_c, x = _batch(state, theta.double(), tdvp.n_samples, 41)
    _, eloc, O = tdvp._per_sample_batch(theta_c, x, 0.0)
    O_c, e_c = O - O.mean(0), eloc - eloc.mean()
    del O
    n = O_c.shape[0]
    S32, F32 = O_c.T @ O_c / n, e_c @ O_c / n
    O64 = O_c.double()
    S64, F64 = O64.T @ O64 / n, e_c.double() @ O64 / n
    del O64, O_c
    u32, lam_max = tdvp_mod._solve_cholesky(S32, F32, tdvp.cfg)
    u64 = tdvp_mod._solve_cholesky(S64, F64, tdvp.cfg, lam_max=lam_max)[0]

    def res(u):
        return float((S64 @ u.double() - F64).norm() / F64.norm())

    out = dict(f32=res(u32), f64=res(u64),
               bias=float(tdvp.cfg.svd_tol * lam_max * u64.norm()
                          / F64.norm()),
               update_rel=float((u32.double() - u64).norm() / u64.norm()),
               svd_tol=tdvp.cfg.svd_tol, lambda_max=float(lam_max))
    print(f"the pretrained flow's Tikhonov system on one batch (svd_tol "
          f"{out['svd_tol']:.3e}, lambda_max {out['lambda_max']:.4e}): "
          f"residual of the f32 solve {out['f32']:.3e}, of the f64 solve "
          f"{out['f64']:.3e}, lambda ||u|| / ||F|| {out['bias']:.3e}; the "
          f"f32 update {out['update_rel']:.3e} from the f64 one; the "
          f"run's residuals {' '.join(f'{r:.3e}' for r in path_res)}")
    del S32, S64
    if not (abs(out["f32"] - out["f64"]) <= 0.1 * out["f64"]
            and (np.abs(path_res - out["f64"]) <= 0.25 * out["f64"]).all()):
        fail("the pretrained flow's residual is not the Tikhonov bias of "
             "its system")
    return out


def phase_run_state():
    """J1-J5 (phases 36-40) in a scratch directory; returns their records
    and the per-sample kernel's launches by path."""
    h5 = _h5_stand_in()
    root = tempfile.mkdtemp(prefix="chip_smoke_j_")
    try:
        out = {"seed": phase_seed_and_aliases(),
               "checkpoint": phase_checkpoint_resume(h5, root),
               "recorder": phase_recorder(root),
               "profiler": phase_profiler_window(root),
               "pretrain": phase_pretrain_handoff(root)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    paths = {"fokkerPlanck32 --seed 3 (2 steps, each run)": 4,
             "fokkerPlanck32 --per-sample-backend pallas (1 step)":
                 out["seed"]["pallas_alias_launches"],
             "fokkerPlanck32 --checkpoint-every 1 (4 steps) + --resume "
             "(2 steps)": out["checkpoint"]["launches"],
             "fokkerPlanck32 --async-recorder (3 steps)": 6,
             "fokkerPlanck32 profiler window (4 steps; 4 in the trace)":
                 out["profiler"]["launches"],
             "fokkerPlanck32 --init-params (2 steps)":
                 out["pretrain"]["launches"]}
    return out, paths


# -- phase L: the ground-truth oracles, SanityFlow, the plots and the
# examples (oracle/, models/sanity.py, viz/, examples/), against the d=32
# Fokker-Planck main path at scripts/evolve_d32_fp.py's shape

D32 = dict(n_oracle=20000, n_model=16384, dim=32, T=10.0, dt=2e-3,
           steps=48)


def _gen(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_oracle_d32(dev):
    """L1: the SDE oracle of vmc_pde_torch.studies.evolve_d32_fp on the
    card in f64: 20000 particles (the JAX package's normals of PRNGKey(5),
    replayed on the host before the clock starts), d=32, phase_space at T=10, dt 2e-3, 49 records;
    the covariance diagonal against the Lyapunov ODE at every record,
    within 5 sqrt(2/n) relative (n the particles)."""
    from vmc_pde_torch.oracle import sde
    from vmc_pde_torch.studies import evolve_d32_fp

    n, d = D32["n_oracle"], D32["dim"]
    cloud = evolve_d32_fp.oracle_cloud(D32["n_model"], dev)
    inf, sec = _timed(lambda: evolve_d32_fp.oracle(
        cloud, D32["dt"], D32["steps"], D32["T"]))
    od = np.diagonal(inf["covar"], axis1=1, axis2=2)
    ed = np.tile(evolve_d32_fp.lyapunov_diag(inf["times"], D32["T"]),
                 (1, d // 2))
    rel = np.abs(od - ed) / ed
    bound = 5 * math.sqrt(2 / n)
    print(f"L1 SDE oracle d={d}, n={n}, {D32['steps'] + 1} records in f64: "
          f"{sec:.3f} s; covariance diagonal vs Lyapunov: max rel "
          f"{rel.max():.3e}, mean {rel.mean():.3e} (bound 5 sqrt(2/n) = "
          f"{bound:.3e}); momentum variance {od[0, 1::2].mean():.3f} -> "
          f"{od[-1, 1::2].mean():.3f} (exact {ed[-1, 1]:.3f})")
    if not (rel <= bound).all():
        fail(f"L1: the oracle's covariance leaves the Lyapunov solution by "
             f"{rel.max():.3e} > {bound:.3e}")
    cloud = torch.randn((n, d), generator=_gen(dev, 5), dtype=torch.float64,
                        device=dev)
    sites = _sync_sites(lambda: sde.evolve(
        cloud, 0.0, D32["dt"], 3, drift_name="phase_space",
        params=evolve_d32_fp.oracle_params(D32["T"]), gen=_gen(dev, 6)))
    print(f"L1 host waits in a 3-step evolve: {len(sites)} "
          f"{sorted(set(sites))}")
    return inf, dict(seconds=sec, cov_diag_lyapunov_rel_err_max=rel.max(),
                     cov_diag_lyapunov_rel_err_mean=rel.mean(), bound=bound,
                     host_waits=sorted(set(sites)))


def phase_model_d32(oracle_infos):
    """L2: vmc_pde_torch.studies.evolve_d32_fp's RunConfig through
    driver.run at N=16384 for 48 fixed-Heun steps, steps_per_dispatch 8,
    precision tpu: exactly 2 plain-mode launches a step, no NaN, residual
    below 1e-3; the study's summary against L1's cloud and the Lyapunov
    ODE, the latter gated at the model's own Monte Carlo bound
    5 sqrt(2/N) relative."""
    from vmc_pde_torch.studies import evolve_d32_fp

    N, steps = D32["n_model"], D32["steps"]
    args = evolve_d32_fp.parse_args(["--device", "cuda"])
    if (args.n, args.steps, args.dt, args.temperature) != (
            N, steps, D32["dt"], D32["T"]):
        fail("L2: evolve_d32_fp's defaults are not phase L's shape")
    cfg = evolve_d32_fp.make_config(args)
    label = f"L2 evolve_d32_fp N={N}"
    t0 = time.perf_counter()
    state, arrays, counts = _drive(None, label, steps, cfg=cfg)
    wall = time.perf_counter() - t0
    print(f"{label}: P = {state.numParameters}, {wall:.1f} s for "
          f"{steps} steps")
    if counts["persample"] != 2 * steps:
        fail(f"L2: {counts['persample']} plain-mode launches, expected "
             f"{2 * steps}")
    bound = 5 * math.sqrt(2 / N)
    summary = dict(evolve_d32_fp.summarize(arrays, oracle_infos, D32["T"],
                                           wall),
                   wall_s=wall, P=state.numParameters, exact_bound=bound,
                   launches=counts["persample"])
    print(f"{label} summary: {json.dumps(summary)}")
    if not summary["cov_diag_exact_rel_err_max"] <= bound:
        fail(f"L2: the model's covariance diagonal leaves the Lyapunov "
             f"solution by {summary['cov_diag_exact_rel_err_max']:.3e} > "
             f"5 sqrt(2/N) = {bound:.3e}")
    return summary


def phase_oracle_fluidpaper(dev):
    """L3: ``python -m vmc_pde_torch.oracle fluidpaper`` at the CLI's
    defaults (10000 particles, dt 1e-2, t_end 12): the Metropolis kernel
    launched for the cloud, the cloud's mean radius within 5% of the
    bump's, and the same cloud integrated by the port on the CPU in f64:
    within 1e-10 of the card's after 100 steps; the gap at t_end
    reported."""
    from vmc_pde_torch.oracle import sde
    from vmc_pde_torch.oracle.__main__ import main as oracle_main

    _zero_counts()
    (final, inf), sec = _timed(lambda: oracle_main(["fluidpaper"]))
    counts = _counts()
    print(f"L3 oracle fluidpaper (10000 particles, 1200 steps): {sec:.3f} s,"
          f" kernel launches {counts}")
    if counts["metropolis"] != 1:
        fail(f"L3: the Metropolis kernel launched {counts['metropolis']} "
             "times for the cloud, expected 1")
    # the CLI's cloud again (the same generator seed: the same draws)
    cloud = sde.mcmc_init_cloud(_gen(dev, 0), 10000, BUMP_OFFSET)
    same = np.array_equal(cloud.mean(dim=0).cpu().numpy(), inf["x1"][0])
    r = torch.linalg.vector_norm(cloud - torch.tensor(
        BUMP_OFFSET, dtype=cloud.dtype, device=dev), dim=-1)
    mean_r, want_r = float(r.mean()), _bump_mean_radius(0.25)
    print(f"L3 cloud: the CLI's first record again {same}; mean radius "
          f"{mean_r:.5f} vs the bump's {want_r:.5f} "
          f"({abs(mean_r / want_r - 1):.2%}, bound 5%)")
    if not same or abs(mean_r / want_r - 1) > 0.05:
        fail("L3: the Metropolis cloud is not the CLI's, or not the bump's")
    kw = dict(drift_name="advection_paper", params={"T": 5.0},
              integral_T=5.0)
    c100, _ = sde.evolve(cloud, 0.0, 1e-2, 100, **kw)
    (c100_cpu, _), cpu_sec = _timed(lambda: sde.evolve(cloud.cpu(), 0.0,
                                                       1e-2, 100, **kw))
    gap100 = float((c100.cpu() - c100_cpu).abs().max())
    c_end, _ = sde.evolve(c100_cpu, 1.0, 1e-2, 1100, **kw)
    gap_end = float((final.cpu() - c_end).abs().max())
    print(f"L3 card vs the CPU's f64 integration of the same cloud: "
          f"{gap100:.3e} after 100 steps (bound 1e-10), {gap_end:.3e} at "
          f"t_end 12; the CPU's 100 steps {cpu_sec:.3f} s")
    if not gap100 <= 1e-10:
        fail(f"L3: card and CPU apart by {gap100:.3e} after 100 steps")
    return dict(seconds=sec, launches=counts["metropolis"],
                mean_radius=mean_r, bump_mean_radius=want_r,
                gap_100_steps=gap100, gap_t_end=gap_end), cloud


def phase_oracle_cli_workdir(root):
    """L4: ``hamiltonian`` through the CLI with --workdir: infos.hdf5 with
    the JAX CLI's keys and shapes, read back by load_infos; the final
    variances within 5 SE of the stationary T."""
    from vmc_pde_torch.oracle.__main__ import main as oracle_main
    from vmc_pde_torch.utils.infos import load_infos

    wdir = os.path.join(root, "oracle_hamiltonian")
    _, sec = _timed(lambda: oracle_main(["hamiltonian", "--workdir", wdir]))
    inf = load_infos(os.path.join(wdir, "infos.hdf5"))
    shapes = {k: v.shape for k, v in inf.items()}
    want = {"times": (1200,), "x1": (1200, 6), "covar": (1200, 6, 6),
            "integral_1sigma": (1200,), "integral_0.5sigma": (1200,),
            "integral_0.1sigma": (1200,)}
    var = np.diag(inf["covar"][-1])
    se = math.sqrt(2 / 10000) * 10.0
    print(f"L4 oracle hamiltonian --workdir: {sec:.3f} s; infos.hdf5 "
          f"{shapes}; final variances {np.round(var, 3)} vs T = 10 "
          f"(5 SE = {5 * se:.3f})")
    if shapes != want:
        fail(f"L4: infos.hdf5 has {shapes}, the JAX CLI's are {want}")
    if not (np.abs(var - 10.0) < 5 * se).all():
        fail(f"L4: final variances {var} leave T = 10 by more than 5 SE")
    return dict(seconds=sec, final_var=var.tolist(), five_se=5 * se)


def phase_oracle_double_well(dev):
    """L5: vmc_pde_torch.studies.evolve_doublewell's oracle cloud at its
    100000 particles: x against the quadrature CDF (Kolmogorov-Smirnov
    distance below 5/sqrt(n)), the variance of p within 5 SE of DW_T0;
    then its 1001 phase_space steps at T=0.5, lam=1, v2=-4, timed."""
    from vmc_pde_torch.models.latent import DW_T0, dw_x_quadrature
    from vmc_pde_torch.studies import evolve_doublewell

    n = evolve_doublewell.parse_args([]).oracle_n
    cloud, init_sec = _timed(lambda: evolve_doublewell.oracle_cloud(n, dev))
    xs, pdf = dw_x_quadrature()
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    x = np.sort(cloud[:, 0].cpu().numpy())
    F = np.interp(x, xs, cdf)
    ks = max((np.arange(1, n + 1) / n - F).max(), (F - np.arange(n) / n).max())
    var_p = float(cloud[:, 1].var(unbiased=False))
    se = math.sqrt(2 / n) * DW_T0
    (final, inf), sec = _timed(lambda: evolve_doublewell.oracle(
        cloud, 2e-3, 1001))
    finite = bool(torch.isfinite(final).all()) and all(
        np.isfinite(v).all() for v in inf.values())
    var_end = np.diag(inf["covar"][-1])
    print(f"L5 double-well cloud n={n}: {init_sec:.3f} s, KS {ks:.2e} "
          f"(bound {5 / math.sqrt(n):.2e}), var p {var_p:.4f} vs DW_T0 "
          f"{DW_T0} (5 SE {5 * se:.4f}); 1001 steps {sec:.3f} s, finite "
          f"{finite}, var (x, p) at t=2 {np.round(var_end, 4)}")
    if ks >= 5 / math.sqrt(n) or abs(var_p - DW_T0) >= 5 * se:
        fail("L5: the double-well cloud misses its density")
    if not finite:
        fail("L5: the double-well evolution went non-finite")
    return dict(init_seconds=init_sec, ks=ks, var_p=var_p, seconds=sec)


def _radial_steps(faces, t_end, n_record, d=8, cfl=0.2):
    """(steps, dt) of radial.evolve_radial on ``faces`` (its rule: the
    explicit bound's step count rounded up to whole recording chunks)."""
    dr = float(np.diff(faces).min())
    n = math.ceil(t_end / (cfl * dr * dr / (2.0 * d)))
    every = max(n // n_record, 1)
    n = -(-n // every) * every
    return n, t_end / n


def phase_radial(dev):
    """L6: evolve_radial on the card in f64. The Gaussian grid of
    tests/test_oracle_and_e2e.py:337 (d=8, r_max 30, n_r 1200, t_end 0.5)
    against the closed-form entropy (5e-3) and variance (2e-3), mass drift
    below 1e-10; vmc_pde_torch.studies.compare_student_grid's graded grid
    (grid_reference): the t=0 entropy
    within 5e-3 of student_t_entropy(2, 8), eager and graphed runs on the
    card against the CPU's to t_end 0.01 (2500 steps) within 1e-12
    relative, and a graphed run of the same t_end as a single recording
    chunk (2001 steps; the captured graphs hold at most 256 steps however
    long the chunk) against the eager run of those steps, the eager one's
    ms a step; then the graded grid to a cut
    t_end of 0.5 (100400 steps), not the script's 5, graphed, its ms a step
    and the projection to t_end 5: 10^6 steps would take 31-33 s
    (0.031-0.033 ms a step on an H100 80GB HBM3 at 700 W), so the t_end=5
    run waits for a
    single-block kernel of the chunk (ROADMAP.md)."""
    from functools import partial

    from vmc_pde_torch.oracle import radial
    from vmc_pde_torch.studies import compare_student_grid as csg

    gauss = partial(radial.gauss_radial, d=8)
    out, gauss_sec = _timed(lambda: radial.evolve_radial(
        gauss, d=8, r_max=30.0, n_r=1200, t_end=0.5, n_record=50,
        device=dev))
    t = out["times"]
    ent_err = np.abs(out["entropy"] - 4 * np.log(2 * math.pi * math.e
                                                 * (1 + 2 * t))).max()
    var_err = np.abs(out["var"] - (1 + 2 * t)).max()
    drift = np.abs(out["mass"] - out["mass"][0]).max()
    print(f"L6 radial Gaussian grid (n_r 1200, t_end 0.5) on the card: "
          f"{gauss_sec:.3f} s; entropy err {ent_err:.2e} (5e-3), var err "
          f"{var_err:.2e} (2e-3), mass drift {drift:.2e} (1e-10)")
    if not (ent_err < 5e-3 and var_err < 2e-3 and drift < 1e-10):
        fail("L6: the radial oracle misses the Gaussian closed forms")

    faces = csg.grid_faces()
    runs = {}
    for label, extra in (
            ("eager", dict(device=dev, cuda_graph=False, n_record=4)),
            ("graphed", dict(device=dev, n_record=4)),
            ("cpu", dict(device="cpu", n_record=4)),
            # one recording chunk of all 2001 steps: 7 replays of the
            # 256-step graph, then the 209-step tail with the diagnostics,
            # against the eager run of the same steps on the card
            ("one record", dict(device=dev, n_record=1)),
            ("one record eager", dict(device=dev, cuda_graph=False,
                                      n_record=1))):
        runs[label] = _timed(lambda: csg.grid_reference(0.01, **extra))

    def rel_gap(a, b):
        return max(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
                   for k in ("entropy", "mass", "var", "f_final"))

    gap = max(rel_gap(runs["eager"][0], runs["cpu"][0]),
              rel_gap(runs["graphed"][0], runs["cpu"][0]),
              rel_gap(runs["one record"][0], runs["one record eager"][0]))
    n_short, dt = _radial_steps(faces, 0.01, 4)
    eager_ms = 1e3 * runs["eager"][1] / n_short
    s0 = radial.student_t_entropy(2.0, 8)
    t0_ent = runs["graphed"][0]["entropy"][0]
    print(f"L6 graded grid ({len(faces) - 1} cells, dt {dt:.2e}): t=0 "
          f"entropy {t0_ent:.5f} vs {s0:.5f}; card (eager and graphed) vs "
          f"CPU to t_end 0.01, and as one record against eager: {gap:.2e} "
          f"relative (1e-12); eager "
          f"{eager_ms:.4f} ms a step; CPU {runs['cpu'][1]:.2f} s for "
          f"{n_short} steps; graphed as one record {runs['one record'][1]:.3f}"
          f" s with its capture (n_record 4: {runs['graphed'][1]:.3f} s)")
    if abs(t0_ent - s0) >= 5e-3 or not gap <= 1e-12:
        fail("L6: the graded grid misses its t=0 entropy or the CPU path")
    t_run = 0.5
    out, sec = _timed(lambda: csg.grid_reference(t_run, n_record=250,
                                                 device=dev))
    graph_ms = 1e3 * sec / _radial_steps(faces, t_run, 250)[0]
    projected = graph_ms * _radial_steps(faces, 5.0, 250)[0] / 1e3
    drift = np.abs(out["mass"] - out["mass"][0]).max()
    rising = bool((np.diff(out["entropy"]) > 0).all())
    print(f"L6 graded grid to t_end {t_run}, graphed (cut from the "
          f"script's 5): {sec:.2f} s, {graph_ms:.4f} ms a step, t_end 5 "
          f"projected at {projected:.1f} s; entropy {out['entropy'][0]:.4f}"
          f" -> {out['entropy'][-1]:.4f} rising {rising}, mass drift "
          f"{drift:.2e}")
    if drift >= 1e-10 or not rising:
        fail("L6: the graded run lost mass or entropy")
    sites = _sync_sites(lambda: csg.grid_reference(0.002, n_record=4,
                                                   device=dev))
    print(f"L6 host waits in a graphed run: {len(sites)} "
          f"{sorted(set(sites))}")
    return dict(gauss_seconds=gauss_sec, eager_ms_per_step=eager_ms,
                graph_ms_per_step=graph_ms, card_vs_cpu=gap, t_end=t_run,
                t_end_seconds=sec, projected_t5_seconds=projected,
                host_waits=sorted(set(sites)))


def phase_sanity_plots_examples(dev, cloud):
    """L7: one TDVP RHS with SanityFlow(dim=3) on the card (``auto`` keeps
    its P = 15 off the per-sample kernel: no launch; the update within
    1e-5 of the CPU's on the same draws); plot_data_diff's grid density of
    fluidpaper's flow, card against CPU (and the figure's integrated
    |diff| where matplotlib imports); the custom_equation example on the
    card with its own gates (f64 as on the CPU if the tpu precision misses
    one); minimal_demo where matplotlib imports."""
    import contextlib
    import importlib.util
    import io

    from vmc_pde_torch.examples import custom_equation, minimal_demo
    from vmc_pde_torch.models.sanity import SanityFlow
    from vmc_pde_torch.utils.dtypes import resolve
    from vmc_pde_torch.viz import plots

    out = {}
    flow = SanityFlow(3)
    params = flow.init()
    params["scale"] = np.array([1.25])
    params["latent"]["mu"] = np.array([0.1, -0.2, 0.3])
    z = torch.randn((16384, 3), generator=_gen(dev, 8), device=dev)
    updates = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        theta = torch.as_tensor(flow.layout.ravel(params),
                                dtype=torch.float32, device=where)
        prec = resolve("f32")
        state = VarState(flow, theta, precision=prec,
                         sampler=sampling.Sampler(3, dtype=torch.float32))
        tdvp = TDVP(state, make_equation("diffusion", 3),
                    tdvp_mod.TDVPConfig(), n_samples=16384, precision=prec)
        _zero_counts()
        aux = tdvp._rhs_impl(theta, 0.0, 0, z.to(where))
        updates[label] = aux["update"].double().cpu()
        if label == "card":
            counts = _counts()
            if tdvp.uses_kernel or counts["persample"]:
                fail(f"L7: SanityFlow launched the per-sample kernel "
                     f"({counts})")
    sane = _rel(updates["card"], updates["cpu"])
    print(f"L7 SanityFlow(dim=3) RHS at N=16384, f32: card vs CPU update "
          f"{sane:.2e} (1e-5), per-sample launches 0")
    if not sane <= 1e-5:
        fail(f"L7: SanityFlow's RHS differs between card and CPU: {sane}")
    out["sanity_rhs_card_vs_cpu"] = sane

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    fp_state = driver.build_problem(preset("fluidpaper", device="cuda"))[0]
    cpu_state = VarState(fp_state.flow, fp_state.theta.cpu(),
                         precision=fp_state.precision)
    grid = Grid(np.ones(2), 100, sym=False)
    dens = {}
    for label, st in (("card", fp_state), ("cpu", cpu_state)):
        # p, not log p: the bump's log p is -inf off its support
        dens[label] = np.exp(plots._log_density(st, grid.coords))
    gap = np.abs(dens["card"] - dens["cpu"]).max() / dens["cpu"].max()
    print(f"L7 plot_data_diff's grid density of fluidpaper's flow (100^2 on "
          f"[0, 1]^2): card vs CPU {gap:.2e} of max p (1e-5); "
          f"matplotlib {'imports' if have_mpl else 'is absent: no drawing'}")
    if not gap <= 1e-5:
        fail(f"L7: the grid density differs between card and CPU: {gap}")
    out["grid_density_card_vs_cpu"] = gap
    if have_mpl:
        data = cloud.cpu().numpy()
        diffs = {}
        for label, st in (("card", fp_state), ("cpu", cpu_state)):
            fig, diffs[label] = plots.plot_data_diff(st, grid, data)
            plots._plt().close(fig)
        print(f"L7 plot_data_diff integrated |diff| against the L3 cloud: "
              f"card {diffs['card']:.6f}, CPU {diffs['cpu']:.6f}")
        if not abs(diffs["card"] - diffs["cpu"]) <= 1e-5 * diffs["cpu"]:
            fail("L7: plot_data_diff differs between card and CPU")
        out["plot_data_diff"] = diffs

    runs = {}
    for precision in ("tpu", "f64"):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            code, sec = _timed(lambda: custom_equation.main(
                ["--device", "cuda", "--precision", precision,
                 "--workdir", ""]))
        lines = text.getvalue().splitlines()
        print(f"L7 custom_equation on the card, precision {precision}: "
              f"{sec:.1f} s; " + "; ".join(lines))
        runs[precision] = dict(code=code, seconds=sec, lines=lines)
        if code == 0:
            break
    out["custom_equation"] = runs
    if code != 0:
        fail("L7: custom_equation misses its gates on the card in f64")

    if have_mpl:
        demo_dir = tempfile.mkdtemp(prefix="chip_smoke_demo_")
        try:
            _, sec = _timed(lambda: minimal_demo.main(
                ["--device", "cuda", "--outdir", demo_dir]))
            figs = sorted(os.listdir(demo_dir))
        finally:
            shutil.rmtree(demo_dir, ignore_errors=True)
        print(f"L7 minimal_demo on the card: {sec:.1f} s, wrote {figs}")
        out["minimal_demo"] = dict(seconds=sec, files=figs)
    return out


def _gram(n, dtype, dev):
    """The Gram X X^T / 2n of an (n, 2n) standard normal X (seed n), in
    ``dtype``: tools/time_jacobi.py's matrices."""
    X = torch.randn(n, 2 * n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n))
    return (X @ X.T / (2 * n)).to(dtype).to(dev)


def _device_ms(fn, reps, keys):
    """Device time per call of fn of the kernels whose names hold one of
    ``keys``, in a trace of the device's activity over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and any(k in e.name() for k in keys)) / 1e6 / reps


# phase 48's orders of the block variant: the presets' spectral solves in
# f32 (diffusion's P=365, harmonicOsc_diff's 411, bench.py's d=8 reference
# shape's 684, diffusion_anisotropic's 762) up to the reach, and the same
# span in f64 (the tpu_f64stats and f64 precisions' solves)
JACOBI_ORDERS = ((365, torch.float32), (411, torch.float32),
                 (684, torch.float32), (762, torch.float32),
                 (1024, torch.float32), (2048, torch.float32),
                 (256, torch.float64), (320, torch.float64),
                 (411, torch.float64), (762, torch.float64),
                 (2048, torch.float64))


def _jacobi_vs_eigh(label, A, reps=20):
    """The Jacobi kernel on A against torch.linalg.eigh: eigenvalues
    against an f64 eigh within 64 n eps of A's norm, V diag(w) V^T and
    V^T V - I within 1e-4 (f32) or 1e-12 (f64), ascending; the sweeps;
    call ms of the kernel and of torch.linalg.eigh (its plain version and
    the one PyTorch call that computes the same) in turns in this call
    (eigh, kernel, kernel, eigh; CUDA events, means of ``reps`` calls);
    the bound: the function's own work, whatever the algorithm
    (jacobi.flops: ~9 n^3) at the card's peak for the dtype (f64 on the
    tensor cores), and the bytes of A, w and V; the share of the bound."""
    n, dt = A.shape[0], A.dtype
    blocks = jacobi.in_blocks(n, dt)
    sweeps = torch.zeros(1, dtype=torch.int32, device=A.device)
    w, V = jacobi.eigh_cuda(A, sweeps)
    w64 = torch.linalg.eigh(A.double())[0]
    nrm = float(torch.linalg.norm(A.double()))
    err = float((w.double() - w64).abs().max())
    recon = float(torch.linalg.norm(V @ torch.diag(w) @ V.T - A)) / nrm
    orth = float((V.T @ V - torch.eye(n, dtype=dt, device=A.device))
                 .abs().max())
    tol = 64 * n * torch.finfo(dt).eps * nrm
    gate = 1e-4 if dt == torch.float32 else 1e-12
    kern = lambda: jacobi.eigh_cuda(A)  # noqa: E731
    eig = lambda: torch.linalg.eigh(A)  # noqa: E731
    e1, k1, k2, e2 = (_time_ms(fn, reps) for fn in (eig, kern, kern, eig))
    n_sweeps = int(sweeps.item())
    item = torch.empty((), dtype=dt).element_size()
    bound, by = bounds.bound_ms(
        item * (2 * n * n + n), jacobi.flops(n),
        bounds.F32_FLOP_S if item == 4 else bounds.F64_FLOP_S)
    ms, plain = (k1 + k2) / 2, (e1 + e2) / 2
    kind = "blocks" if blocks else "one block"
    print(f"jacobi eigh n={n} {str(dt)[6:]} ({label}; {kind}): eigenvalues "
          f"vs f64 eigh max abs err "
          f"{err:.3e} (tol {tol:.3e}, |A| {nrm:.3e}), V diag(w) V^T rel "
          f"{recon:.3e}, V^T V - I {orth:.3e} (gate {gate:g}), {n_sweeps} "
          f"sweeps; in turns torch.linalg.eigh {e1:.4f}, kernel {k1:.4f} "
          f"{k2:.4f}, torch.linalg.eigh {e2:.4f} ms; bound {bound:.5f} ms "
          f"({by}), share {bound / ms:.5f}")
    if (err > tol or recon > gate or orth > gate
            or not bool((w[1:] >= w[:-1]).all())):
        fail(f"the Jacobi kernel disagrees with torch.linalg.eigh at n={n} "
             f"{dt}")
    return dict(max_abs_err=err, recon=recon, orth=orth, ms=ms,
                ms_turns=[k1, k2], plain_ms=plain, eigh_ms_turns=[e1, e2],
                bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
                library_ms=plain, sweeps=n_sweeps, blocks=blocks)


def _caught_ritz_matrix():
    """The main path's own eigensolve input: the (72, 72) f32 Ritz matrix
    of one fokkerPlanck32 RHS at N=16384, caught from that RHS's call;
    returns it with the problem's state and TDVP."""
    caught = []
    eigh = jacobi.eigh

    def catch(A):
        caught.append(A.clone())
        return eigh(A)

    # the TDVP takes its eigensolve when it is built
    jacobi.eigh = catch
    try:
        state, tdvp = driver.build_problem(preset("fokkerPlanck32",
                                                  device="cuda"))[:2]
        tdvp.rhs(state.get_parameters(), 0.0, 11)
    finally:
        jacobi.eigh = eigh
    return caught[0], state, tdvp


def phase_jacobi(dev):
    """Phase 48: the Jacobi eigensolve kernel (csrc/jacobi.cu) against
    torch.linalg.eigh (_jacobi_vs_eigh) on the main path's own input, the
    (72, 72) f32 Ritz matrix of one fokkerPlanck32 RHS at N=16384 caught
    from that RHS's call, and on the same matrix in f64 (one block); the
    block variant at JACOBI_ORDERS (random Grams, `_gram`); one
    fokkerPlanck32 step at spectrum_topk=200 (a Ritz matrix of order 208:
    2 block-variant launches); the kernel's device ms from a child process
    (_jacobi_device_ms); the diffusion graphs after phase M
    (phase_jacobi_traced). Returns the one-block and the block variant's
    records."""
    t_phase = time.perf_counter()
    lib = build.library("jacobi")
    for dt, f64 in ((torch.float32, 0), (torch.float64, 1)):
        got = (lib.jacobi_reach(f64, 0), lib.jacobi_reach(f64, 1))
        if got != (jacobi.ONE_BLOCK_REACH[dt], jacobi.REACH[dt]):
            fail(f"jacobi: the library's reach {got} in {dt} is not the "
                 f"wrapper's, which routes by it")
    B, state, tdvp = _caught_ritz_matrix()
    one = _jacobi_vs_eigh("the main path's Ritz matrix", B)
    one["f64"] = _jacobi_vs_eigh("the same matrix in f64", B.double())
    if one["ms_turns"][1] >= min(one["eigh_ms_turns"]):
        print(f"jacobi: the kernel ({one['ms']:.4f} ms) is not under "
              f"torch.linalg.eigh ({one['plain_ms']:.4f} ms) at n="
              f"{B.shape[0]}")
    mats = {f"n={n} {str(dt)[6:]}": _gram(n, dt, dev)
            for n, dt in JACOBI_ORDERS}
    orders = {key: _jacobi_vs_eigh("a random Gram", A,
                                   20 if A.shape[0] <= 800 else 5)
              for key, A in mats.items()}
    under = [k for k, r in orders.items()
             if max(r["ms_turns"]) < min(r["eigh_ms_turns"])]
    print(f"jacobi blocks: every kernel turn under every torch.linalg.eigh "
          f"turn at {under}; not at "
          f"{[k for k in orders if k not in under]}")
    dev_ms = _jacobi_device_ms({"f32": B, "f64": B.double(), **mats})
    one["device_ms"], one["f64"]["device_ms"] = dev_ms["f32"], dev_ms["f64"]
    for key, rec in orders.items():
        rec["device_ms"] = dev_ms[key]
    print(f"jacobi eigh: the kernel's device ms (profiler, a child "
          f"process) {dev_ms}")
    blocks = dict(orders["n=365 float32"], orders=orders)
    # spectrum_topk is the TDVP's (no CLI flag sets it)
    label = "fokkerPlanck32 N=16384 spectrum_topk=200"
    big = TDVP(state, tdvp.equation, dataclasses.replace(
        tdvp.cfg, spectrum_topk=200), n_samples=tdvp.n_samples,
        n_samples_obs=tdvp.n_samples_obs, precision=tdvp.precision)
    theta = state.get_parameters()
    steps = []
    for _ in range(2):  # the first pays the set-up
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dy, aux = big.heun_pair(theta, 0.0, 1e-3, 11)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    counts = _counts()
    finite = bool(torch.isfinite(theta + dy).all()) and bool(
        torch.isfinite(aux["ev_topk"]).all())
    print(f"{label}: one fixed-Heun step {steps[-1]:.4f} s (first "
          f"{steps[0]:.4f}), launches {counts}, finite theta {finite}, "
          f"residual {float(aux['solver_res']):.3e}, top Ritz value "
          f"{float(aux['ev_topk'][-1]):.6e} ({aux['ev_topk'].shape[-1]} "
          f"values), graphs_refusal {big.graphs_refusal}")
    if (counts["jacobi_blocks"] != 2 or counts["jacobi"] != 0 or not finite
            or aux["ev_topk"].shape[-1] != 200
            or big.graphs_refusal is not None):
        fail(f"{label}: launches {counts}, finite {finite}, refusal "
             f"{big.graphs_refusal}")
    blocks["topk200"] = dict(s_per_step=steps[-1],
                             solver_res=float(aux["solver_res"]),
                             launches=counts["jacobi_blocks"])
    del big, dy, aux
    print(f"phase 48: {time.perf_counter() - t_phase:.1f} s")
    return one, blocks


def _jacobi_device_ms_child(path):
    """In a process of its own: the Jacobi kernel's device ms (profiler)
    on each matrix saved at ``path``; prints them as the last line."""
    full_f32_matmuls()
    out = {}
    for key, A in torch.load(path).items():
        A = A.cuda()
        variant = ("jacobi_blocks" if jacobi.in_blocks(A.shape[0], A.dtype)
                   else "jacobi")
        out[key] = _device_ms(lambda: jacobi.eigh_cuda(A), 5,
                              TRACE_KERNELS[variant])
    print(json.dumps(out))


def _jacobi_device_ms(mats):
    """The kernel's device ms on each of ``mats`` from a child process:
    this process starts no profiler session before phase M's (one that
    started early, in phase 48, left M2's conditional-node replays' kernel
    records under the wrong kernels' names: records named for the
    per-sample and Jacobi kernels lasting 1-6 us beside the real ~1 and
    ~0.5 ms ones, 83 per-sample counted against the 75 launched; and
    after phase M, sessions credited the kernel's time to other names:
    H100, torch 2.11, CUDA 12.8). Phase M fails if a session started
    before it (_watch_profilers)."""
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    try:
        torch.save({k: A.cpu() for k, A in mats.items()}, path)
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke as c; "
             f"c._jacobi_device_ms_child({path!r})"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    finally:
        os.unlink(path)
    if proc.returncode != 0:
        fail(f"the Jacobi device-time child failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_jacobi_traced(one, blocks):
    """Phase 48's graphs, after phase M (whose traces are this process's
    first profiler sessions, see _jacobi_device_ms): the eigh solves of
    the diffusion preset (P=365, f32) and of diffusion_anisotropic (P=762,
    f32: above the block variant's parent's reach, it ran eagerly) at
    --steps-per-dispatch 8 as CUDA graphs against K=1, bit for bit
    (_graph_path: 2 block-variant solves a step, counted by the kernel on
    the device in both runs and, in the batched one, in a trace of the
    device's activity too). Returns the block variant's launches by
    path."""
    paths = {}
    for key, name in (("diffusion_graph", "diffusion"),
                      ("anisotropic_graph", "diffusion_anisotropic")):
        cfg = preset(name, device="cuda")
        blocks[key] = rec = _graph_path(
            f"J {name} (eigh) fixed_heun", cfg, M_K, {"jacobi_blocks": 2},
            gate_batched_trace=False,
            device_counts={"jacobi_blocks": jacobi.block_solves_on_device})
        paths[f"{name} K=1 ({M_K} steps)"] = \
            rec["launches_per_step_run"]["jacobi_blocks"]
        paths[f"{name} K={M_K}, the kernel's own count of its solves (the "
              f"capture's warm-up and {M_K} replays)"] = \
            rec["device_launches"]["jacobi_blocks"]
        paths[f"{name} K={M_K}, one replay (a step) in a profiler trace"] = \
            rec["replay_launches"]["jacobi_blocks"]
    paths["fokkerPlanck32 N=16384 spectrum_topk=200 (1 step)"] = \
        blocks["topk200"]["launches"]
    return paths


# -- phase M: multi-step dispatch as CUDA graphs (M1-M4) ---------------------

# kernel classes in a profiler trace, by pieces of the kernel's name
# (demangled, or mangled): the per-sample kernel's first template argument
# is its split mode
TRACE_KERNELS = {"persample": ("persample_kernel<false",
                               "persample_kernelILb0"),
                 "persample_split": ("persample_kernel<true",
                                     "persample_kernelILb1"),
                 "quant8": ("quant_force_kernel",), "syrk": ("tiles_kernel",),
                 "jacobi": ("jacobi_kernel<", "jacobi_kernelI"),
                 "jacobi_blocks": ("jacobi_block_kernel",)}
TRACE_LETTERS = {"persample": "P", "persample_split": "S", "quant8": "Q",
                 "syrk": "Y", "jacobi": "J", "jacobi_blocks": "B"}
M_K = 8  # steps per batch on M1, M2's adaptive Heun and M4's fluidpaper
M2_RK23_K = 4  # RK23 at tol 2e-5 (no retry there: Heun shows it)
M3_K = 2  # at the production point, where a step takes ~2.6 s
M4_DW_K = 4  # doubleWell, whose eager step takes 0.5-0.8 s


def _watch_profilers():
    """Where this process first starts a torch.profiler session (any
    session: this script's, or the port's profiler window): phase M's
    exact launch counts hold only while none started before its own
    traces (see _jacobi_device_ms), and phase M fails if one did."""
    from torch.profiler import profile

    start = profile.start

    def start_watched(self):
        if _watch_profilers.first is None:
            _watch_profilers.first = "".join(
                traceback.format_stack(limit=4)[:-1])
        return start(self)

    profile.start = start_watched


_watch_profilers.first = None


def _trace(call):
    """(launches by kernel class, device busy share, wall s) of call() in
    a torch.profiler trace of the device's activity (no host op is
    recorded, so the host's times stay near an untraced run's): the
    kernels' device time over the host's wall time, both from the
    synchronize before to the one after. The trace's raw events are read
    as they are (the profiler's event tree, which nothing here needs, is
    never built: it took seconds a trace at the production point)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.name(), e.duration_ns()) for e in sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA), key=lambda e: e.start_ns())]
    counts = {name: sum(1 for k, _ in rows if any(p in k for p in keys))
              for name, keys in TRACE_KERNELS.items()}
    # the traced kernels in start order, one letter a class: a count that
    # fails its gate shows where the extra or missing launches sit
    _trace.sequence = "".join(
        next((TRACE_LETTERS[name] for name, keys in TRACE_KERNELS.items()
              if any(p in k for p in keys)), "") for k, _ in rows)
    busy = sum(ns for _, ns in rows) / 1e9 / wall
    return counts, busy, wall


def _host_wait_count(call):
    """The synchronizing CUDA operations in call(), as torch's sync debug
    mode reports them: their sites, each with the innermost frames of the
    port or of this script that led there."""
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            ours = [f"{os.path.relpath(f.filename)}:{f.lineno}"
                    for f in traceback.extract_stack()[:-1]
                    if "vmc_pde_torch" in f.filename
                    or f.filename.endswith("chip_smoke.py")]
            found.append(f"{os.path.relpath(filename)}:{lineno} (from "
                         f"{' <- '.join(reversed(ours[-3:]))})")

    # the mode is set before the warnings are caught: setting it may warn
    # itself (torch/cuda/__init__.py), which is no host wait
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return found


class _Kept:
    """Keeps the problem driver.run builds, with its captured programs
    (the run's release_graphs is held back: the caller releases them),
    and times every fused step call (synchronized)."""

    def __init__(self):
        self.problems, self.theta0, self.calls = [], [], {}

    def __enter__(self):
        self._build = driver.build_problem
        self._release = TDVP.release_graphs
        self._orig = {n: getattr(TDVP, n) for n in (
            "heun_pair", "rk3_triple", "heun_attempt", "rk23_attempt",
            "heun_multi", "adaptive_multi")}
        driver.build_problem = lambda cfg, ctx=None: self._keep(
            self._build(cfg, ctx))
        TDVP.release_graphs = lambda tdvp: None
        for name, fn in self._orig.items():
            setattr(TDVP, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        driver.build_problem = self._build
        TDVP.release_graphs = self._release
        for name, fn in self._orig.items():
            setattr(TDVP, name, fn)

    def _keep(self, problem):
        self.problems.append(problem)
        self.theta0.append(problem[0].get_parameters())
        return problem

    def _timed(self, name, fn):
        def timed(tdvp, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tdvp, *args, **kw)
            torch.cuda.synchronize()
            self.calls.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed


def _batch_inputs(cfg, K):
    """The first batch's (ts, dts, keys) of a run of cfg, as the driver
    plans it (ts and dts for the fixed steppers' ramp)."""
    ts, dts, t, ramp = [], [], 0.0, cfg.dt0
    for _ in range(K):
        ramp = min(ramp * cfg.increase_fac, cfg.max_step)
        ts.append(t)
        dts.append(ramp)
        t += ramp
    keys = [tdvp_mod.fold_in(cfg.sample_seed + 7, i) for i in range(K)]
    return ts, dts, keys


def _graph_path(label, cfg, K, per_run, adaptive=False, bar=None,
                gate_batched_trace=True, device_counts=None):
    """One path of phase M: driver.run at steps_per_dispatch 1 and K for K
    steps (one batch), the rows and theta against each other (fixed: bit
    for bit; adaptive: attempts equal, times to rtol 1e-12, theta within
    ``bar`` of its largest entry). Launches: the K=1 run's are its
    wrappers' counts; the batched run's are the kernels of a trace of the
    device's activity over the whole run (a replay calls no wrapper).
    ``per_run`` gives each kernel's launches per step (fixed) or per
    attempt (adaptive): the K=1 run must show them for its steps, the
    batched run for its K replays and the capture's warm-up (one eager
    step; an adaptive one runs all its max_graph_attempts bodies). The
    batch's s/step from its replays (the batch call's time less the
    capture's) against the K=1 run's fused calls; then a 1-step batch on
    the batched run's TDVP, untraced, under torch's sync debug mode (its
    host waits, its replay's host time); one replay of the captured step
    in a profiler trace (its launches by kernel).
    ``gate_batched_trace=False``: the batched run's trace is not gated (on
    a path of tens of thousands of small kernels a run the trace slows the
    steps and once missed one record of eighteen); one replay's trace
    must show ``per_run`` exactly. ``device_counts``: {kernel: a function
    returning the kernel's own count of its launches on the device}: both
    runs must show ``per_run`` in it exactly, and the batched run is
    traced, its trace's count reported beside the kernel's."""
    t_path = time.perf_counter()
    runs = {}
    device_counts = device_counts or {}
    for k in (1, K):
        _zero_counts()
        with _Kept() as kept:
            got = []

            def run():
                got.append(driver.run(dataclasses.replace(
                    cfg, steps_per_dispatch=k, verbose=False), max_steps=K))

            dev0 = {name: f() for name, f in device_counts.items()}
            if k == 1:
                run()
                launches = _counts()
            elif gate_batched_trace or device_counts:
                t0 = time.perf_counter()
                launches, _, wall = _trace(run)
                trace_s = time.perf_counter() - t0 - wall
                sequence = _trace.sequence
            else:
                run()
                launches, trace_s = {}, 0.0
            device = {name: f() - dev0[name]
                      for name, f in device_counts.items()}
        state, rec = got[0]
        runs[k] = dict(theta=state.get_parameters(), rows=rec.as_arrays(),
                       launches=launches, device=device, kept=kept)
        if k == 1:
            kept.problems[0][1].release_graphs()
    (a1, aK) = runs[1]["rows"], runs[K]["rows"]
    th1, thK = runs[1]["theta"], runs[K]["theta"]
    diff = float((th1 - thK).abs().max())
    if set(a1) != set(aK) or len(aK["times"]) != K:
        fail(f"{label}: batched rows {sorted(aK)} ({len(aK['times'])}) "
             f"against {sorted(a1)}")
    if aK["nan"].any() or not (aK["solver_res"] < 1e-3).all():
        fail(f"{label}: NaN or residual in the batched run")
    out = dict(theta_max_diff=diff)
    if adaptive:
        same = (np.array_equal(a1["attempts"], aK["attempts"])
                and np.allclose(aK["times"], a1["times"], rtol=1e-12,
                                atol=0)
                and diff <= bar * float(th1.abs().max()))
        out.update(attempts=aK["attempts"].tolist(),
                   times=aK["times"].tolist())
        print(f"{label}: K={K} vs 1: attempts {aK['attempts'].tolist()} vs "
              f"{a1['attempts'].tolist()}, times rtol 1e-12 "
              f"{np.allclose(aK['times'], a1['times'], rtol=1e-12, atol=0)}"
              f", theta largest difference {diff:.3e} (bar {bar:g} of its "
              f"largest entry), bitwise {torch.equal(th1, thK)}")
    else:
        same = torch.equal(th1, thK) and all(
            np.array_equal(a1[k], aK[k]) for k in a1)
        print(f"{label}: K={K} vs 1: theta and rows bit for bit {same} "
              f"(largest theta difference {diff:.3e})")
    if not same:
        fail(f"{label}: the batched run is not the per-step run")
    kept = runs[K]["kept"]
    state, tdvp, stepper = kept.problems[0][:3]
    name, prog = next(iter(tdvp._programs.items()))
    # the launches each run must show: per step (fixed) or per attempt
    if adaptive:
        units = {1: int(a1["attempts"].sum()),
                 K: tdvp.max_graph_attempts + int(aK["attempts"].sum())}
    else:
        units = {1: K, K: K + 1}
    for k in (1, K) if gate_batched_trace else (1,):
        want = {n: v * units[k] for n, v in per_run.items()}
        if any(runs[k]["launches"][n] != v for n, v in want.items()):
            fail(f"{label}: the K={k} run launched {runs[k]['launches']}, "
                 f"expected {want}" + (f"; its trace in start order: "
                                      f"{sequence}" if k == K else ""))
    for k in (1, K):
        want = {n: per_run[n] * units[k] for n in device_counts}
        if runs[k]["device"] != want:
            fail(f"{label}: the K={k} run's kernels counted "
                 f"{runs[k]['device']} launches on the device, expected "
                 f"{want}")
    for n in device_counts:
        seen, made = runs[K]["launches"][n], runs[K]["device"][n]
        print(f"{label}: K={K} run: {made} launches of {n} counted on the "
              f"device, {seen} in the trace of the device's activity"
              + ("" if seen == made else
                 f" (the trace lost {made - seen} records)"))
    step_s = kept.calls["adaptive_multi" if adaptive else "heun_multi"][0]
    # the per-step run's fused calls (an adaptive step's attempts summed)
    per_step = sum(sum(v) for k, v in runs[1]["kept"].calls.items())
    # without the first call, which pays the process's first use of the
    # path (a fixed step is one call)
    later = [v for c in runs[1]["kept"].calls.values() for v in c[1:]]
    out.update(per_step_s_after_first=(sum(later) / len(later) if later
                                       and not adaptive else None))
    out.update(capture_s=prog.capture_s, pool_mb=prog.pool_bytes / 2**20,
               sites=len(prog.sites), launches=runs[K]["launches"],
               device_launches=runs[K]["device"],
               launches_per_step_run=runs[1]["launches"],
               first_batch_s=step_s, per_step_s=per_step / K,
               trace_overhead_s=trace_s,
               # slots past the captured attempts, finished on the host
               host_finished=tdvp.host_finished)
    ts, dts, keys = _batch_inputs(cfg, K)
    th0 = kept.theta0[0]
    if adaptive:
        t_eps = 1e-12 * max(1.0, abs(cfg.t_end))
        kind = "rk23" if cfg.stepper == "adaptive_rk23" else "heun"

        def batch():
            return tdvp.adaptive_multi(
                th0, 0.0, cfg.dt0, cfg.dt0, keys[:1], cfg.t_end, t_eps,
                stepper.tolerance, stepper.maxStep, kind=kind,
                exact=cfg.exact_t_end)
    else:
        kind = "rk3" if cfg.stepper == "fixed_rk3" else "heun"

        def batch():
            return tdvp.heun_multi(th0, ts[:1], dts[:1], keys[:1], kind=kind)
    host_us = []
    replay = graphs.Program.replay

    def timed(prog, root):
        t0 = time.perf_counter()
        replay(prog, root)
        host_us.append(1e6 * (time.perf_counter() - t0))

    torch.cuda.synchronize()
    graphs.Program.replay = timed
    try:
        sites = _host_wait_count(batch)
    finally:
        graphs.Program.replay = replay
    torch.cuda.synchronize()
    out.update(host_waits_per_batch=len(sites), wait_sites=sites,
               replay_host_us=host_us)
    def traced_replay():
        if adaptive:
            # from the batch's start: the first step, with its retry
            tdvp._start_batch(prog.buffers, th0, 0.0, cfg.dt0, cfg.dt0,
                              None)
        return _trace(lambda: prog.replay(keys[0]))

    counts, busy, wall = traced_replay()
    if not adaptive and any(counts[n] != v for n, v in per_run.items()):
        # the profiler can drop a record of a long replay (one Jacobi
        # launch of M3's 51 once), never add one: a second trace, and each
        # kernel's count the larger of the two
        again = traced_replay()[0]
        print(f"{label}: one replay's trace read {counts}, a second "
              f"{again}; the larger count of each kernel stands")
        out.update(replay_launches_traces=[counts, again])
        counts = {n: max(v, again[n]) for n, v in counts.items()}
    out.update(replay_launches=counts, replay_device_busy=busy,
               replay_wall_s=wall)
    if not gate_batched_trace and not adaptive and any(
            counts[n] != v for n, v in per_run.items()):
        fail(f"{label}: one replay launched {counts}, expected {per_run}")
    per_step_b = (step_s - prog.capture_s) / K
    out.update(batched_s_per_step=per_step_b)
    print(f"{label}: capture {prog.capture_s:.2f} s (warm-up included), "
          f"pool {out['pool_mb']:.1f} MB, {len(prog.sites)} draw sites; "
          f"replay host {' '.join(f'{v:.0f}' for v in host_us)} us; one "
          f"replay's launches {counts}, device busy {100 * busy:.1f}% of "
          f"its {wall:.3f} s; host waits in a 1-step batch {len(sites)} "
          f"{sites}; s/step batched {per_step_b:.4f} (the capture aside, "
          f"{'traced' if gate_batched_trace else 'untraced'}) against "
          f"per-step {out['per_step_s']:.4f} (after the first call "
          f"{out['per_step_s_after_first'] or float('nan'):.4f}); slots "
          f"finished on the host {tdvp.host_finished}; launches: the K={K} "
          f"run's trace {runs[K]['launches']} (trace overhead "
          f"{trace_s:.1f} s), the K=1 run {runs[1]['launches']}")
    tdvp.release_graphs()
    out["seconds"] = time.perf_counter() - t_path
    print(f"{label}: {out['seconds']:.1f} s")
    return out


def _mcmc_path(label, name, K):
    """M4: K fixed Heun steps of an MCMC preset through TDVP.heun_multi
    (its 2-D grid keeps the driver per step), the graph against the eager
    heun_multi on the same keys (bit for bit) and against K heun_pair
    calls (fluidpaper's independence chain: bit for bit; doubleWell's
    random walk adapts its scale after each call, once per batch here);
    the batch's s/step graphed and eager, and the device's busy share
    over one step, graphed and per step."""
    from unittest import mock

    t_path = time.perf_counter()
    cfg = preset(name, device="cuda")
    build_s = []

    def fresh():
        t0 = time.perf_counter()
        out = driver.build_problem(cfg)[:3]
        build_s.append(time.perf_counter() - t0)
        return out

    state, tdvp, stepper = fresh()
    ts, dts, keys = _batch_inputs(cfg, K)
    theta = state.get_parameters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    th_g, aux_g = tdvp.heun_multi(theta, ts, dts, keys)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    prog = tdvp._programs[("multi", "heun")]
    state_e, tdvp_e, _ = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(TDVP, "graphs_available",
                           new=property(lambda self: False)):
        th_e, aux_e = tdvp_e.heun_multi(theta, ts, dts, keys)
    torch.cuda.synchronize()
    # the eager batch runs the per-step loop's work: its s/step
    per = (time.perf_counter() - t0) / K
    same_e = torch.equal(th_g, th_e) and all(
        torch.equal(aux_g[k].cpu(), aux_e[k].cpu()) for k in aux_g)
    state_p, tdvp_p, _ = fresh()

    def per_step(n):
        y = theta.clone()
        for t, dt, k in zip(ts[:n], dts[:n], keys[:n]):
            dy, _ = tdvp_p.heun_pair(y, t, dt, k)
            y = y + dy
        return y

    diff = None
    if name == "fluidpaper":
        # the independence chain adapts nothing: K heun_pair calls are the
        # batch bit for bit (doubleWell's walk adapts after every call)
        diff = float((per_step(K) - th_g).abs().max())
    # the device's busy share over one step, per step and graphed
    t0 = time.perf_counter()
    _, busy_p, _ = _trace(lambda: per_step(1))
    _, busy_g, _ = _trace(lambda: tdvp.heun_multi(theta, ts[:1], dts[:1],
                                                   keys[:1]))
    trace_s = time.perf_counter() - t0
    batched = (first - prog.capture_s) / K
    out = dict(graph_vs_eager_bitwise=same_e, vs_per_step_max_diff=diff,
               capture_s=prog.capture_s, pool_mb=prog.pool_bytes / 2**20,
               first_batch_s=first, batched_s_per_step=batched,
               per_step_s=per, busy_graphed=busy_g, busy_per_step=busy_p,
               build_s=build_s, traces_s=trace_s)
    print(f"{label}: graph vs eager heun_multi bit for bit {same_e}; vs "
          f"{K} heun_pair calls largest theta difference {diff}; "
          f"capture {prog.capture_s:.2f} s, pool {out['pool_mb']:.1f} MB; "
          f"batched {batched:.4f} s/step (the capture aside) vs eager "
          f"{per:.4f}; device busy over one step {100 * busy_g:.1f}% "
          f"graphed vs {100 * busy_p:.1f}% per step (the two traces "
          f"{trace_s:.1f} s); problems built in "
          f"{' '.join(f'{v:.1f}' for v in build_s)} s")
    if not same_e or (name == "fluidpaper" and diff != 0.0):
        fail(f"{label}: the graphed batch is not the eager one")
    tdvp.release_graphs()
    out["seconds"] = time.perf_counter() - t_path
    print(f"{label}: {out['seconds']:.1f} s")
    return out


def phase_multistep():
    """Phase M: --steps-per-dispatch as CUDA graphs (M1-M4)."""
    if _watch_profilers.first is not None:
        fail(f"phase M: a profiler session started before its traces, "
             f"whose kernel records it would then misname and miscount:\n"
             f"{_watch_profilers.first}")
    t0 = time.perf_counter()
    out = {}
    fp = preset("fokkerPlanck32", device="cuda")
    heun = {"persample": 2, "jacobi": 2}
    out["M1 heun"] = _graph_path("M1 fokkerPlanck32 fixed_heun", fp, M_K,
                                 heun)
    out["M1 rk3"] = _graph_path(
        "M1 fokkerPlanck32 fixed_rk3", dataclasses.replace(
            fp, stepper="fixed_rk3"), M_K, {"persample": 3, "jacobi": 3})
    out["M1 syrk"] = _graph_path(
        "M1 fokkerPlanck32 fixed_heun --gram-backend syrk",
        dataclasses.replace(fp, gram_backend="syrk"), M_K,
        dict(heun, syrk=4))
    for kind, K, per in (("adaptive_heun", M_K, 5),
                         ("adaptive_rk23", M2_RK23_K, 4)):
        out[f"M2 {kind}"] = _graph_path(
            f"M2 fokkerPlanck32 {kind} tol 2e-5", dataclasses.replace(
                fp, stepper=kind, tol=2e-5), K,
            {"persample": per, "jacobi": per}, adaptive=True, bar=1e-6)
    retried = [a for k in ("M2 adaptive_heun", "M2 adaptive_rk23")
               for a in out[k]["attempts"]]
    if max(retried) < 2:
        fail("M2: no retry in the adaptive batches")
    out["M3"] = _graph_path(
        "M3 fokkerPlanck32 N=524288 chunked tri2+int8 fixed_heun",
        dataclasses.replace(fp, n_samples_tdvp=524288, n_samples_obs=524288,
                            chunk_size=65536, gram_backend="tri2",
                            gram_cross="int8"), M3_K,
        dict(heun, persample_split=16, quant8=32))
    out["M4 fluidpaper"] = _mcmc_path("M4 fluidpaper", "fluidpaper", M_K)
    out["M4 doubleWell"] = _mcmc_path("M4 doubleWell", "doubleWell",
                                      M4_DW_K)
    for key in ("M1 heun", "M1 rk3", "M1 syrk", "M2 adaptive_heun",
                "M2 adaptive_rk23", "M3"):
        if out[key]["host_waits_per_batch"] > 1:
            fail(f"{key}: {out[key]['host_waits_per_batch']} host waits in "
                 f"one batch")
    want = {"M1 heun": heun, "M1 rk3": {"persample": 3, "jacobi": 3},
            "M1 syrk": dict(heun, syrk=4),
            "M2 adaptive_heun": {"persample": 5 * out["M2 adaptive_heun"][
                "attempts"][0]},
            "M3": dict(heun, persample_split=16, quant8=32)}
    for key, w in want.items():
        got = out[key]["replay_launches"]
        if any(got[k] != v for k, v in w.items()):
            fail(f"{key}: one replay launched {got}, expected {w}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase M: {out['seconds']:.1f} s")
    return out


def phase_oracles():
    """Phase L (L1-L7); returns its record and the per-sample and
    Metropolis kernels' launches on its paths."""
    dev = torch.device("cuda")
    _h5_stand_in()  # L4 writes infos.hdf5 and reads it back through it
    root = tempfile.mkdtemp(prefix="chip_smoke_l_")
    t0 = time.perf_counter()
    out = {}
    try:
        oracle_infos, out["L1"] = phase_oracle_d32(dev)
        out["L2"] = phase_model_d32(oracle_infos)
        out["L3"], cloud = phase_oracle_fluidpaper(dev)
        out["L4"] = phase_oracle_cli_workdir(root)
        out["L5"] = phase_oracle_double_well(dev)
        out["L6"] = phase_radial(dev)
        out["L7"] = phase_sanity_plots_examples(dev, cloud)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase L: {out['seconds']:.1f} s")
    return out, {
        "persample": {"L2 evolve_d32_fp's RunConfig N=16384 (48 steps)":
                      out["L2"]["launches"]},
        "metropolis": {"L3 python -m vmc_pde_torch.oracle fluidpaper "
                       "(the cloud)": out["L3"]["launches"]}}


# -- phase S: the accuracy studies (vmc_pde_torch/studies/) on the card at
# the JAX scripts' default widths and sizes, through the modules' functions

# the JAX package's record of accuracy_d8 --qmc --steps-per-dispatch 8,
# seed 1, f32 (results/accuracy_d8_qmc.jsonl): the fixed-Heun ramp is
# deterministic, so the port takes the same steps to the same t
D8_STEPS, D8_T_FINAL = 541, 5.0044
# the largest f32 Gauss entropy error scripts/accuracy_d8.py's docstring
# reports
D8_GAUSS_MAX_ERR = 0.118
# the bars of streaming against direct minSR, relative to the direct
# trajectory's change of theta: in f64 tests/test_torch_solvers.py's
# 2e-4; in f32 MINSR_ORDER_FACTOR times the order control's reading, two
# direct runs on the same draws in two sample orders (rounding alone):
# a right streaming assembly only sums in another order too
MINSR_STREAM_RTOL_F64 = 2e-4
MINSR_ORDER_FACTOR = 4.0
# the JAX package's runs in results/ under the same checks (scripts/
# check_aniso.py on aniso_d12_tpu.hdf5; scripts/check_fp6.py on
# fp6_tpu.hdf5 at 60000 particles, on a CPU), for the record beside the
# port's
JAX_ANISO_WORST = 0.0559
JAX_FP6 = {"max_mean_diff": 0.0378, "max_rel_covdiag_diff": 0.0280}


def _study(label, fn):
    """fn() with the launch counters at 0; returns (its result, its
    seconds, the wrappers' launches, with ``jacobi_blocks_device`` the
    block variant's solves counted by the kernel on the device, graph
    replays included)."""
    _zero_counts()
    before = jacobi.block_solves_on_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(_counts(), jacobi_blocks_device=(
        jacobi.block_solves_on_device() - before))
    print(f"{label}: {sec:.1f} s, kernel launches {counts}")
    return out, sec, counts


def _no_nan(label, record):
    """Fail where a study's recorded arrays or numbers hold a NaN."""
    bad = []
    for k, v in record.items():
        if isinstance(v, dict):
            _no_nan(f"{label} {k}", v)
            continue
        a = np.asarray(v)
        if k == "nan":
            if a.any():
                bad.append(k)
        elif a.dtype.kind == "f" and not np.isfinite(a).all():
            bad.append(k)
    if bad:
        fail(f"{label}: NaN or inf in {bad}")


def phase_studies():
    """Phase S: S1 northstar_l2 at its defaults (mwe, f64, N=10^4, t_end
    1, the 501^2 grid), L2 <= 1e-5; S2 make_paper_figures.regenerate_runs:
    accuracy_d8 Gauss and Student-t at N=10^4, t_end 5, K=8, --qmc (541
    steps to t = 5.0044 each, the Gauss entropy error at most 0.118), then
    the fp6 heat chain (harmonicOsc_diff at T = (10, 5, 2.5), coupled, the
    sphere integrals, K=8, t_end 5); S3 check_fp6 at 60000 particles on
    the heat chain (its drift) and on harmonicOsc_diff at the preset's
    T = 10 to t_end 0.5, the JAX package's fp6_tpu.hdf5 run; S4
    diffusion_anisotropic (d=12) to t_end 0.5 at K=8, then check_aniso;
    S5 evolve_minsr_largep at its defaults (P = 18,604, N = 4096, minSR,
    the per-sample kernel in plain mode) with --chunk 1024 on its first 3
    steps, within MINSR_ORDER_FACTOR times the order control's gap (two
    direct runs on one set of draws in two orders), and the first 2 of
    them again in f64 within MINSR_STREAM_RTOL_F64 of the direct ones; S6
    make_paper_figures' collection, without drawing (its grid oracle to
    t_end 0.5, phase L6's cut), and the entropy lag of S2's Student-t
    curve against that grid over its span. No study may record a NaN. Returns its record and the
    kernels' launches by path."""
    from vmc_pde_torch.studies import (check_aniso, check_fp6,
                                       evolve_minsr_largep,
                                       make_paper_figures, northstar_l2)

    dev = torch.device("cuda")
    _h5_stand_in()  # the fp6 run writes infos.hdf5 (S6 takes its infos)
    root = tempfile.mkdtemp(prefix="chip_smoke_s_")
    run_dir = os.path.join(root, "runs")
    t0 = time.perf_counter()
    out, paths = {}, {"persample": {}, "jacobi": {}, "jacobi_blocks": {}}
    try:
        args = northstar_l2.parse_args([])

        def northstar():
            state, rec = driver.run(northstar_l2.make_config(args))
            return northstar_l2.evaluate(state, args), rec.as_arrays()

        (rec, infos), sec, counts = _study("S1 northstar_l2", northstar)
        print(json.dumps(rec))
        _no_nan("S1", dict(rec, **infos))
        if not rec["L2"] <= northstar_l2.TARGET:
            fail(f"S1: L2 {rec['L2']:.3e} > {northstar_l2.TARGET}")
        out["S1"] = dict(rec, seconds=sec, steps=len(infos["times"]))
        paths["jacobi"]["S1 northstar_l2 (mwe, f64, one-block eigh)"] = \
            counts["jacobi"]

        runs, sec, counts = _study(
            "S2 make_paper_figures.regenerate_runs",
            lambda: make_paper_figures.regenerate_runs(run_dir,
                                                       device=dev))
        out["S2"] = {"seconds": sec}
        for name in ("d8_gauss", "d8_student"):
            rec, infos = runs[name]
            # Student-t has no closed form: its entropy errors are NaN
            _no_nan(f"S2 {name}", dict(infos, **{
                k: v for k, v in rec.items()
                if name == "d8_gauss" or not k.startswith("entropy_err")}))
            if (rec["steps"], round(rec["t_final"], 4)) != (D8_STEPS,
                                                             D8_T_FINAL):
                fail(f"S2 {name}: {rec['steps']} steps to "
                     f"{rec['t_final']}, the JAX record's {D8_STEPS} to "
                     f"{D8_T_FINAL}")
            out["S2"][name] = rec
        err = out["S2"]["d8_gauss"]["entropy_err_max"]
        if not err <= D8_GAUSS_MAX_ERR:
            fail(f"S2: Gauss entropy error {err} > {D8_GAUSS_MAX_ERR}")
        fp6 = runs["fp6"]
        _no_nan("S2 fp6", fp6)
        out["S2"]["fp6"] = dict(steps=len(fp6["times"]),
                                t_final=float(fp6["times"][-1]),
                                entropy_final=float(fp6["entropy"][-1]))
        print(f"S2 fp6 heat chain: {json.dumps(out['S2']['fp6'])}")
        paths["jacobi_blocks"][
            "S2 regenerate_runs: accuracy_d8 Gauss and Student-t (P=684, "
            "K=8 graphs), fp6 heat chain (P=411, K=8), the kernel's own "
            "count"] = counts["jacobi_blocks_device"]

        fp6_check, sec, _ = _study(
            "S3 check_fp6 --heat-chain, 60000 particles",
            lambda: check_fp6.check(fp6, 60000, heat_chain=True,
                                    device=dev))
        out["S3"] = {"heat_chain": dict(fp6_check, seconds=sec)}

        def preset_fp6():
            cfg = preset("harmonicOsc_diff", t_end=0.5, steps_per_dispatch=8,
                         verbose=False, device="cuda")
            infos = driver.run(cfg)[1].as_arrays()
            return infos, check_fp6.check(infos, 60000, device=dev)

        (infos, rec), sec, counts = _study(
            "S3 harmonicOsc_diff t_end 0.5, check_fp6 60000 particles",
            preset_fp6)
        _no_nan("S3", dict(infos, **rec))
        out["S3"]["preset"] = dict(rec, seconds=sec, steps=len(
            infos["times"]), jax_fp6_tpu=JAX_FP6)
        paths["jacobi_blocks"]["S3 harmonicOsc_diff t_end 0.5 (P=411, "
                               "K=8), the kernel's own count"] = \
            counts["jacobi_blocks_device"]

        def aniso():
            cfg = preset("diffusion_anisotropic", t_end=0.5,
                         steps_per_dispatch=8, verbose=False, device="cuda")
            infos = driver.run(cfg)[1].as_arrays()
            return infos, check_aniso.report(infos, 12, 0, dev)

        (infos, rec), sec, counts = _study(
            "S4 diffusion_anisotropic t_end 0.5, check_aniso", aniso)
        _no_nan("S4", dict(infos, **rec))
        out["S4"] = dict(rec, seconds=sec, jax_aniso_d12_tpu=JAX_ANISO_WORST)
        paths["jacobi_blocks"]["S4 diffusion_anisotropic t_end 0.5 (P=762, "
                               "K=8), the kernel's own count"] = \
            counts["jacobi_blocks_device"]

        rec, sec, counts = _study(
            "S5 evolve_minsr_largep --chunk 1024",
            lambda: evolve_minsr_largep.main(["--chunk", "1024"]))
        _no_nan("S5", rec)
        if rec["per_sample"] != "cuda" or counts["persample"] == 0:
            fail(f"S5: the RHS took {rec['per_sample']} with "
                 f"{counts['persample']} kernel launches, not the kernel")
        rel = {"tpu": [d / m for d, m in zip(
            rec["chunked_vs_direct_max_dtheta"], rec["direct_max_dtheta"])]}
        # the control in f32: the same steps of two direct runs on the
        # same draws, in two sample orders
        args = evolve_minsr_largep.parse_args(["--chunk", "1024"])
        args.device = dev
        (diffs, moves), sec_c, counts_c = _study(
            "S5 the order control in f32",
            lambda: evolve_minsr_largep.order_control(args))
        control = [d / m for d, m in zip(diffs, moves)]
        # the same replay in f64 (torch.func, no kernel): the streaming
        # assembly's own error, without f32's rounding
        args = evolve_minsr_largep.parse_args(["--chunk", "1024",
                                               "--chunk-steps", "2",
                                               "--precision", "f64"])
        args.device = dev
        (diffs, moves), sec64, _ = _study(
            "S5 the chunked replay in f64",
            lambda: evolve_minsr_largep.chunked_vs_direct(args))
        rel["f64"] = [d / m for d, m in zip(diffs, moves)]
        bars = {"tpu": MINSR_ORDER_FACTOR * max(control),
                "f64": MINSR_STREAM_RTOL_F64}
        print(f"S5 chunked vs direct, max |dtheta| over the direct step's "
              f"change: {json.dumps(rel)}; the f32 order control "
              f"{json.dumps(control)}; bars {json.dumps(bars)}")
        for prec, r in rel.items():
            if not max(r) <= bars[prec]:
                fail(f"S5: chunked minSR off the direct one by {r} of the "
                     f"step in {prec} (bar {bars[prec]})")
        out["S5"] = dict(rec, seconds=sec, chunked_vs_direct_rel=rel,
                         order_control_rel=control, bars=bars,
                         order_control_seconds=sec_c,
                         f64_replay_seconds=sec64,
                         launches=counts["persample"])
        paths["persample"][
            f"S5 evolve_minsr_largep (P={rec['P']}, N={rec['N']}, minSR, "
            f"{rec['steps']} steps, then 3 + 3 steps of the chunked "
            "replay)"] = counts["persample"]
        paths["persample"][
            "S5 the order control (3 + 3 direct steps on the same draws)"
        ] = counts_c["persample"]

        def collect():
            curves = make_paper_figures.collect_diffusion_curves(
                None, run_dir, grid_t_end=0.5, device=dev)
            inn, wiener = make_paper_figures.collect_phasespace_runs(
                None, run_dir, device=dev, own=runs["fp6"])
            return curves, inn, wiener, make_paper_figures.ness_state()

        (curves, inn, wiener, ness), sec, _ = _study(
            "S6 make_paper_figures collection", collect)
        labels = [c[0] for c in curves]
        if len(curves) != 3 or len(inn) != 1 or len(wiener) != 1:
            fail(f"S6: collected {labels}, {len(inn)} flow run(s) and "
                 f"{len(wiener)} oracle(s); expected 3 curves, 1 and 1")
        for label, _, data in curves + inn + wiener:
            _no_nan(f"S6 {label}", data)
        # the Student-t curve's entropy lag over the grid's span
        grid, student = curves[-1][2], curves[0][2]
        lag = np.interp(grid["times"], student["times"],
                        student["entropy"]) - grid["entropy"]
        print(f"S6 d8 Student-t (S2) vs the grid oracle over t <= "
              f"{grid['times'][-1]:.2f}: max |lag| {np.abs(lag).max():.4f},"
              f" lag at the end {lag[-1]:+.4f}")
        out["S6"] = dict(seconds=sec, curves=labels,
                         grid_entropy=[float(grid["entropy"][0]),
                                       float(grid["entropy"][-1])],
                         ness_entropy=float(ness[1]),
                         student_max_abs_lag=float(np.abs(lag).max()),
                         student_lag_end=float(lag[-1]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase S: {out['seconds']:.1f} s")
    return out, paths


# Phase W: the per-sample kernel on flows past dim 64, halves of 32,
# widths of 64 and four linear layers, each a fokkerPlanck32 preset with
# these arguments changed (the JAX package runs its Pallas kernel on every
# one: ``auto`` on the first four at f32 and 2048 <= P <= 32768,
# ``pallas`` when forced on the others), and SanityFlow
WIDE = {
    "A d=128 depth 2 hidden 16": dict(dim=128, offset=(0.0,) * 128, depth=2,
                                      hidden=(16,)),
    "d=96 depth 4 hidden 16": dict(dim=96, offset=(0.0,) * 96, depth=4,
                                   hidden=(16,)),
    "B five linear layers": dict(hidden=(16,) * 4),
    "width 96": dict(depth=2, hidden=(96,)),
    "bench_persample d=128 depth 4 hidden 64": dict(
        dim=128, offset=(0.0,) * 128, depth=4, hidden=(64,)),
    "A Student-t + global affine": dict(
        dim=128, offset=(0.0,) * 128, depth=2, hidden=(16,),
        latent_name="Student_t", global_affine=True),
    "SanityFlow d=4": dict(dim=4, offset=(0.0,) * 4),
}
W_K = 4  # A's steps, one at a time and as one graphed batch
W_ROWS = 512  # rows of a W_N launch held against the plain version
W_N = 16384  # the main path's N, where the kernel is timed and checked
W_SAME_N = 2048  # where the kernel and torch.func are timed side by side


def _wide_flow(label, dev):
    """(flow, initial theta, directions) of a WIDE entry (any other label:
    the preset's own): the preset's flow as build_problem makes it, or
    SanityFlow with its scale at 1.3, with the preset's trace directions
    at its dim."""
    from vmc_pde_torch.models.sanity import SanityFlow

    cfg = preset("fokkerPlanck32", **WIDE.get(label, {}))
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    if label.startswith("SanityFlow"):
        flow = SanityFlow(cfg.dim)
        theta = torch.as_tensor(flow.layout.ravel(flow.init()),
                                dtype=torch.float32, device=dev)
        theta[flow.layout.offset(("scale",))] = 1.3
        return flow, theta, dirs
    flow, theta = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, out_scale=cfg.init_scale,
                             latent_name=cfg.latent_name,
                             global_affine=cfg.global_affine,
                             offset=cfg.offset, dtype=torch.float32,
                             device=dev)
    return flow, theta, dirs


def _tile_rows(plan, n, rows=W_ROWS):
    """About ``rows`` rows of an n-sample launch under ``plan`` (an index
    tensor): whole tiles of blocks spread over its grid, up to 4 tiles of
    each (b, b + grid, b + 2 grid, ...), so that a block that runs several
    tiles is held on its later tiles too."""
    n_tiles = -(-n // plan.T)
    m = min(-(-n_tiles // plan.grid), 4)
    blocks = np.unique(np.linspace(0, plan.grid - 1,
                                   max(1, rows // (m * plan.T))).round())
    tiles = sorted(t for b in blocks.astype(int)
                   for t in range(b, n_tiles, plan.grid)[:m])
    return torch.as_tensor(np.concatenate([
        np.arange(t * plan.T, min((t + 1) * plan.T, n)) for t in tiles]))


def _wide_check(flow, theta, x, dirs, got, shift, where, rows=None,
                modes=("plain", "split")):
    """W3's check of the kernel's outputs ``got`` ({mode: the outputs of a
    launch on all of x}, split mode's for ``shift``) on ``rows`` of x (all
    of them: None) against the plain pipeline in f64 on those rows, in
    chunks of W_SAME_N: each sample's largest error relative to the
    output's largest reference value, to TOL (the split pair to TOL plus
    its dropped residual 2^-16); on all rows, where the kernel misses TOL,
    as phase 15 grades (_graded: plain f32 must miss it too, the
    quantiles GRADE_Q within twice plain f32's, the largest within
    GRADE_MAX times). Returns {mode: the largest abs error of O (split:
    of hi + lo)}."""
    idx = (torch.arange(x.shape[0]) if rows is None else rows).to(x.device)
    th64, d64 = theta.double(), dirs.double()
    names = {mode: ("logp", "g", "quad", "O" if mode == "plain" else "hi+lo")
             for mode in modes}
    errs = {(mode, name): ([], [], 0.0) for mode in modes
            for name in names[mode]}

    def pair(o):
        hi, lo = stats._split_bf16(o - shift)
        return hi.double() + lo.double()

    for c in range(0, len(idx), W_SAME_N):
        ic = idx[c:c + W_SAME_N]
        ref = persample.per_sample_plain(flow, th64, x[ic].double(), d64)
        p32 = persample.per_sample_plain(flow, theta, x[ic], dirs)
        for mode in modes:
            a = [v[ic] for v in got[mode][:3]]
            r, p = list(ref[:3]), list(p32[:3])
            if mode == "plain":
                a.append(got[mode][3][ic])
                r.append(ref[3])
                p.append(p32[3])
            else:
                hi, lo = got[mode][3]
                a.append(hi[ic].double() + lo[ic].double())
                r.append(ref[3] - shift.double())
                p.append(pair(p32[3]))
            if mode == "plain" and c == 0 and rows is not None:
                _print_rows(where, len(ic), a[3], r[3], p[3],
                            _row_groups(flow))
            for name, av, rv, pv in zip(names[mode], a, r, p):
                if av.shape != rv.shape or not torch.isfinite(av).all():
                    fail(f"{where}, {mode} mode {name}: shape "
                         f"{tuple(av.shape)} vs {tuple(rv.shape)}, or not "
                         f"finite")
                ek, ep, top = errs[mode, name]
                for v, out in ((av, ek), (pv, ep)):
                    e = (v.double() - rv).abs()
                    out.append(e if e.ndim == 1 else e.amax(1))
                errs[mode, name] = (ek, ep, max(top, float(rv.abs().max())))
        del ref, p32
    worst = {}
    for (mode, name), (ek, ep, top) in errs.items():
        ek, ep = torch.cat(ek), torch.cat(ep)
        worst[mode] = float(ek.max())
        ek, ep = ek / max(top, 1.0), ep / max(top, 1.0)
        rel, rel32 = float(ek.max()), float(ep.max())
        tol = TOL["O"] + 2**-16 if name == "hi+lo" else TOL[name]
        here = (f"{'split ' if mode == 'split' else ''}kernel vs plain, "
                f"{where}, {len(idx)} rows")
        print(f"{here}, {name}: relative {rel:.3e} (tol {tol:.1e}; plain "
              f"f32 {rel32:.3e})")
        if rel < tol:
            continue
        if rows is not None or rel32 < tol or not _graded(name, ek, ep, tol,
                                                           here):
            fail(f"{here}: kernel {name} disagrees with the plain version: "
                 f"{rel:.3e}")
    return worst


def _wide_columns(flow, theta, x, dirs, shift, got, where):
    """Split mode's column sums and max |O - shift| of a launch on all of
    x against plain f32's, its O in chunks of W_SAME_N (sums in f64): the
    sums to TOL of each column's sum of |O - shift| plus the largest (a
    tile dropped or counted twice moves a sum by about T/N of its mass),
    the max to TOL of the largest."""
    P = flow.layout.size
    csum = torch.zeros(P, dtype=torch.float64, device=x.device)
    cabs = torch.zeros_like(csum)
    cmax = torch.zeros(P, device=x.device)
    for c in range(0, x.shape[0], W_SAME_N):
        o = persample.per_sample_plain(flow, theta, x[c:c + W_SAME_N],
                                       dirs)[3] - shift
        csum += o.double().sum(0)
        cabs += o.double().abs().sum(0)
        cmax = torch.maximum(cmax, o.abs().amax(0))
        del o
    o_scale = cmax.double().max().clamp_min(1.0)
    for name, a, r, scale in (("colsum", got[4], csum, cabs + o_scale),
                              ("colmax", got[5], cmax, o_scale)):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"{where}, split {name}: shape {tuple(a.shape)}, or not "
                 f"finite")
        rel = float(((a.double() - r.double()).abs() / scale).max())
        print(f"split kernel vs plain f32, {where}, {name} over all "
              f"{x.shape[0]} rows: relative {rel:.3e} (tol {TOL['O']:.1e})")
        if not rel < TOL["O"]:
            fail(f"{where}: split kernel {name} disagrees with plain f32's "
                 f"over all rows: {rel:.3e}")


def _wide_kernel(label, dev):
    """W3 on one flow, at the main path's N = W_N in both modes, each with
    the wrapper's own plan. On the initial theta and draws pushed through
    the flow: the kernel timed (bound and share), and the timed call then
    held against its plain version to TOL on W_ROWS rows of whole tiles
    from blocks across the grid (_tile_rows: a block's later tiles too,
    where it runs several), and split mode's column sums and max over all
    W_N rows against plain f32's (_wide_columns; the shift, in both
    modes' timing too, the plain f32 mean O of the first W_SAME_N rows).
    At a perturbed theta (output weights +-0.03) on W_N standard normal x
    (pushed through these flows a few x reach samples where f32 keeps no
    digit): both modes on all W_N rows, to TOL or, where the kernel
    misses it, graded as phase 15 grades (_wide_check). Then the kernel at
    W_SAME_N beside torch.func (plain, and plain + split), which it must
    beat."""
    flow, theta0, dirs = _wide_flow(label, dev)
    if not persample.supports(flow, dirs, None):
        fail(f"W3 {label}: supports refuses the flow")
    gen = torch.Generator(device=dev).manual_seed(18)
    perturbed = perturb_theta(flow, theta0, np.random.default_rng(18),
                              out_scale=0.03)
    if label.startswith("SanityFlow"):
        perturbed[flow.layout.offset(("scale",))] = 0.8
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {mode: persample.tile_plan(flow, k, W_N, n_sm, mode == "split")
             for mode in ("plain", "split")}
    out = dict(P=P, k=k, plan=tuple(plans["plain"]),
               split_plan=tuple(plans["split"]), max_abs_err=0.0,
               split_max_abs_err=0.0)
    layers, n_ga = bounds.flow_layers(flow), bounds.flow_ga(flow)
    reps = 10 if P < 100000 else 3
    for name, theta in (("initial", theta0), ("perturbed", perturbed)):
        params = flow.layout.unravel(theta)
        x = (flow.push(params, flow.latent_sample(gen, params, W_N,
                                                  torch.float32))[0]
             if name == "initial" else
             torch.randn((W_N, d), generator=gen, device=dev))
        where = f"W3 {label}, {name} theta, N={W_N}"
        shift = persample.per_sample_plain(flow, theta, x[:W_SAME_N],
                                           dirs)[3].mean(0)
        calls = {"plain": lambda v: persample.per_sample_cuda(
                     flow, theta, v, dirs),
                 "split": lambda v: persample.per_sample_split_cuda(
                     flow, theta, v, dirs, shift)}
        got = {}
        for mode, call in calls.items():
            if name == "initial":
                ms = _time_ms(lambda: call(x), reps)
                bound = bounds.persample(layers, d, P, W_N, k,
                                         mode == "split", n_ga)
                out[mode] = dict(ms=ms, bound_ms=bound[0],
                                 bound_by=bound[1],
                                 share_of_bound=bound[0] / ms)
            got[mode] = call(x)
        if name == "initial":
            # each mode on whole tiles of its own launch
            for mode in got:
                err = _wide_check(flow, theta, x, dirs, got, shift, where,
                                  _tile_rows(plans[mode], W_N), (mode,))
                key = "split_max_abs_err" if mode == "split" else \
                    "max_abs_err"
                out[key] = max(out[key], err[mode])
            _wide_columns(flow, theta, x, dirs, shift, got["split"], where)
            xs, shift0 = x[:W_SAME_N].contiguous(), shift
        else:
            err = _wide_check(flow, theta, x, dirs, got, shift, where)
            out["max_abs_err"] = max(out["max_abs_err"], err["plain"])
            out["split_max_abs_err"] = max(out["split_max_abs_err"],
                                           err["split"])
        del got
        torch.cuda.empty_cache()
    for mode, cuda, plain in (
            ("plain", lambda v: persample.per_sample_cuda(flow, theta0, v,
                                                          dirs),
             lambda v: persample.per_sample_plain(flow, theta0, v, dirs)),
            ("split", lambda v: persample.per_sample_split_cuda(
                flow, theta0, v, dirs, shift0),
             lambda v: persample.per_sample_split_plain(flow, theta0, v,
                                                        dirs, shift0))):
        ms_same = _time_ms(lambda: cuda(xs), reps)
        plain_ms = _time_ms(lambda: plain(xs), 1)
        torch.cuda.empty_cache()
        bound_same = bounds.persample(layers, d, P, W_SAME_N, k,
                                      mode == "split", n_ga)[0]
        rec = out[mode]
        print(f"W3 {label} ({mode}, P={P}, k={k}, plan "
              f"{tuple(plans[mode])}): CUDA kernel {rec['ms']:.3f} ms at "
              f"N={W_N}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}"
              f"), share {rec['share_of_bound']:.4f}; at N={W_SAME_N} "
              f"kernel {ms_same:.4f} ms against torch.func"
              f"{' + split' if mode == 'split' else ''} {plain_ms:.2f} ms "
              f"({plain_ms / ms_same:.1f}x), bound {bound_same:.4f}")
        if not ms_same < plain_ms:
            fail(f"W3 {label}: the {mode} kernel ({ms_same:.3f} ms) is not "
                 f"under torch.func ({plain_ms:.3f} ms) at N={W_SAME_N}")
        rec.update(same_n_ms=ms_same, same_n_plain_ms=plain_ms,
                   same_n_bound_ms=bound_same)
    return out


def _wide_sanity_rhs(dev):
    """One TDVP RHS with SanityFlow(dim=4) at N=16384 in f32 with
    per_sample_backend='cuda' (the kernel: one launch) on the card,
    against the CPU's (the plain version) on the same draws: the update
    within 1e-5, as L7 holds the torch.func RHS."""
    from vmc_pde_torch.models.sanity import SanityFlow
    from vmc_pde_torch.utils.dtypes import resolve

    flow = SanityFlow(4)
    params = flow.init()
    params["scale"] = np.array([1.25])
    params["latent"]["mu"] = np.array([0.1, -0.2, 0.3, 0.0])
    z = torch.randn((16384, 4), generator=_gen(dev, 9), device=dev)
    updates, out = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        theta = torch.as_tensor(flow.layout.ravel(params),
                                dtype=torch.float32, device=where)
        prec = resolve("f32")
        state = VarState(flow, theta, precision=prec,
                         sampler=sampling.Sampler(4, dtype=torch.float32))
        tdvp = TDVP(state, make_equation("diffusion", 4),
                    tdvp_mod.TDVPConfig(per_sample_backend="cuda"),
                    n_samples=16384, precision=prec)
        _zero_counts()
        aux = tdvp._rhs_impl(theta, 0.0, 0, z.to(where))
        updates[label] = aux["update"].double().cpu()
        if label == "card":
            out["launches"] = _counts()["persample"]
            if not tdvp.uses_kernel or out["launches"] != 1:
                fail(f"W3 SanityFlow: uses_kernel {tdvp.uses_kernel}, "
                     f"{out['launches']} launches, expected 1")
    out["update_card_vs_cpu"] = _rel(updates["card"], updates["cpu"])
    print(f"W3 SanityFlow(dim=4) RHS at N=16384, f32, per_sample_backend "
          f"cuda: {out['launches']} launch, card vs CPU update "
          f"{out['update_card_vs_cpu']:.2e} (1e-5)")
    if not out["update_card_vs_cpu"] <= 1e-5:
        fail(f"W3 SanityFlow: the RHS differs between card and CPU: "
             f"{out['update_card_vs_cpu']}")
    return out


def phase_wide():
    """Phase W: the per-sample kernel widened to every flow the JAX kernel
    takes. W1: A through driver.run (uses_kernel), W_K fixed-Heun steps
    one at a time and as one graphed batch (_graph_path: bit for bit,
    launches counted), then the chunked tri2 + int8 path (split and quant8
    at P=25,408); W2: B through driver.run; W3: every WIDE flow's kernel
    against its plain version and timed (_wide_kernel)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {"paths": {}, "flows": {}}
    for label in ("A d=128 depth 2 hidden 16", "B five linear layers"):
        cfg = preset("fokkerPlanck32", device="cuda", **WIDE[label])
        tdvp = driver.build_problem(cfg)[1]
        if not tdvp.uses_kernel:
            fail(f"W: {label} does not take the kernel under auto")
        del tdvp
    cfg = preset("fokkerPlanck32", device="cuda",
                 **WIDE["A d=128 depth 2 hidden 16"])
    graph = _graph_path("W1 A d=128 fixed_heun", cfg, W_K,
                        {"persample": 2, "jacobi": 2})
    out["W1"] = {k: graph[k] for k in (
        "theta_max_diff", "launches", "launches_per_step_run",
        "per_step_s", "batched_s_per_step", "capture_s", "replay_launches",
        "seconds")}
    out["paths"]["W1 A d=128 N=16384 fixed_heun, per step (4 steps)"] = \
        graph["launches_per_step_run"]["persample"]
    out["paths"]["W1 A d=128 N=16384 fixed_heun at K=4, from the batched "
                 "run's trace (the warm-up step and 4 replays)"] = \
        graph["launches"]["persample"]
    n_steps = 2
    _, _, counts = _drive(None, "W1 A d=128 N=131072 chunked tri2+int8",
                          n_steps, dim=128, cfg=dataclasses.replace(
                              cfg, n_samples_tdvp=131072,
                              n_samples_obs=131072, chunk_size=65536,
                              gram_backend="tri2", gram_cross="int8"))
    want = n_steps * 2 * 2
    if (counts["persample_split"], counts["quant8"]) != (want, 2 * want) \
            or counts["persample"] == 0:
        fail(f"W1 chunked: launches {counts}, expected {want} split, "
             f"{2 * want} quant8 and the pilots")
    out["chunked_counts"] = counts
    b_steps = 3
    _, _, counts = _drive(None, "W2 B five linear layers N=16384", b_steps,
                          cfg=preset("fokkerPlanck32", device="cuda",
                                     **WIDE["B five linear layers"]))
    if counts["persample"] != 2 * b_steps:
        fail(f"W2: {counts['persample']} launches, expected {2 * b_steps}")
    out["paths"]["W2 B five linear layers N=16384 fixed_heun (3 steps)"] = \
        counts["persample"]
    # the flows auto leaves off the kernel, forced: the P=141,504 flow in
    # its regime (minSR, N=1024 < P; its f32 Gram would take 80 GB) and
    # SanityFlow's one RHS against the CPU's
    label = "bench_persample d=128 depth 4 hidden 64"
    _, _, counts = _drive(None, f"W3 {label} minsr N=1024", 2, dim=128,
                          cfg=preset("fokkerPlanck32", device="cuda",
                                     solver_method="minsr",
                                     n_samples_tdvp=1024, n_samples_obs=1024,
                                     per_sample_backend="cuda", **WIDE[label]))
    if counts["persample"] != 4:
        fail(f"W3 {label}: {counts['persample']} launches in 2 minSR "
             f"steps, expected 4")
    out["paths"][f"W3 {label} (P=141,504) minsr N=1024, per_sample_backend "
                 f"cuda (2 steps)"] = counts["persample"]
    out["sanity_rhs"] = _wide_sanity_rhs(dev)
    out["paths"]["W3 SanityFlow d=4 one RHS, per_sample_backend cuda"] = \
        out["sanity_rhs"]["launches"]
    for label in WIDE:
        out["flows"][label] = _wide_kernel(label, dev)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase W: {out['seconds']:.1f} s")
    return out


def main():
    phase_device()
    _watch_profilers()
    full_f32_matmuls()
    dev = torch.device("cuda")
    phase_build()
    prob = _fp32_problem(dev)
    results = {"persample": phase_kernel(dev, prob)}
    split = phase_split(dev, prob)
    results["quant8"] = phase_quant8(split)
    results["persample_split"] = {
        k: split[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by")}
    del split, prob
    state, counts = phase_main_path()
    theta5 = state.get_parameters()
    launches = {"persample": counts["persample"], "jacobi": counts["jacobi"]}
    results["jacobi"], results["jacobi_blocks"] = phase_jacobi(dev)
    phase_chunked_vs_f32(state.get_parameters())
    counts = phase_chunked_path()
    launches.update(persample_split=counts["persample_split"],
                    quant8=counts["quant8"])
    phase_mwe()
    results["metropolis"] = phase_metropolis(dev)
    launches["metropolis"] = phase_var_state_sample(dev)
    phase_fluidpaper()
    phase_doublewell()
    results["syrk"] = phase_syrk(dev, state.get_parameters())
    launches["syrk"] = phase_syrk_paths(state.get_parameters())
    student = phase_student_kernel(dev)
    state, counts = phase_student_path()
    theta_student = state.get_parameters()
    paths = {"fokkerPlanck32": launches["persample"],
             "fokkerPlanck32 Student-t + global affine": counts["persample"]}
    phase_chunked_vs_f32(state.get_parameters(), syrk_too=False,
                         latent_name="Student_t", global_affine=True)
    paths["diffusion"], paths_c = phase_diffusion()
    phase_anisotropic_and_oscillators()
    steppers = phase_steppers()
    for name in ("fixed_euler", "fixed_rk3", "adaptive_heun",
                 "adaptive_rk23"):
        paths[f"fokkerPlanck32 {name}"] = steppers[name]["launches"]
    paths["fokkerPlanck32 adaptive_heun tol=2e-5 (a retry)"] = \
        steppers["adaptive_heun_retry"]["launches"]
    phase_exact_t_end_and_dispatch(steppers)
    phase_sexp_batch(theta5, theta_student, steppers)
    prod = phase_steppers_production(steppers)
    paths["fokkerPlanck32 N=524288 chunked adaptive_heun"] = \
        prod["persample"]
    phase_fluidpaper_adaptive(steppers)
    multistep = phase_multistep()
    block_paths = phase_jacobi_traced(results["jacobi"],
                                      results["jacobi_blocks"])
    # the block variant's path: the diffusion preset's eigh solve
    launches["jacobi_blocks"] = next(iter(block_paths.values()))
    wide = phase_wide()
    paths.update(wide["paths"])
    solvers, solver_paths, split_paths, q8_paths = phase_solvers(theta5)
    paths.update(solver_paths)
    qhi, qhi_paths, qhi_split, qhi_q8 = phase_qmc_hessian_integrals(
        dev, theta5)
    paths.update(qhi_paths)
    split_paths.update(qhi_split)
    q8_paths.update(qhi_q8)
    run_state, run_state_paths = phase_run_state()
    paths.update(run_state_paths)
    ranks = phase_mesh()
    for name in ("persample_sharded", "metropolis_sharded"):
        results[name] = dict(ranks[0][name])
        launches[name] = results[name].pop("launches")
        results[name]["launches_by_rank"] = [r[name]["launches"]
                                             for r in ranks]
    mesh_k = ranks[0]["mesh_k"]
    k_launches = {
        "K1 fokkerPlanck32 GSPMD dp2 x tp2 (2 steps), per rank":
            mesh_k["K1"]["counts"]["persample_sharded"],
        "K2 depth-8 flow GSPMD dp2 x tp2 (1 step), per rank":
            mesh_k["K2_auto"]["counts"]["persample_sharded"],
        "K3 chunked GSPMD dp=4 sym2+int8 N=131072 (2 steps), per rank":
            mesh_k["K3_high"]["counts"]["persample_sharded"],
        "K3 the same at f64acc (1 step), per rank":
            mesh_k["K3_f64acc"]["counts"]["persample_sharded"]}
    for label, rec in mesh_k["K4"].items():
        k_launches[f"K4 {label} (1 RHS), rank 0; by rank"] = [
            r["mesh_k"]["K4"][label]["launches"] for r in ranks]
    results["persample_sharded"]["launches_by_path"] = {
        "fokkerPlanck32 GSPMD counterpart (eloc_clip=2), per rank":
            launches["persample_sharded"], **k_launches}
    paths["fokkerPlanck32 shard_map direct, per rank"] = \
        ranks[0]["paths"]["direct"]["counts"]["persample"]
    mesh_paths = {name: {k: v for k, v in path.items() if k != "counts"}
                  for name, path in ranks[0]["paths"].items()}
    flows = ("the JAX kernel's: Gauss and Student_t latents, with and "
             "without the global affine, any dim, coupling half, "
             "conditioner width and depth, any number of coupling blocks "
             "(fokkerPlanck32 flows at P=9264 and 9397; " + ", ".join(
                 f"{label} P={rec['P']}"
                 for label, rec in wide["flows"].items()))
    scope = {"persample": flows + "; diffusion_anisotropic's)",
             "persample_split": flows + ")"}
    for name, mode in (("persample", "plain"), ("persample_split", "split")):
        results[name] = dict(
            results[name], scope=scope[name],
            student_t_global_affine=student[name],
            wide_flows={label: dict(rec[mode], P=rec["P"], k=rec["k"],
                                    plan=rec["plan" if mode == "plain"
                                             else "split_plan"])
                        for label, rec in wide["flows"].items()})
    results["persample"]["launches_by_path"] = paths
    for name, more in (("persample_split", split_paths),
                       ("quant8", q8_paths)):
        results[name]["launches_by_path"] = {
            "fokkerPlanck32 N=524288 chunked tri2+int8 fixed_heun":
                launches[name],
            "fokkerPlanck32 N=524288 chunked tri2+int8 adaptive_heun":
                prod[name],
            "W1 A d=128 N=131072 chunked tri2+int8 fixed_heun (2 steps)":
                wide["chunked_counts"][name], **more}
    results["syrk"]["launches_by_path"] = {
        "fokkerPlanck32 N=16384 syrk fixed_heun": launches["syrk"],
        "one direct batch with the dense SExp (S0, A, SExp)":
            steppers["launches"]["syrk"]}
    results["jacobi"]["launches_by_path"] = {
        MAIN_LABEL + " (the top-k Ritz solve)": launches["jacobi"]}
    results["jacobi_blocks"]["launches_by_path"] = dict(
        block_paths, **{"diffusion (phase C, 20 steps)": paths_c})
    for key, path in multistep.items():
        for name in TRACE_KERNELS:
            if isinstance(path, dict) and path.get("launches", {}).get(name):
                results[name]["launches_by_path"][
                    f"{key} in batches, from the batched run's trace (the "
                    f"capture's warm-up and the replays; one replay: "
                    f"{path['replay_launches'][name]})"] = \
                    path["launches"][name]
    oracles, oracle_paths = phase_oracles()
    paths.update(oracle_paths["persample"])
    studies, study_paths = phase_studies()
    paths.update(study_paths["persample"])
    results["jacobi"]["launches_by_path"].update(study_paths["jacobi"])
    results["jacobi_blocks"]["launches_by_path"].update(
        study_paths["jacobi_blocks"])
    results["metropolis"]["launches_by_path"] = {
        "VarState.sample of fluidpaper's flow (phase 10)":
            launches["metropolis"], **oracle_paths["metropolis"]}
    print(json.dumps({"steppers": steppers}))
    print(json.dumps({"solvers": solvers}))
    print(json.dumps({"mesh_paths": mesh_paths}))
    print(f"phase K: {mesh_k['seconds']:.1f} s on rank 0")
    print(json.dumps({"mesh_k": mesh_k}, default=str))
    print(json.dumps({"qmc_hessian_integrals": qhi}))
    print(json.dumps({"run_state": run_state}))
    print(json.dumps({"oracles": oracles}, default=str))
    print(json.dumps({"studies": studies}, default=str))
    print(json.dumps({"multistep": multistep}, default=str))
    print(json.dumps({"wide": wide}, default=str))
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=launches[name],
             **{"library_ms": None, **results[name]})
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
