"""Smoke test of the PyTorch port on one CUDA card:

    python3 chip_smoke.py

1. the device, and its name and power limit as nvidia-smi reports them;
   then every CUDA kernel is built from vmc_pde_torch/kernels/csrc, one
   nvcc per source, all at once;
2. the per-sample kernel against its plain torch.func version at the
   fokkerPlanck32 shape (d=32, P=9264): N=1024, a ragged N=1000 and the
   main path's N=16384 on a perturbed theta (there within twice plain
   f32's own error), then the preset's initial theta at N=16384, where
   both are also timed with CUDA events;
3. the same kernel in split mode (bf16 hi/lo of O - shift, column sums,
   column max) against the plain pipeline and split: N=1024 and a ragged
   N=1000 on the perturbed theta, the chunked path's N=65536 on the
   initial theta, where both are timed;
4. the fused quantize+force kernel against its plain passes at P=9264,
   n=65536 on the split pair of phase 3: q8 bit-identical, f against f64;
5. the port's main path, ``vmc_pde_torch.driver.main`` on fokkerPlanck32
   at the preset's N=16384 for 5 fixed-Heun steps: the per-sample kernel's
   launch counter must rise, nothing may be NaN, the solver residual must
   be finite and below 1e-3;
6. the chunked statistics on one batch of 131072 at the theta phase 5
   ends on, tri2 + int8 against the f32 Gram: S0, F0 and A within 1e-4 of
   each one's largest value;
7. the chunked path at the production operating point, N=524288 in
   chunks of 65536 with the tri2 Gram and the int8 cross term, for 3
   steps: 3 steps x 2 RHS x 8 chunks split launches, twice that many
   quant8 launches, the plain-mode kernel for the pilot, no NaN, residual
   below 1e-3;
8. the 2-D Gaussian diffusion ``mwe`` in f64 against its closed forms.

Any failure raises and exits nonzero. On success the second-to-last line
is the per-kernel JSON record and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import bounds, build, persample, quant8
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.parallel import stats
from vmc_pde_torch.utils.dtypes import full_f32_matmuls

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
}


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
        got = persample.per_sample_cuda(flow, theta, x, dirs)
        ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                         dirs.double())
        ref32 = persample.per_sample_plain(flow, theta, x, dirs)
        torch.cuda.synchronize()
        for name, a, r, p in zip(("logp", "g", "quad", "O"), got, ref, ref32):
            if a.shape != r.shape or not torch.isfinite(a).all():
                fail(f"kernel {name} at N={n}: shape {tuple(a.shape)} vs "
                     f"{tuple(r.shape)}, or not finite")
            rel, rel32 = _rel(a, r), _rel(p, r)
            tol = TOL[name]
            if label == "perturbed" and n == 16384:
                tol = max(tol, 2.0 * rel32)
            print(f"kernel vs plain, {label} theta, N={n}, {name}: max abs "
                  f"err {float((a.double() - r).abs().max()):.3e}, relative "
                  f"{rel:.3e} (tol {tol:.2e}; plain f32 {rel32:.3e})")
            if not rel < tol:
                fail(f"kernel {name} disagrees with the plain version at "
                     f"N={n}: {rel:.3e}")
            if name == "O":
                max_abs = max(max_abs, float((a.double() - r).abs().max()))
        del got, ref, ref32

    # time both on the main path's theta and batch, the last case above
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k)
    print(f"per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain "
          f"torch.func {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def phase_split(dev, prob):
    """Split mode against the plain pipeline and split. The shift is the
    pilot's: the plain f32 mean O of the first 2048 samples."""
    flow, theta0, perturbed, eq, dirs = prob
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs = 0.0
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("initial", theta0, 65536)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        shift = persample.per_sample_plain(flow, theta, x[:2048],
                                           dirs)[3].mean(0)
        got = persample.per_sample_split_cuda(flow, theta, x, dirs, shift)
        ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                         dirs.double())
        ref32 = persample.per_sample_split_plain(flow, theta, x, dirs, shift)
        torch.cuda.synchronize()
        o_ref = ref[3] - shift.double()
        o_scale = o_ref.abs().max().clamp_min(1.0)
        checks = [(name, a, r, p, TOL[name], None) for name, a, r, p in
                  zip(("logp", "g", "quad"), got, ref, ref32)]
        checks += [
            ("hi+lo", got[3][0].double() + got[3][1].double(), o_ref,
             ref32[3][0].double() + ref32[3][1].double(),
             TOL["O"] + 2**-16, None),
            # per-element scale: a sum of n terms each within the O bar
            ("colsum", got[4], o_ref.sum(0), ref32[4], TOL["O"],
             n * o_scale),
            ("colmax", got[5], o_ref.abs().amax(0), ref32[5], TOL["O"],
             o_scale)]
        for name, a, r, p, tol, scale in checks:
            if a.shape != r.shape or not torch.isfinite(a).all():
                fail(f"split kernel {name} at N={n}: shape "
                     f"{tuple(a.shape)} vs {tuple(r.shape)}, or not finite")
            rel, rel32 = _rel(a, r, scale), _rel(p, r, scale)
            print(f"split kernel vs plain, {label} theta, N={n}, {name}: "
                  f"relative {rel:.3e} (tol {tol:.1e}; plain f32 "
                  f"{rel32:.3e})")
            if not rel < tol:
                fail(f"split kernel {name} disagrees with the plain version "
                     f"at N={n}: {rel:.3e}")
            if name == "hi+lo":
                max_abs = max(max_abs, float((a - r).abs().max()))
        del ref, ref32

    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    ms = _time_ms(lambda: persample.per_sample_split_cuda(
        flow, theta, x, dirs, shift), 10)
    plain_ms = _time_ms(lambda: persample.per_sample_split_plain(
        flow, theta, x, dirs, shift), 2)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                             split=True)
    print(f"split per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, "
          f"plain torch.func + split {plain_ms:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]})")
    eloc = eq.eloc(x, got[1], got[2], 0.0)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
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
    # time the hi call, the larger of the two
    _, x_pn, am, V = calls[0]
    inv = stats._int8_scales(am)[1]
    ms = _time_ms(lambda: quant8.quant_force_cuda(x_pn, inv, V), 20)
    plain_ms = _time_ms(lambda: quant8.quant_force_plain(x_pn, inv, V), 20)
    P, n = x_pn.shape
    kv = V.shape[1]
    bound = bounds.quant8(P, n, kv)
    print(f"quant8 at P={P}, n={n}, kv={kv}: CUDA kernel {ms:.3f} ms, "
          f"plain passes {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def _zero_counts():
    for fn in (persample.per_sample_cuda, persample.per_sample_split_cuda,
               quant8.quant_force_cuda):
        fn.launches = 0


def _counts():
    return dict(persample=persample.per_sample_cuda.launches,
                persample_split=persample.per_sample_split_cuda.launches,
                quant8=quant8.quant_force_cuda.launches)


def _drive(args, label, n_steps):
    """Run the driver; returns (state, recorder arrays, counts)."""
    stamps = []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rec = driver.main(args + ["--max-steps", str(n_steps),
                                     "--device", "cuda"], callbacks=[record])
    counts = _counts()
    steps = np.diff([t0] + stamps)
    print(f"{label}: {len(steps)} Heun steps, wall s/step "
          f"{' '.join(f'{s:.3f}' for s in steps)} (first includes set-up), "
          f"mean of steps 2-{len(steps)} {steps[1:].mean():.3f} s")
    print(f"{label}: kernel launches {counts}")
    arrays = rec.as_arrays()
    for key in ("solver_res", "tdvp_error", "entropy", "covar", "x1",
                "eloc_mean", "ev_topk"):
        if not np.isfinite(arrays[key]).all():
            fail(f"non-finite {key} in the {label} run")
    if arrays["nan"].any():
        fail(f"NaN update in the {label} run")
    if arrays["covar"].shape != (n_steps, 32, 32):
        fail(f"covar shape {arrays['covar'].shape}")
    res = arrays["solver_res"]
    print(f"{label} solver_res per step: "
          f"{' '.join(f'{r:.3e}' for r in res)}")
    if not (res < 1e-3).all():
        fail(f"solver residual above 1e-3 in the {label} run: {res}")
    return state, arrays, counts


def phase_main_path():
    state, _, counts = _drive(["fokkerPlanck32"], "fokkerPlanck32 N=16384",
                              5)
    if counts["persample"] == 0:
        fail("the main path never launched the per-sample kernel")
    return state, counts


def phase_chunked_path():
    n_steps = 3
    _, _, counts = _drive(
        ["fokkerPlanck32", "--samples", "524288", "--chunk-size", "65536",
         "--gram-backend", "tri2", "--gram-cross", "int8"],
        "fokkerPlanck32 N=524288 chunked tri2+int8", n_steps)
    want = n_steps * 2 * (524288 // 65536)
    if counts["persample_split"] != want:
        fail(f"split kernel launches {counts['persample_split']}, expected "
             f"{want}")
    if counts["quant8"] != 2 * want:
        fail(f"quant8 launches {counts['quant8']}, expected {2 * want}")
    if counts["persample"] == 0:
        fail("the chunked path never ran the plain-mode kernel's pilot")
    return counts


def phase_split_vs_f32(theta):
    """The chunked statistics on one batch through both Gram paths, at the
    theta the main path ends on."""
    n, c = 131072, 65536
    out = {}
    for label, over in (("tri2+int8", dict(gram_backend="tri2",
                                           gram_cross="int8")),
                        ("f32", {})):
        cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                     n_samples_obs=n, chunk_size=c, **over)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = theta.to(device=state.device, dtype=torch.float32)
        params = state.flow.layout.unravel(theta_c)
        gen = torch.Generator(device=state.device).manual_seed(7)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdvp._chunked_stats(theta_c, 0.0, x)
        torch.cuda.synchronize()
        out[label] = (st, time.perf_counter() - t0)
    (split, t_split), (full, t_full) = out["tri2+int8"], out["f32"]
    print(f"chunked statistics at N={n}, chunk {c}: tri2+int8 "
          f"{t_split:.3f} s, f32 Gram {t_full:.3f} s (first call each)")
    for key in ("S0", "F0", "A"):
        rel = _rel(split[key], full[key], full[key].abs().max())
        print(f"tri2+int8 vs f32 {key}: max abs diff / max {rel:.3e} "
              f"(tol 1e-4)")
        if not rel <= 1e-4:
            fail(f"tri2+int8 {key} differs from the f32 Gram path: {rel}")


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


def main():
    phase_device()
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
    launches = {"persample": counts["persample"]}
    phase_split_vs_f32(state.get_parameters())
    counts = phase_chunked_path()
    launches.update(persample_split=counts["persample_split"],
                    quant8=counts["quant8"])
    phase_mwe()
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=launches[name],
             library_ms=None, **results[name])
        for name in ("persample", "persample_split", "quant8")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
