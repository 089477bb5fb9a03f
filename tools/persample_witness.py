"""The per-sample kernel's f32 error beside two f32 evaluations of its
plain pipeline that differ only in the order of their sums. Needs a CUDA
card:

    python -m tools.persample_witness [--n 2003] [--w3 ROWS]
        [--jitter COPIES] [--out FILE]

Cases: the perturbed wide flows of tests/test_torch_cuda.py
(``test_kernel_wide_flows``: a fokkerPlanck32 flow with its dim, depth and
widths changed, output weights +-0.03, ``--n`` standard normal x), or with
``--w3``, chip_smoke.py phase W3's perturbed cases (every WIDE flow, ROWS
of its N=16384 standard normal x in whole tiles of the launch). The three
f32 evaluations, each against the plain pipeline in f64 on the same
f32 inputs: the kernel; the plain pipeline as it runs (batched matmuls, a
triangular solve for the latent); and the plain pipeline under
``kernel_order``, which sums as the kernel does. For logp, g, quad and O:
each one's per-sample error (relative to the largest reference value) at
the quantiles 0.5, 0.99 and 0.999 and at its largest, and the three
errors at the kernel's five worst samples; with ``--jitter``, also their
median and largest over COPIES copies of each of those samples, each
coordinate moved by one ulp at random (an f32 evaluation's error at a
sample that amplifies rounding by 1e4 and more, against how it varies
when the input moves by an ulp). One JSON line per case.
"""

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models import latent, mlp
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.ops.evolution import make_equation

QUANTILES = (0.5, 0.99, 0.999)
# the card test's wide flows and their batches (None: --n)
FLOWS = {
    "d128": (dict(dim=128, depth=2, hidden=(16,)), None),
    "d96": (dict(dim=96, depth=4, hidden=(16,)), None),
    "five layers": (dict(hidden=(16, 16, 16, 16)), None),
    "width 96": (dict(depth=2, hidden=(96,)), None),
    "d128 depth 4 hidden 64": (dict(dim=128, depth=4, hidden=(64,)), None),
    "d256 hidden 8": (dict(dim=256, depth=2, hidden=(8,)), 203),
}


def _fma_chain(x, w, b):
    """b + sum_i x[..., i] w[i], one fused multiply-add per input in input
    order (x: (..., n_in), w: (n_in, n_out), b: (n_out,))."""
    acc = b.expand(*x.shape[:-1], b.shape[-1])
    for i in range(w.shape[0]):
        acc = torch.addcmul(acc, x[..., i:i + 1], w[i])
    return acc


def _mlp_in_order(params, x, alpha: float = 10.0):
    """mlp.apply with each layer's sum as the kernel's (fwd_nets and the
    jets): its bias, then one FMA per input."""
    ws, bs = params["w"], params["b"]
    for w, b in zip(ws[:-1], bs[:-1]):
        x = _fma_chain(x, w, b).tanh()
    return alpha * _fma_chain(x, ws[-1], bs[-1]).tanh()


def _mahalanobis_in_order(latent_params, dim: int, x):
    """latent._mahalanobis_sq as the kernel computes it (latent_product):
    y = W (x - mu) through the explicit W = U^{-1}, each y_i one FMA per
    column in column order, then |y|^2 one FMA per row in row order."""
    xc = x - latent_params["mu"]
    U = latent.chol_factor(latent_params, dim)
    W = torch.linalg.solve_triangular(
        U, torch.eye(dim, dtype=U.dtype, device=U.device), upper=True)
    y = _fma_chain(xc, W.T, xc.new_zeros(dim))
    q = xc.new_zeros(xc.shape[:-1])
    for i in range(dim):
        q = torch.addcmul(q, y[..., i], y[..., i])
    return q


@contextlib.contextmanager
def kernel_order():
    """Within it, the plain pipeline (persample.per_sample_plain) sums in
    the kernel's order: every conditioner layer and the latent's quadratic
    form as chains of FMAs instead of matmuls and a triangular solve. The
    derivatives follow through torch.func, so logp and the jets (quad) sum
    as the kernel does; g and O also sum each layer's cotangent over its
    outputs, which torch.func does as reductions."""
    saved = mlp.apply, latent._mahalanobis_sq
    mlp.apply, latent._mahalanobis_sq = _mlp_in_order, _mahalanobis_in_order
    try:
        yield
    finally:
        mlp.apply, latent._mahalanobis_sq = saved


def wide_case(dev, n, seed=3, **kw):
    """(flow, theta f64, x f64, directions): the fokkerPlanck32 preset with
    ``kw`` changed, theta perturbed (output weights +-0.03), n standard
    normal draws as x -- tests/test_torch_cuda.py's _fp32_wide."""
    if "dim" in kw:
        kw.setdefault("offset", (0.0,) * kw["dim"])
    cfg = preset("fokkerPlanck32", **kw)
    flow, theta = build_flow(seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, dtype=torch.float64,
                             device=dev)
    theta = perturb_theta(flow, theta, np.random.default_rng(seed),
                          out_scale=0.03)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, cfg.dim), generator=gen, dtype=torch.float64,
                    device=dev)
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    return flow, theta, x, eq.hessian_trace_dirs(cfg.dim)


NAMES = ("logp", "g", "quad", "O")
CHUNK = 2048  # rows of one evaluation


def _abs_errors(v, ref):
    """Each sample's largest abs error of v against ref."""
    e = (v.double() - ref).abs()
    return e if e.ndim == 1 else e.amax(1)


def _evaluations(flow, theta, x, dirs):
    """{output: ({evaluation: per-sample abs errors}, largest |reference|)}
    of the kernel, plain f32 and plain f32 in the kernel's order against
    the plain pipeline in f64, on f32 theta and x (rows of x in chunks of
    CHUNK for the plain pipeline)."""
    d32 = torch.as_tensor(dirs, dtype=torch.float32, device=x.device)
    th64, d64 = theta.double(), d32.double()
    got = persample.per_sample_cuda(flow, theta, x, d32)
    errs = {name: ({"kernel": [], "plain": [],
                    "plain in the kernel's order": []}, []) for name in NAMES}
    for c in range(0, x.shape[0], CHUNK):
        xc = x[c:c + CHUNK]
        ref = persample.per_sample_plain(flow, th64, xc.double(), d64)
        runs = {"kernel": [v[c:c + CHUNK] for v in got],
                "plain": persample.per_sample_plain(flow, theta, xc, d32)}
        with kernel_order():
            runs["plain in the kernel's order"] = persample.per_sample_plain(
                flow, theta, xc, d32)
        for i, name in enumerate(NAMES):
            errs[name][1].append(float(ref[i].abs().max()))
            for k, v in runs.items():
                errs[name][0][k].append(_abs_errors(v[i], ref[i]))
        del ref, runs
    return {name: ({k: torch.cat(v) for k, v in by.items()},
                   max(1.0, max(scales)))
            for name, (by, scales) in errs.items()}


def _jitter(flow, theta, x, dirs, scale, i, rows, copies):
    """Output i's error of the three evaluations at each of ``rows`` of x
    over ``copies`` copies of its sample, each coordinate moved by one ulp
    up or down at random (the first copy as it is), relative to
    ``scale``: {evaluation: [[median, largest] per row]}."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    out = {}
    for r in rows:
        xs = x[r].expand(copies, -1)
        step = torch.randint(-1, 2, xs.shape, generator=gen, device=x.device)
        step[0] = 0
        xj = torch.where(step > 0, torch.nextafter(xs, xs.new_tensor(
            float("inf"))), torch.where(step < 0, torch.nextafter(
                xs, xs.new_tensor(-float("inf"))), xs)).contiguous()
        for k, e in _evaluations(flow, theta, xj, dirs)[NAMES[i]][0].items():
            e = (e / scale).cpu().numpy()
            out.setdefault(k, []).append([float(np.median(e)),
                                          float(e.max())])
    return out


def witness(flow, theta, x, dirs, copies=0):
    """{output: {evaluation: quantiles and largest of the per-sample error
    (relative to the largest reference value), at the kernel's five worst
    samples, and with ``copies``, the median and largest over copies of
    each of those samples jittered by an ulp (_jitter)}} for the kernel,
    plain f32 and plain f32 in the kernel's order, on f32 theta and x."""
    out = {}
    for i, (name, (errs, scale)) in enumerate(
            _evaluations(flow, theta, x, dirs).items()):
        errs = {k: (e / scale).cpu().numpy() for k, e in errs.items()}
        worst = np.argsort(errs["kernel"])[-5:][::-1]
        out[name] = {k: dict(quantiles=np.quantile(e, QUANTILES).tolist(),
                             largest=float(e.max()),
                             at_kernel_worst=e[worst].tolist())
                     for k, e in errs.items()}
        if copies:
            for k, v in _jitter(flow, theta, x, dirs, scale, i,
                                worst.tolist(), copies).items():
                out[name][k]["jittered_at_kernel_worst"] = v
    return out


def w3_case(label, dev, n_rows):
    """chip_smoke.py W3's perturbed theta of a WIDE flow and ``n_rows`` of
    its W_N standard normal x, whole tiles of the plain-mode launch
    (chip_smoke._tile_rows), made as W3 makes them."""
    import chip_smoke

    flow, theta0, dirs = chip_smoke._wide_flow(label, dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    theta = perturb_theta(flow, theta0, np.random.default_rng(18),
                          out_scale=0.03)
    if label.startswith("SanityFlow"):
        theta[flow.layout.offset(("scale",))] = 0.8
    params = flow.layout.unravel(theta0)
    flow.push(params, flow.latent_sample(gen, params, chip_smoke.W_N,
                                         torch.float32))
    x = torch.randn((chip_smoke.W_N, flow.dim), generator=gen, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = persample.tile_plan(flow, dirs.shape[0], chip_smoke.W_N, n_sm)
    rows = chip_smoke._tile_rows(plan, chip_smoke.W_N, n_rows).to(dev)
    return flow, theta, x[rows].contiguous(), dirs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2003)
    ap.add_argument("--w3", type=int, default=0,
                    help="rows of chip_smoke.py W3's perturbed cases "
                         "instead of the card test's flows")
    ap.add_argument("--jitter", type=int, default=0,
                    help="copies of each of the kernel's worst samples")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    if args.w3:
        import chip_smoke

        cases = {f"W3 {label}": lambda label=label: w3_case(label, dev,
                                                            args.w3)
                 for label in chip_smoke.WIDE}
    else:
        cases = {}
        for label, (kw, n) in FLOWS.items():
            def case(kw=kw, n=n or args.n):
                flow, theta, x, dirs = wide_case(dev, n, **kw)
                return flow, theta.float(), x.float(), dirs
            cases[label] = case
    for label, case in cases.items():
        flow, theta, x, dirs = case()
        res = witness(flow, theta, x, dirs, args.jitter)
        for name, by in res.items():
            print(f"{label}, {name}: " + "; ".join(
                f"{k} q {' '.join(f'{v:.2e}' for v in r['quantiles'])} "
                f"max {r['largest']:.3e}" for k, r in by.items()),
                flush=True)
            for k, r in by.items():
                if "jittered_at_kernel_worst" in r:
                    print(f"    {k} at the kernel's worst {name}: as drawn "
                          + " ".join(f"{v:.2e}" for v in r["at_kernel_worst"])
                          + "; over jitters median/largest " + " ".join(
                              f"{a:.2e}/{b:.2e}" for a, b in
                              r["jittered_at_kernel_worst"]), flush=True)
        line = json.dumps(dict(flow=label, n=x.shape[0], card=card, **res))
        print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del flow, theta, x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
