"""Where the per-sample CUDA kernel's f32 error grows, coupling block by
coupling block, against the plain torch.func pipeline in f32, both held
against the plain pipeline in f64 on the same f32 inputs. Needs a CUDA
card:

    python -m tools.persample_blocks [--n 16384] [--out-scale 0.03] \
        [--latent Student_t] [--global-affine] [--seed 0]

fokkerPlanck32's flow (d=32, P=9264, four affine blocks; P=9397 with the
Student-t latent and the global affine) with its output weights drawn
U[-out_scale, out_scale] (chip_smoke.py's perturbed theta; there nu =
2.5 and g_scale 0.9, 1.1, 0.95, 1.05) and n samples pushed through it.
For every block it prints the relative error (max |a - f64| / max |f64|)
of

- the forward values the kernel saves at the block's entry (u1, u2) and
  its intermediate v1, against the f64 forward through models/coupling;
- the block's O rows (its four conditioners' parameter gradients and the
  global affine's g_scale and g_offset rows), which the backward writes
  as it passes the block;

then the latent O rows, logp and g, each for the kernel and for plain f32,
and the same at the sample where the kernel's g error is largest. Last,
how the g error spreads over the samples: quantiles of each sample's
largest error relative to max |g|, and the largest error among the
samples inside each quantile of |x|.
"""

import argparse

import numpy as np
import torch

from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models import coupling, mlp
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.utils.dtypes import full_f32_matmuls


def rel(a, ref):
    ref = ref.double()
    return float((a.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def block_rows(flow, b):
    """Indices of block b's parameters in the flat theta (its O rows)."""
    lay, spec = flow.layout, flow.blocks[b]
    rows = []
    for net in spec.nets:
        n_in, n_out = spec.net_dims(net)
        dims = [n_in, *spec.hidden, n_out]
        for layer in range(len(dims) - 1):
            b_off = lay.offset(("blocks", b, net, "b", layer))
            w_off = lay.offset(("blocks", b, net, "w", layer))
            rows += range(b_off, b_off + dims[layer + 1])
            rows += range(w_off, w_off + dims[layer] * dims[layer + 1])
    if spec.global_affine:
        rows.append(lay.offset(("blocks", b, "g_scale")))
        g_off = lay.offset(("blocks", b, "g_offset"))
        rows += range(g_off, g_off + spec.dim)
    return torch.as_tensor(rows)


def forward_values(flow, params, x):
    """Per block: (u1, u2, v1) at the block's entry, in x's dtype."""
    out = []
    for p, spec in zip(params["blocks"], flow.blocks):
        u1, u2 = x[:, list(spec.ind_up)], x[:, list(spec.ind_down)]
        s2 = mlp.apply(p["s2"], u2, spec.alpha)
        t2 = (mlp.apply(p["t2"], u2, spec.alpha)
              if spec.variant == "affine" else None)
        v1 = coupling._couple_fwd(u1, s2, t2, spec.variant)[0]
        out.append((u1, u2, v1))
        x = coupling.forward(p, spec, x)[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--out-scale", type=float, default=0.03)
    ap.add_argument("--latent", default="Gauss",
                    choices=("Gauss", "Student_t"))
    ap.add_argument("--global-affine", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the latent draws")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    full_f32_matmuls()
    dev = torch.device("cuda")
    cfg = preset("fokkerPlanck32")
    flow, theta0 = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                              hidden=cfg.hidden_resolved(),
                              variant=cfg.variant, out_scale=cfg.init_scale,
                              latent_name=args.latent,
                              global_affine=args.global_affine,
                              dtype=torch.float32, device=dev)
    theta = perturb_theta(flow, theta0, np.random.default_rng(0),
                          out_scale=args.out_scale)
    lay = flow.layout
    if args.latent == "Student_t":
        theta[lay.offset(("latent", "dist_params"))] = np.log(1.5)
    if args.global_affine:
        for b, g in enumerate((0.9, 1.1, 0.95, 1.05)):
            theta[lay.offset(("blocks", b, "g_scale"))] = g
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = flow.layout.unravel(theta)
    x, _ = flow.push(params, flow.latent_sample(gen, params, args.n,
                                                torch.float32))

    meta, n_sv = persample.block_plan(flow, dirs.shape[0])
    saves = torch.empty((n_sv, args.n),
                        dtype=torch.float32, device=dev)
    kern = persample.per_sample_cuda(flow, theta, x, dirs, saves=saves)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    p32 = persample.per_sample_plain(flow, theta, x, dirs)
    torch.cuda.synchronize()
    fwd64 = forward_values(flow, flow.layout.unravel(theta.double()),
                           x.double())
    fwd32 = forward_values(flow, params, x)
    g_err = (kern[1].double() - ref[1]).abs().amax(1)
    worst = int(g_err.argmax())
    print(f"fokkerPlanck32, {args.latent}, global affine "
          f"{args.global_affine}, P={lay.size}, N={args.n}, output weights "
          f"+-{args.out_scale}, seed {args.seed}; worst-g sample {worst}: "
          f"|x| = {float(x[worst].norm()):.3e}")
    print("block  quantity  kernel      plain-f32   | at worst sample: "
          "kernel  plain-f32")

    def row(name, k, p, r):
        w = slice(worst, worst + 1)
        print(f"{name:<17s} {rel(k, r):.3e}   {rel(p, r):.3e}   |   "
              f"{rel(k[w], r[w]):.3e}   {rel(p[w], r[w]):.3e}")

    for b in range(len(flow.blocks)):
        r0 = persample.block_record(meta, b)
        n_up, n_down = len(flow.blocks[b].ind_up), len(flow.blocks[b].ind_down)
        for j, (name, width) in enumerate((("u1", n_up), ("u2", n_down),
                                           ("v1", n_up))):
            off = int(meta[r0 + 4 + j])
            k = saves[off:off + width, :args.n].T
            row(f"{b}  {name}", k, fwd32[b][j], fwd64[b][j])
        idx = block_rows(flow, b).to(dev)
        row(f"{b}  O rows", kern[3][:, idx], p32[3][:, idx], ref[3][:, idx])
    lat = torch.as_tensor(
        [lay.offset(("latent", k)) + i
         for k in ("L", "L_diag", "dist_params", "mu")
         for i in range(int(np.prod(lay.shapes["latent"][k])))], device=dev)
    row("latent O rows", kern[3][:, lat], p32[3][:, lat], ref[3][:, lat])
    for i, name in enumerate(("logp", "g", "quad")):
        row(name, kern[i], p32[i], ref[i])

    scale = ref[1].abs().max()
    e_k = g_err / scale
    e_p = (p32[1].double() - ref[1]).abs().amax(1) / scale
    qs = torch.tensor([0.5, 0.99, 0.999, 1.0], dtype=torch.float64,
                      device=dev)
    print("g error per sample / max|g|, quantiles 0.5 0.99 0.999 1: kernel "
          + " ".join(f"{v:.2e}" for v in torch.quantile(e_k, qs).tolist())
          + "; plain f32 "
          + " ".join(f"{v:.2e}" for v in torch.quantile(e_p, qs).tolist()))
    r = x.double().norm(dim=1)
    for q in (0.9, 0.99, 0.999, 1.0):
        inside = r <= torch.quantile(r, q)
        print(f"samples with |x| <= its {q} quantile "
              f"({float(torch.quantile(r, q)):.3e}): largest g error / "
              f"max|g| kernel {float(e_k[inside].max()):.3e}, plain f32 "
              f"{float(e_p[inside].max()):.3e}")


if __name__ == "__main__":
    main()
