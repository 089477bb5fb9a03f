"""Accuracy of the split Gram's bf16 products on a CUDA card, and what the
K blocking of parallel/stats._mm_bf16 buys:

    python -m tools.split_gram_accuracy

1. X^T X of a (65536, 1024) bf16 matrix of standard normals against its
   exact f64 value: cuBLAS's f32 product of the upcast operand, and the
   bf16 product with f32 output contracting K_BLOCK terms per tensor-core
   accumulation for several K_BLOCK (65536 = one product). Prints the
   largest error and the mean relative error of the diagonal (a sum of
   squares: truncation shrinks it, rounding does not bias it).
2. fokkerPlanck32's chunked statistics (N=131072 in chunks of 65536, the
   preset's initial theta) with the tri2 Gram and the int8 cross term
   against the f32 Gram on the same samples, for the same K_BLOCKs: the
   S0 and A differences relative to their largest value, the smallest
   eigenvalue of S0 over its largest (the Cholesky solve's Tikhonov shift
   is 64 eps_f32 = 7.6e-6 of the largest), and the time of each call.
"""

import time

import torch

from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.parallel import stats
from vmc_pde_torch.utils.dtypes import full_f32_matmuls

K_BLOCKS = (65536, 8192, 4096, 2048, 1024, 512)


def rel(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


def synthetic(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    H = torch.randn((65536, 1024), generator=gen, device=dev).to(
        torch.bfloat16)
    ref = H.double().T @ H.double()
    diag = torch.diagonal(ref)

    def report(label, S):
        d = float(((torch.diagonal(S).double() - diag) / diag).mean())
        print(f"  {label:<28s} max err / max {rel(S, ref):.3e}, mean "
              f"diagonal relative {d:+.3e}")

    print("X^T X, X (65536, 1024) bf16 standard normals:")
    report("f32 product (upcast)", H.float().T @ H.float())
    for kb in K_BLOCKS:
        stats._BF16_K_BLOCK = kb
        report(f"bf16, K_BLOCK {kb}", stats._mm_bf16(H.T, H))


def chunked(dev):
    n, c = 131072, 65536
    runs = {}
    for label, over in (("f32", {}), ("split", dict(gram_backend="tri2",
                                                    gram_cross="int8"))):
        cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                     n_samples_obs=n, chunk_size=c, **over)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta = state.theta
        params = state.flow.layout.unravel(theta)
        gen = torch.Generator(device=dev).manual_seed(7)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        runs[label] = (tdvp, theta, x)

    def stats_of(label):
        tdvp, theta, x = runs[label]
        tdvp._chunked_stats(theta, 0.0, x)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdvp._chunked_stats(theta, 0.0, x)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    def eig_ratio(S):
        ev = torch.linalg.eigvalsh(S.double())
        return float(ev[0] / ev[-1])

    full, t_full = stats_of("f32")
    print(f"fokkerPlanck32 chunked statistics, N={n}, chunk {c}, initial "
          f"theta: f32 Gram {t_full:.3f} s, S0 lambda_min/lambda_max "
          f"{eig_ratio(full['S0']):+.3e}")
    for kb in K_BLOCKS:
        stats._BF16_K_BLOCK = kb
        st, t = stats_of("split")
        print(f"  tri2+int8, K_BLOCK {kb:6d}: {t:.3f} s, S0 diff "
              f"{rel(st['S0'], full['S0'].double()):.3e}, A diff "
              f"{rel(st['A'], full['A'].double()):.3e}, F0 diff "
              f"{rel(st['F0'], full['F0'].double()):.3e}, lambda_min/"
              f"lambda_max {eig_ratio(st['S0']):+.3e}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    full_f32_matmuls()
    dev = torch.device("cuda")
    synthetic(dev)
    chunked(dev)


if __name__ == "__main__":
    main()
