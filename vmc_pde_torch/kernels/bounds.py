"""Least card time of each TPU kernel's work on one H100 (its bound): the
larger of the bytes it must move (each input read once, each output
written once) over the memory rate, and its operations over the peak rate
of their type. Peaks from NVIDIA's H100 SXM data sheet, dense, at the full
700 W: 3.35 TB/s HBM, 67 TFLOP/s f32 outside the tensor cores (f64 34
there), 989 TFLOP/s bf16 and 67 f64 on them; 32-bit integer multiplies
at 64 per clock per SM (the CUDA C++ Programming Guide's
arithmetic-instruction throughput table, compute capability 9.0) on 132
SMs at the card's maximum SM clock.
chip_smoke.py reports these bounds beside the measured times;

    python -m vmc_pde_torch.kernels.bounds

prints them for every function of the JAX package that reaches
``pl.pallas_call``, at the shapes of the paths that run it.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F64_FLOP_S = 67e12  # f64 on the tensor cores (DMMA), the card's f64 peak
BF16_FLOP_S = 989e12
# the maximum SM clock of an H100 80GB HBM3, as
# `nvidia-smi --query-gpu=clocks.max.sm` reports it: 1980 MHz
H100_MAX_SM_HZ = 1980e6
INT32_MUL_S = 64 * 132 * H100_MAX_SM_HZ
# 32-bit multiply results per Philox-4x32-10 call: 10 rounds of two
# multiplies, each taken hi and lo
PHILOX_MULS = 10 * 2 * 2


def bound_ms(n_bytes, n_ops, ops_rate=F32_FLOP_S):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def persample_flops(layers, dim, k_dirs, n_ga=0):
    """Scalar f32 operations of one sample of the per-sample kernel,
    counted from the conditioners' (in, out) layer shapes (none for a flow
    without coupling blocks): 2 in out forward, 3 in out backward (the
    weight rows and the input cotangent) and 4 in out per trace direction
    for the two jet tangents; each of ``n_ga`` global affines 2 dim
    forward, 3 dim backward and 2 dim per direction; the latent's
    products with its triangular W = U^{-1} (d (d + 1) / 2 multiply-adds
    each): W u and W^T y, the d (d - 1) / 2 strictly-upper O rows at 2
    operations each, and per direction |W z'|^2 with the 6 d operations of
    its dot products. The Student-t latent adds a few operations per
    sample and per direction, not counted."""
    per = sum((5 + 4 * k_dirs) * a * b for a, b in layers)
    per += n_ga * (5 + 2 * k_dirs) * dim
    tri = dim * (dim + 1)
    return per + 2 * tri + dim * (dim - 1) + k_dirs * (tri + 6 * dim)


def flow_ga(flow):
    """Number of blocks of a port Flow with the learned global affine."""
    return sum(spec.global_affine for spec in flow.blocks)


def flow_layers(flow):
    """(in, out) of every conditioner layer of a port Flow."""
    out = []
    for spec in flow.blocks:
        for net in spec.nets:
            n_in, n_out = spec.net_dims(net)
            dims = [n_in, *spec.hidden, n_out]
            out += list(zip(dims[:-1], dims[1:]))
    return out


def persample(layers, dim, P, n, k_dirs, split=False, n_ga=0):
    """The per-sample kernel at n samples: x and theta in; logp, g, quad
    and the (P, n) f32 O out -- or, split, the shift in and the bf16 pair
    and the two (P,) column statistics out."""
    n_bytes = 4 * (n * dim + P + n + n * dim + n)
    n_bytes += 4 * 2 * P + 2 * 2 * P * n if split else 4 * P * n
    return bound_ms(n_bytes, n * persample_flops(layers, dim, k_dirs, n_ga))


def quant8(P, n, kv):
    """quant_force on a (P, n) bf16 operand: x, inv and V in; int8 q8 and
    the (P, kv) f32 f out; 1 + 2 kv operations per element."""
    return bound_ms(2 * P * n + 4 * P + 2 * n * kv + P * n + 4 * P * kv,
                    P * n * (1 + 2 * kv))


def syrk(N, P, weighted=False):
    """The triangle Gram O^T diag(w) O of an (N, P) f32 operand in three
    bf16 passes: O (and w) in, the mirrored (P, P) f32 out; 3 N P^2 bf16
    operations (each pass half of 2 N P^2: the lower triangle)."""
    return bound_ms(4 * N * P + 4 * N * weighted + 4 * P * P,
                    3 * N * P * P, BF16_FLOP_S)


def metropolis_terms(n, dim, ext=False):
    """The least times in ms of independence Metropolis on n proposals, by
    term: "bytes", n recorded (dim,) f32 states out (and, with external
    uniforms, 2 dim + 2 f32 uniforms in per proposal); "f32", ~(8 dim +
    24) f32 operations per proposal (Box-Muller, ball radius, the latent's
    log-density, the accept test); "int_mul", without external uniforms,
    the 32-bit multiplies of the Philox calls that draw a proposal's 2 dim
    + 2 words (four per call). chip_smoke.py also reports the larger of
    the first two, the bound with Philox left out."""
    n_philox = -(-(2 * dim + 2) // 4)
    return {"bytes": 1e3 * (4 * n * dim + 4 * (2 * dim + 2) * n * ext)
            / HBM_BYTES_S,
            "f32": 1e3 * n * (8 * dim + 24) / F32_FLOP_S,
            "int_mul": 0.0 if ext else
            1e3 * n * n_philox * PHILOX_MULS / INT32_MUL_S}


def metropolis(n, dim, ext=False):
    """(least time in ms, "bytes" or "operations") of independence
    Metropolis on n proposals: the largest of metropolis_terms."""
    t = metropolis_terms(n, dim, ext)
    ms = max(t.values())
    return ms, "bytes" if t["bytes"] >= ms else "operations"


def fokker_planck32():
    """fokkerPlanck32's flow: d=32, four affine blocks of 16 -> 16 -> 16
    conditioners, P=9264, 16 trace directions."""
    layers = [(16, 16), (16, 16)] * 16
    return layers, 32, 9264, 16


def main():
    layers, d, P, k = fokker_planck32()
    # the same flow with a Student-t latent (+1 row) and the global affine
    # in each of its 4 blocks (+33 rows each): P = 9397
    P_t = P + 1 + 4 * (d + 1)
    rows = [
        ("make_per_sample_pallas, plain mode (N=16384)",
         persample(layers, d, P, 16384, k)),
        ("same, Student-t + global affine (N=16384, P=9397)",
         persample(layers, d, P_t, 16384, k, n_ga=4)),
        ("same, emit_split, Student-t + global affine (N=65536, P=9397)",
         persample(layers, d, P_t, 65536, k, split=True, n_ga=4)),
        ("make_per_sample_pallas, plain mode, pilot (N=2048)",
         persample(layers, d, P, 2048, k)),
        ("make_per_sample_pallas, emit_split (N=65536)",
         persample(layers, d, P, 65536, k, split=True)),
        ("make_per_sample_sharded, per device of 4 (N=16384)",
         persample(layers, d, P, 16384 // 4, k)),
        ("quant8.quant_force, hi (P=9264, n=65536, kv=2)",
         quant8(P, 65536, 2)),
        ("quant8.quant_force, lo (P=9264, n=65536, kv=1)",
         quant8(P, 65536, 1)),
        ("probe_quant8.make_quant_force (P=9264, n=65536, kv=2)",
         quant8(P, 65536, 2)),
        ("syrk.syrk (N=16384, P=9264)", syrk(16384, P)),
        ("syrk.syrk, weighted (N=16384, P=9264)", syrk(16384, P, True)),
        ("syrk.syrk, chunk (N=65536, P=9264)", syrk(65536, P)),
        ("metropolis_chain_pallas, Philox (8192 chains x 128 sweeps, d=2)",
         metropolis(8192 * 128, 2)),
        ("metropolis_chain_pallas, external uniforms (same)",
         metropolis(8192 * 128, 2, ext=True)),
        ("metropolis_chain_pallas_sharded, per device of 4 (2048 chains)",
         metropolis(8192 * 128 // 4, 2)),
    ]
    for name, (ms, by) in rows:
        print(f"{name:<62s} {ms:10.4g} ms  ({by})")


if __name__ == "__main__":
    main()
