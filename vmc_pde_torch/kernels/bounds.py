"""Least card time of each TPU kernel's work on one H100 (its bound): the
larger of the bytes it must move (each input read once, each output
written once) over the memory rate, and its operations over the peak rate
of their type. Peaks from NVIDIA's H100 SXM data sheet, dense, at the full
700 W: 3.35 TB/s HBM, 67 TFLOP/s f32 outside the tensor cores, 989
TFLOP/s bf16 on them. chip_smoke.py reports these bounds beside the
measured times;

    python -m vmc_pde_torch.kernels.bounds

prints them for every function of the JAX package that reaches
``pl.pallas_call``, at the shapes of the paths that run it.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12


def bound_ms(n_bytes, n_ops, ops_rate=F32_FLOP_S):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def persample_flops(layers, dim, k_dirs, n_ga=0):
    """Scalar f32 operations of one sample of the per-sample kernel,
    counted from the conditioners' (in, out) layer shapes: 2 in out
    forward, 3 in out backward (the weight rows and the input cotangent)
    and 4 in out per trace direction for the two jet tangents; the latent's
    d x d products likewise; each of ``n_ga`` global affines 2 dim forward,
    3 dim backward and 2 dim per direction. The Student-t latent adds a
    few operations per sample and per direction, not counted."""
    per = sum((5 + 4 * k_dirs) * a * b for a, b in layers)
    per += n_ga * (5 + 2 * k_dirs) * dim
    return per + (4.5 + 4 * k_dirs) * dim**2


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


def metropolis(n, dim, ext=False):
    """Independence Metropolis: n recorded (dim,) f32 states out (and, with
    external uniforms, 2 dim + 2 f32 uniforms in per proposal); ~(8 dim
    + 24) f32 operations per proposal (Box-Muller, ball radius, the
    latent's log-density, the accept test; Philox's integer rounds not
    counted)."""
    return bound_ms(4 * n * dim + 4 * (2 * dim + 2) * n * ext,
                    n * (8 * dim + 24))


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
        ("metropolis_chain_pallas_sharded, per device of 4 (same)",
         metropolis(8192 * 128 // 4, 2)),
    ]
    for name, (ms, by) in rows:
        print(f"{name:<62s} {ms:10.4g} ms  ({by})")


if __name__ == "__main__":
    main()
