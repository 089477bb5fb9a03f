// Independence Metropolis chains of the cosine-bump latent, all sweeps in
// one launch:
//
//   proposal  y = r d + offset,  d = n / |n|,  n_k = sqrt(-2 log u_k)
//             cos(2 pi u_{d+k}),  r = u_{2d}^(1/d) bound
//   accept    u_{2d+1} < exp(lp(y) - lp(x)),  lp the cosine bump
//             log[(1 + cos(pi min(1, 4 |x - offset|))) / 2]
//
// Replaces the TPU kernel vmc_pde_tpu/kernels/metropolis.py::
// metropolis_chain_pallas (_metropolis_kernel_hw and _metropolis_kernel_ext).
// The TPU kernel lays chains on the vector lanes and walks sweeps in its
// sequential grid; here each thread owns one chain: its state, log-density
// and accept count stay in registers across all sweeps, and each sweep
// stores the chain's state into its row of the sweep-major output (the
// threads of a warp store neighbouring rows, so the stores coalesce).
//
// Uniforms come from the caller (EXT: the (2d + 2, sweeps * C) block of the
// JAX kernel's external-uniform contract, column s * C + c) or from
// Philox-4x32-10 keyed by the 64-bit seed with the counter (chain_base +
// chain, sweep, word group, 0): the counterpart of the TPU's hardware PRNG,
// reproducible and independent of the launch shape. A rank that runs the
// chains [chain_base, chain_base + C) of a sharded ensemble passes its
// chain_base (metropolis_chain_sharded), so the shards replay the single
// launch bit for bit. A word becomes (w & 0x7FFFFF) 2^-23
// + 1e-12 as on the TPU. The accepted moves are summed by warp shuffles and
// one 64-bit integer atomic per warp: deterministic.
//
// The arithmetic is written with explicit round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, ...), which the compiler never contracts into
// FMAs, and the IEEE logf/cosf/expf/powf/sqrtf (no --use_fast_math): the
// plain torch version (kernels/metropolis.py) performs the same rounded
// operations in the same order, so the two replay bit for bit on the same
// uniforms. Outside the bump's support lp = -inf and -inf - -inf is NaN,
// which fails the accept test: the move is rejected, as on the TPU.
//
// Bound on the card: arithmetic, not memory. Per proposal ~(8 d + 24)
// scalar f32 operations (transcendentals counted once) plus, for Philox,
// 10 rounds of two 32-bit multiplies per four words; the only traffic is
// the sample store (4 d bytes per proposal) and, for EXT, the uniforms.
// One thread per chain keeps it simple; at C = 8192 the 64-thread blocks
// spread over 128 SMs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 64;
// the cosine bump is the 2-D latent of the fluidpaper preset
constexpr int DIM = 2;
constexpr int ROWS = 2 * DIM + 2;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c[0]), lo0 = PHILOX_M0 * c[0];
    const uint32_t hi1 = __umulhi(PHILOX_M1, c[2]), lo1 = PHILOX_M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __fadd_rn(__fmul_rn((float)(w & 0x7FFFFFu), 1.1920928955078125e-7f),
                   1e-12f);
}

__device__ __forceinline__ float cos_bump_lp(const float* x,
                                             const float* off) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    const float dk = __fsub_rn(x[k], off[k]);
    const float sq = __fmul_rn(dk, dk);
    s = k ? __fadd_rn(s, sq) : sq;
  }
  const float r = fminf(__fmul_rn(4.f, sqrtf(s)), 1.f);
  return logf(__fmul_rn(0.5f, __fadd_rn(1.f, cosf(__fmul_rn(PI_F, r)))));
}

template <bool EXT>
__global__ void __launch_bounds__(THREADS) metropolis_kernel(
    const float* __restrict__ init, const float* __restrict__ offset,
    float bound, const float* __restrict__ u, unsigned long long seed,
    unsigned chain_base, int n_chains, int n_steps,
    float* __restrict__ samples, float* __restrict__ final_states,
    unsigned long long* __restrict__ n_acc) {
  constexpr float INV_DIM = 1.f / DIM;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  unsigned long long acc = 0;
  if (c < n_chains) {
    const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
    const size_t stride = (size_t)n_steps * n_chains;
    float off[DIM], x[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      off[k] = offset[k];
      x[k] = init[(size_t)c * DIM + k];
    }
    float lp = cos_bump_lp(x, off);
    for (int s = 0; s < n_steps; ++s) {
      float uu[ROWS];
      if (EXT) {
        const float* col = u + (size_t)s * n_chains + c;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) uu[r] = col[r * stride];
      } else {
#pragma unroll
        for (int j = 0; j < (ROWS + 3) / 4; ++j) {
          uint32_t w[4] = {chain_base + (uint32_t)c, (uint32_t)s, (uint32_t)j,
                           0u};
          philox4x32_10(w, k0, k1);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * j + q < ROWS) uu[4 * j + q] = to_uniform(w[q]);
        }
      }
      float dv[DIM];
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        dv[k] = __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(uu[k]))),
                          cosf(__fmul_rn(TWO_PI_F, uu[DIM + k])));
        const float sq = __fmul_rn(dv[k], dv[k]);
        ss = k ? __fadd_rn(ss, sq) : sq;
      }
      const float nrm = sqrtf(ss);
      const float rad = __fmul_rn(powf(uu[2 * DIM], INV_DIM), bound);
      float prop[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k)
        prop[k] = __fadd_rn(__fmul_rn(rad, __fdiv_rn(dv[k], nrm)), off[k]);
      const float lp_new = cos_bump_lp(prop, off);
      if (uu[2 * DIM + 1] < expf(__fsub_rn(lp_new, lp))) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) x[k] = prop[k];
        lp = lp_new;
        ++acc;
      }
      float* row = samples + ((size_t)s * n_chains + c) * DIM;
#pragma unroll
      for (int k = 0; k < DIM; ++k) row[k] = x[k];
    }
#pragma unroll
    for (int k = 0; k < DIM; ++k) final_states[(size_t)c * DIM + k] = x[k];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, m);
  if ((threadIdx.x & 31) == 0 && acc) atomicAdd(n_acc, acc);
}

}  // namespace

// C entry point: launches on ``stream`` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for empty shapes). init (C, 2) f32, offset
// (2,) f32, u (6, n_steps * C) f32 or NULL for the Philox stream of
// ``seed`` (chain c's counter word is chain_base + c); outputs samples
// (n_steps * C, 2) sweep-major, final_states (C, 2) and n_acc, one int64
// the caller zeroes.
extern "C" int metropolis_f32(const float* init, const float* offset,
                              float bound, const float* u,
                              unsigned long long seed, int chain_base,
                              int n_chains, int n_steps, float* samples,
                              float* final_states, void* n_acc, void* stream) {
  if (n_chains <= 0 || n_steps <= 0 || chain_base < 0)
    return (int)cudaErrorInvalidValue;
  auto* acc = static_cast<unsigned long long*>(n_acc);
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n_chains + THREADS - 1) / THREADS;
  if (u)
    metropolis_kernel<true><<<blocks, THREADS, 0, s>>>(
        init, offset, bound, u, seed, (unsigned)chain_base, n_chains, n_steps,
        samples, final_states, acc);
  else
    metropolis_kernel<false><<<blocks, THREADS, 0, s>>>(
        init, offset, bound, u, seed, (unsigned)chain_base, n_chains, n_steps,
        samples, final_states, acc);
  return (int)cudaGetLastError();
}
