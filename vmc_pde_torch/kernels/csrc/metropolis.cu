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
// sequential grid. The proposals are independence proposals: the pair
// (sweep, chain)'s y, lp(y) and accept uniform depend on that pair's
// uniforms alone, never on the chain's state. Only the accept test
// against the chain's current lp is sequential. So here a block owns a
// tile of TC chains (8, 16 or 32) and walks the sweeps in chunks of KS:
//
//   proposal warps  every (sweep, chain) pair of a chunk, neighbouring
//                   chains on neighbouring lanes, into a shared-memory
//                   buffer as (y0, y1, lp(y), u_acc), 16 bytes a pair;
//   scan warp       one lane per chain, the chunk's KS accept tests in
//                   order against the carried lp, each sweep's state
//                   stored as it is known (a warp stores TC neighbouring
//                   rows of the sweep-major output: coalesced, streaming).
//
// Two buffers: the scan of chunk k runs while the proposal warps fill
// chunk k + 1. Named barriers hand the buffers over (FULL: a chunk's
// proposals are written; EMPTY: the scan has read them). Per sweep the
// scan does one expf, a subtraction, a compare and selects; everything
// else spreads over (sweep, chain) pairs and so over the whole card.
//
// Uniforms come from the caller (EXT: the (2d + 2, sweeps * C) block of the
// JAX kernel's external-uniform contract, column s * C + c: a chunk's loads
// are contiguous along chains) or from Philox-4x32-10 keyed by the 64-bit
// seed with the counter (chain_base + chain, sweep, word group, 0): the
// counterpart of the TPU's hardware PRNG, reproducible and independent of
// the launch shape. A rank that runs the chains [chain_base, chain_base +
// C) of a sharded ensemble passes its chain_base (metropolis_chain_sharded),
// so the shards replay the single launch bit for bit. A word becomes
// (w & 0x7FFFFF) 2^-23 + 1e-12 as on the TPU. The accepted moves are
// summed by warp shuffles and one 64-bit integer atomic per block:
// deterministic.
//
// The arithmetic is written with explicit round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, ...), which the compiler never contracts into
// FMAs, and the IEEE logf/cosf/expf/powf/sqrtf (no --use_fast_math): the
// plain torch version (kernels/metropolis.py) performs the same rounded
// operations in the same order, so the two replay bit for bit on the same
// uniforms, whatever the tile plan. Outside the bump's support lp = -inf
// and -inf - -inf is NaN, which fails the accept test: the move is
// rejected, as on the TPU.
//
// Bound on the card (kernels/bounds.py): Philox's 80 32-bit multiply
// results per proposal at 64 per clock per SM, about 5 us at 8192 chains x
// 128 sweeps; with external uniforms the 24 + 8 bytes per proposal. What
// sets the pace is instruction issue in the proposal warps (some 600
// instructions a pair, most of them the IEEE functions' own) and, with
// few chains per SM, the scan's chain of dependent operations per sweep.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// the scan warp and at most 16 proposal warps
// (kernels/metropolis.py MAX_THREADS)
constexpr int MAX_THREADS = 544;
constexpr int WARP = 32;
// bytes of shared memory per (sweep, chain) pair: float4 (y0, y1, lp, u_acc)
// (kernels/metropolis.py PAIR_BYTES); two buffers of KS x TC pairs, within
// the 48 KB of dynamic shared memory a launch takes without an opt-in
constexpr int PAIR_BYTES = 16;
constexpr int SMEM_LIMIT = 49152;
// the scan's unroll; the sweep counts and KS are multiples of it
// (kernels/metropolis.py SWEEPS_PER_BLOCK)
constexpr int SCAN_UNROLL = 8;
// named barriers (0 is __syncthreads): FULL + b, EMPTY + b for buffer b
constexpr int BAR_FULL = 1, BAR_EMPTY = 3;
// the cosine bump is the 2-D latent of the fluidpaper preset
constexpr int DIM = 2;
constexpr int ROWS = 2 * DIM + 2;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

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

// (w & 0x7FFFFF) 2^-23 + 1e-12. The product is exact, and so is 1.m - 1
// (the mantissa under a unit exponent, minus one): the same float without
// an integer-to-float conversion, a quarter-rate instruction.
__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __fadd_rn(
      __fsub_rn(__uint_as_float(0x3F800000u | (w & 0x7FFFFFu)), 1.f), 1e-12f);
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

// The proposal of chain c (global index chain_base + c) at sweep s:
// (y0, y1, lp(y), accept uniform).
template <bool EXT>
__device__ __forceinline__ float4 propose(const float* __restrict__ u,
                                          size_t stride, int n_chains,
                                          uint32_t k0, uint32_t k1,
                                          unsigned chain_base, int c, int s,
                                          const float* off, float bound) {
  constexpr float INV_DIM = 1.f / DIM;
  float uu[ROWS];
  if (EXT) {
    const float* col = u + (size_t)s * n_chains + c;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) uu[r] = __ldcs(col + r * stride);
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
  return make_float4(prop[0], prop[1], cos_bump_lp(prop, off),
                     uu[2 * DIM + 1]);
}

// One block per tile of TC chains; warp 0 scans, the others propose. The
// chunks hold ks_max sweeps (the last one what is left), two buffers of
// ks_max * TC pairs in dynamic shared memory.
template <int TC, bool EXT>
__global__ void __launch_bounds__(MAX_THREADS) metropolis_kernel(
    const float* __restrict__ init, const float* __restrict__ offset,
    float bound, const float* __restrict__ u, unsigned long long seed,
    unsigned chain_base, int n_chains, int n_steps, int ks_max,
    float* __restrict__ samples, float* __restrict__ final_states,
    unsigned long long* __restrict__ n_acc) {
  static_assert(TC <= WARP, "a chain per lane of the scan warp");
  extern __shared__ float4 buf[];
  const int n_threads = blockDim.x;
  const int c0 = blockIdx.x * TC;
  const int n_chunks = (n_steps + ks_max - 1) / ks_max;
  const int chunk = ks_max * TC;
  float off[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) off[k] = offset[k];

  if (threadIdx.x < WARP) {
    // the scan: lane = chain of the tile
    const int lane = threadIdx.x;
    const bool live = lane < TC;
    const int c = c0 + lane;
    float x[DIM] = {0.f, 0.f}, lp = 0.f;
    unsigned acc = 0;
    if (live) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) x[k] = init[(size_t)c * DIM + k];
      lp = cos_bump_lp(x, off);
    }
    float2* out = reinterpret_cast<float2*>(samples) + c;
    for (int k = 0; k < n_chunks; ++k) {
      const int b = k & 1, s0 = k * ks_max;
      const int ks = min(ks_max, n_steps - s0);
      bar_sync(BAR_FULL + b, n_threads);
      if (live) {
        const float4* v = buf + b * chunk + lane;
        for (int j = 0; j < ks; j += SCAN_UNROLL) {
          float4 w[SCAN_UNROLL];
#pragma unroll
          for (int i = 0; i < SCAN_UNROLL; ++i) w[i] = v[(j + i) * TC];
#pragma unroll
          for (int i = 0; i < SCAN_UNROLL; ++i) {
            if (w[i].w < expf(__fsub_rn(w[i].z, lp))) {
              x[0] = w[i].x;
              x[1] = w[i].y;
              lp = w[i].z;
              ++acc;
            }
            __stcs(out + (size_t)(s0 + j + i) * n_chains,
                   make_float2(x[0], x[1]));
          }
        }
      }
      __syncwarp();
      // the producers wait for this buffer only before chunk k + 2
      if (k + 2 < n_chunks) bar_arrive(BAR_EMPTY + b, n_threads);
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) final_states[(size_t)c * DIM + k] = x[k];
    }
    unsigned long long total = acc;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      total += __shfl_xor_sync(FULL_MASK, total, m);
    if (lane == 0 && total) atomicAdd(n_acc, total);
  } else {
    // the proposals: pair p of a chunk is (sweep s0 + p / TC, chain
    // p % TC); the loop's bound is the same for the whole warp
    const int t = threadIdx.x - WARP, n_prop = n_threads - WARP;
    const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
    const size_t stride = (size_t)n_steps * n_chains;
    for (int k = 0; k < n_chunks; ++k) {
      const int b = k & 1, s0 = k * ks_max;
      const int n_pairs = min(ks_max, n_steps - s0) * TC;
      if (k >= 2) bar_sync(BAR_EMPTY + b, n_threads);
      float4* dst = buf + b * chunk;
      for (int p0 = 0; p0 < n_pairs; p0 += n_prop) {
        const int p = p0 + t;
        if (p < n_pairs)
          dst[p] = propose<EXT>(u, stride, n_chains, k0, k1, chain_base,
                                c0 + p % TC, s0 + p / TC, off, bound);
      }
      __syncwarp();
      bar_arrive(BAR_FULL + b, n_threads);
    }
  }
}

template <int TC>
cudaError_t launch(const float* init, const float* offset, float bound,
                   const float* u, unsigned long long seed,
                   unsigned chain_base, int n_chains, int n_steps,
                   int tile_sweeps, int threads, size_t smem, float* samples,
                   float* final_states, unsigned long long* n_acc,
                   cudaStream_t s) {
  const int blocks = n_chains / TC;
  if (u)
    metropolis_kernel<TC, true><<<blocks, threads, smem, s>>>(
        init, offset, bound, u, seed, chain_base, n_chains, n_steps,
        tile_sweeps, samples, final_states, n_acc);
  else
    metropolis_kernel<TC, false><<<blocks, threads, smem, s>>>(
        init, offset, bound, u, seed, chain_base, n_chains, n_steps,
        tile_sweeps, samples, final_states, n_acc);
  return cudaGetLastError();
}

}  // namespace

// C entry point: zeroes n_acc and launches on ``stream``; returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a shape or
// tile plan the kernel does not take). init (C, 2) f32, offset (2,) f32,
// u (6, n_steps * C) f32 or NULL for the Philox stream of ``seed`` (chain
// c's counter word is chain_base + c); the tile plan (kernels/metropolis.py
// tile_plan): tile_chains TC in {8, 16, 32} dividing C, tile_sweeps KS and
// n_steps multiples of SCAN_UNROLL, threads = 32 (the scan warp) + at least
// one proposal warp, at most MAX_THREADS; outputs samples (n_steps * C, 2)
// sweep-major, final_states (C, 2) and n_acc, one int64.
extern "C" int metropolis_f32(const float* init, const float* offset,
                              float bound, const float* u,
                              unsigned long long seed, int chain_base,
                              int n_chains, int n_steps, int tile_chains,
                              int tile_sweeps, int threads, float* samples,
                              float* final_states, void* n_acc, void* stream) {
  const size_t smem = (size_t)2 * tile_sweeps * tile_chains * PAIR_BYTES;
  if (n_chains <= 0 || n_steps <= 0 || chain_base < 0 ||
      n_steps % SCAN_UNROLL || tile_sweeps <= 0 ||
      tile_sweeps % SCAN_UNROLL || threads % WARP || threads < 2 * WARP ||
      threads > MAX_THREADS || tile_chains <= 0 || n_chains % tile_chains ||
      smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto* acc = static_cast<unsigned long long*>(n_acc);
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t z = cudaMemsetAsync(acc, 0, sizeof(*acc), s);
  if (z != cudaSuccess) return (int)z;
  const unsigned base = (unsigned)chain_base;
  switch (tile_chains) {
    case 8:
      return (int)launch<8>(init, offset, bound, u, seed, base, n_chains,
                            n_steps, tile_sweeps, threads, smem, samples,
                            final_states, acc, s);
    case 16:
      return (int)launch<16>(init, offset, bound, u, seed, base, n_chains,
                             n_steps, tile_sweeps, threads, smem, samples,
                             final_states, acc, s);
    case 32:
      return (int)launch<32>(init, offset, bound, u, seed, base, n_chains,
                             n_steps, tile_sweeps, threads, smem, samples,
                             final_states, acc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
