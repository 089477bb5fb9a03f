// Fused int8 quantization and force partial of one (P, n) bf16 operand:
//
//   q8[p, i] = clamp(rint(x[p, i] * inv[p]), -127, 127)   (int8)
//   f[p, k]  = sum_i x[p, i] * V[i, k]                    (f32, k < kv <= 2)
//
// Replaces the TPU kernel vmc_pde_tpu/kernels/quant8.py::quant_force. On
// the chunked int8 path the operand is one half of the split per-sample
// kernel's (hi, lo) pair, already feature-major; q8 feeds the int8 cross
// product and f the force's hi/lo terms, so each operand is read once.
//
// Bound on the card: memory. At P = 9264, n = 65536 one call reads 1.21 GB
// and writes 0.61 GB, ~0.54 ms at 3.35 TB/s; the arithmetic is 3 flops per
// element. Design: each block takes ROWS rows over the whole n, so V (n x
// kv bf16) is read once per ROWS rows, from L2; each thread takes 8
// samples per iteration: their V as one (kv = 1) or two (kv = 2) 16-byte
// loads, then ROWS independent 16-byte loads of x, one per row, all in
// flight before any is used, and ROWS 8-byte streaming stores of q8.
// Measured (tools/gram_probe.py): 2 rows per block ran faster than 1 or
// 8, and without its V term the kernel is no faster, so moving x and q8
// sets its time (~3 TB/s). The f partials
// reduce across the warp by shuffles and across the block's warps through
// shared memory in a fixed order: no atomics, and two launches give the
// same bits. The multiply by the reciprocal scale is rounded (__fmul_rn)
// and rint rounds half to even, as torch.round and jnp.round do, so q8 is
// bit-identical to the plain version. The TPU's P <= 16384 VMEM gate has
// no counterpart here; n must be a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 2;  // rows per block
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ signed char quantize(float x, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f);
  return (signed char)(int)q;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    out[2 * j] = v.x;
    out[2 * j + 1] = v.y;
  }
}

template <int KV>
__global__ void __launch_bounds__(THREADS, 3) quant_force_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ inv,
    const __nv_bfloat16* __restrict__ V, int P, int n,
    signed char* __restrict__ q8, float* __restrict__ f) {
  const int p0 = blockIdx.x * ROWS;
  const int nrows = P - p0 < ROWS ? P - p0 : ROWS;  // the ragged last block
  float s[ROWS], acc[ROWS][KV];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    s[r] = r < nrows ? inv[p0 + r] : 0.f;
#pragma unroll
    for (int k = 0; k < KV; ++k) acc[r][k] = 0.f;
  }

  for (int i = threadIdx.x * 8; i < n; i += THREADS * 8) {
    // V[i .. i + 7, :] as KV 16-byte vectors (row-major (n, KV))
    float v[KV][8];
    {
      uint4 raw[KV];
#pragma unroll
      for (int h = 0; h < KV; ++h)
        raw[h] = __ldg(reinterpret_cast<const uint4*>(V + (size_t)i * KV) +
                       h);
      float flat[8 * KV];
#pragma unroll
      for (int h = 0; h < KV; ++h) {
        float part[8];
        unpack8(raw[h], part);
#pragma unroll
        for (int j = 0; j < 8; ++j) flat[8 * h + j] = part[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < KV; ++k) v[k][j] = flat[j * KV + k];
    }
    uint4 raw[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < nrows)
        raw[r] = *reinterpret_cast<const uint4*>(x + (size_t)(p0 + r) * n +
                                                  i);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) continue;
      float xf[8];
      unpack8(raw[r], xf);
      union {
        signed char c[8];
        uint2 u;
      } out;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out.c[j] = quantize(xf[j], s[r]);
#pragma unroll
        for (int k = 0; k < KV; ++k)
          acc[r][k] = fmaf(xf[j], v[k][j], acc[r][k]);
      }
      __stcs(reinterpret_cast<uint2*>(q8 + (size_t)(p0 + r) * n + i), out.u);
    }
  }

  __shared__ float part[THREADS / 32][ROWS * KV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      float t = acc[r][k];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) t += __shfl_xor_sync(FULL_MASK, t, m);
      if (lane == 0) part[warp][r * KV + k] = t;
    }
  __syncthreads();
  if (threadIdx.x < nrows * KV) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += part[w][threadIdx.x];
    f[(size_t)p0 * KV + threadIdx.x] = t;
  }
}

}  // namespace

// C entry point: launches on ``stream`` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for kv outside {1, 2}, n not a multiple
// of 8 or x, V not 16-byte aligned). x (P, n) bf16 row-major, inv (P,) f32,
// V (n, kv) bf16 row-major; outputs q8 (P, n) int8 and f (P, kv) f32.
extern "C" int quant_force_bf16(const void* x, const float* inv,
                                const void* V, int P, int n, int kv,
                                void* q8, float* f, void* stream) {
  if (n % 8 != 0 || P <= 0 || (uintptr_t)x % 16 ||
      (uintptr_t)V % 16 || (uintptr_t)q8 % 8)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* vb = static_cast<const __nv_bfloat16*>(V);
  auto* q = static_cast<signed char*>(q8);
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (P + ROWS - 1) / ROWS;
  if (kv == 1)
    quant_force_kernel<1><<<blocks, THREADS, 0, s>>>(xb, inv, vb, P, n, q,
                                                     f);
  else if (kv == 2)
    quant_force_kernel<2><<<blocks, THREADS, 0, s>>>(xb, inv, vb, P, n, q,
                                                     f);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
