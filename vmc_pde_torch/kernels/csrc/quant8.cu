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
// element. Design: one block per row p (no two blocks share a row, so f
// needs no atomics), threads striding along n with 16-byte loads of 8 bf16
// and 8-byte stores of 8 int8; the f partials reduce across the warp by
// shuffles and across the block's warps in shared memory, in a fixed order.
// V (n x kv bf16, 256 KB at n = 65536) is read by every block and stays in
// L2. The multiply by the reciprocal scale is rounded (__fmul_rn) and rint
// rounds half to even, as torch.round and jnp.round do, so q8 is
// bit-identical to the plain version. The TPU's P <= 16384 VMEM gate has
// no counterpart here; n must be a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ signed char quantize(float x, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f);
  return (signed char)(int)q;
}

template <int KV>
__global__ void __launch_bounds__(THREADS) quant_force_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ inv,
    const __nv_bfloat16* __restrict__ V, int n, signed char* __restrict__ q8,
    float* __restrict__ f) {
  const int p = blockIdx.x;
  const float s = inv[p];
  const __nv_bfloat16* row = x + (size_t)p * n;
  signed char* qrow = q8 + (size_t)p * n;
  float acc[KV];
  for (int k = 0; k < KV; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x * 8; i < n; i += THREADS * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + i);
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
    union {
      signed char c[8];
      uint2 u;
    } out;
    for (int j = 0; j < 8; ++j) {
      const float xf = __bfloat162float(xv[j]);
      out.c[j] = quantize(xf, s);
      for (int k = 0; k < KV; ++k)
        acc[k] = fmaf(xf, __bfloat162float(V[(size_t)(i + j) * KV + k]),
                      acc[k]);
    }
    *reinterpret_cast<uint2*>(qrow + i) = out.u;
  }

  __shared__ float part[THREADS / 32][KV];
  for (int k = 0; k < KV; ++k) {
    float v = acc[k];
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < KV) {
    float v = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) v += part[w][threadIdx.x];
    f[(size_t)p * KV + threadIdx.x] = v;
  }
}

}  // namespace

// C entry point: launches on ``stream`` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for kv outside {1, 2} or n not a multiple
// of 8). x (P, n) bf16 row-major, inv (P,) f32, V (n, kv) bf16 row-major;
// outputs q8 (P, n) int8 and f (P, kv) f32.
extern "C" int quant_force_bf16(const void* x, const float* inv,
                                const void* V, int P, int n, int kv,
                                void* q8, float* f, void* stream) {
  if (n % 8 != 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* vb = static_cast<const __nv_bfloat16*>(V);
  auto* q = static_cast<signed char*>(q8);
  const cudaStream_t s = (cudaStream_t)stream;
  if (kv == 1)
    quant_force_kernel<1><<<P, THREADS, 0, s>>>(xb, inv, vb, n, q, f);
  else if (kv == 2)
    quant_force_kernel<2><<<P, THREADS, 0, s>>>(xb, inv, vb, n, q, f);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
