// Triangle Gram of the TDVP statistics, S = O^T diag(w) O (w optional and
// of any sign), from an f32 operand in three bf16 tensor-core passes:
//
//   x = hi + lo,  hi = bf16_rn(x),  lo = bf16_rn(x - hi)
//   S_IJ += A_hi^T B_hi + A_hi^T B_lo + A_lo^T B_hi    (A = O w, B = O)
//
// Replaces the TPU kernel vmc_pde_tpu/kernels/syrk.py::syrk (_syrk_kernel).
// Only the lower-triangle 128 x 128 output tiles (I >= J) are computed, one
// thread block each; the caller mirrors them over the upper tiles with a
// select (kernels/syrk.py), never with arithmetic on the half this kernel
// does not write.
//
// Layout: the operand is feature-major, X (P, N) with row stride ldx, which
// is how the per-sample kernel writes O; a stage of 32 samples of a tile's
// 128 rows is then 128 contiguous 128-byte rows, loaded as float4, split
// into hi/lo while it is stored to shared memory as [row][sample] bf16
// (rows padded to 40 so the fragment loads hit 32 distinct banks), with
// the weight folded into the left operand first (x w rounded in f32, as the
// plain version's O * w). The next stage's loads are issued into registers
// before the current stage is multiplied, so they overlap.
//
// Products: mma.sync m16n8k16 bf16 -> f32; 8 warps, each a 64 x 32 piece of
// the tile. The card's tensor cores truncate as they accumulate (a bf16
// product over 65536 samples comes out ~6e-5 low), so the mma accumulators
// take at most FLUSH stages (512 samples, 3 passes each) before they are
// added into a separate f32 total with ordinary rounded adds and zeroed.
//
// Bound on the card: tensor-core operations. At N = 16384, P = 9264 the
// lower triangle (with the diagonal tiles in full) is ~3 N P^2 / 2 x 2
// bf16 operations, ~4.3 ms at 989 TFLOP/s; the operand is read once per
// tile row and column (from L2 mostly). mma.sync, no TMA or wgmma: a first
// version that is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int TILE = 128;
constexpr int KC = 32;
constexpr int LDS = KC + 8;
constexpr int THREADS = 256;
constexpr int FLUSH = 16;

struct Stage {
  __nv_bfloat16 ahi[TILE][LDS], alo[TILE][LDS];
  __nv_bfloat16 bhi[TILE][LDS], blo[TILE][LDS];
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_k,
                                         __nv_bfloat16 hi_k) {
  const __nv_bfloat162 v = __halves2bfloat162(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Split four consecutive samples of one row into their bf16 hi and lo
// halves and store both (8 bytes each).
__device__ __forceinline__ void split_store(float4 v, __nv_bfloat16* hi_dst,
                                            __nv_bfloat16* lo_dst) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  __nv_bfloat16 h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = __float2bfloat16_rn(f[e]);
    l[e] = __float2bfloat16_rn(__fsub_rn(f[e], __bfloat162float(h[e])));
  }
  *reinterpret_cast<uint2*>(hi_dst) = make_uint2(pack(h[0], h[1]),
                                                 pack(h[2], h[3]));
  *reinterpret_cast<uint2*>(lo_dst) = make_uint2(pack(l[0], l[1]),
                                                 pack(l[2], l[3]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(THREADS, 1)
    syrk_kernel(const float* __restrict__ X, const float* __restrict__ w,
                int P, int N, int ldx, float* __restrict__ S) {
  __shared__ __align__(16) Stage st;

  // lower-triangle tile t -> (I, J), I >= J, t = I (I + 1) / 2 + J
  const int t = blockIdx.x;
  int I = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  while (I * (I + 1) / 2 > t) --I;
  const int J = t - I * (I + 1) / 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mbase = (warp >> 2) * 64, nbase = (warp & 3) * 32;
  // this thread's share of a stage's loads: rows lr + 32 i, samples
  // 4 lq .. 4 lq + 3
  const int lr = tid >> 3, lq = tid & 7;

  float acc[4][4][4], tot[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  float4 va[4], vb[4];
  auto load = [&](int k0) {
    const int k = k0 + 4 * lq;
    float4 wv = make_float4(1.f, 1.f, 1.f, 1.f);
    if (WEIGHTED && k < N) wv = *reinterpret_cast<const float4*>(w + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 32 * i;
      const int pa = I * TILE + r, pb = J * TILE + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      va[i] = (pa < P && k < N)
                  ? *reinterpret_cast<const float4*>(X + (size_t)pa * ldx + k)
                  : zero;
      vb[i] = (pb < P && k < N)
                  ? *reinterpret_cast<const float4*>(X + (size_t)pb * ldx + k)
                  : zero;
      if (WEIGHTED) {
        va[i].x = __fmul_rn(va[i].x, wv.x);
        va[i].y = __fmul_rn(va[i].y, wv.y);
        va[i].z = __fmul_rn(va[i].z, wv.z);
        va[i].w = __fmul_rn(va[i].w, wv.w);
      }
    }
  };

  const int nk = (N + KC - 1) / KC;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous stage's fragments are read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 32 * i;
      split_store(va[i], &st.ahi[r][4 * lq], &st.alo[r][4 * lq]);
      split_store(vb[i], &st.bhi[r][4 * lq], &st.blo[r][4 * lq]);
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * KC);

#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nbase + 8 * j + g;
        bh[j][0] = lds32(&st.bhi[n][kk + 2 * tg]);
        bh[j][1] = lds32(&st.bhi[n][kk + 2 * tg + 8]);
        bl[j][0] = lds32(&st.blo[n][kk + 2 * tg]);
        bl[j][1] = lds32(&st.blo[n][kk + 2 * tg + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mbase + 16 * i + g;
        const uint32_t ah[4] = {lds32(&st.ahi[m][kk + 2 * tg]),
                                lds32(&st.ahi[m + 8][kk + 2 * tg]),
                                lds32(&st.ahi[m][kk + 2 * tg + 8]),
                                lds32(&st.ahi[m + 8][kk + 2 * tg + 8])};
        const uint32_t al[4] = {lds32(&st.alo[m][kk + 2 * tg]),
                                lds32(&st.alo[m + 8][kk + 2 * tg]),
                                lds32(&st.alo[m][kk + 2 * tg + 8]),
                                lds32(&st.alo[m + 8][kk + 2 * tg + 8])};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], ah, bh[j]);
          mma_bf16(acc[i][j], ah, bl[j]);
          mma_bf16(acc[i][j], al, bh[j]);
        }
      }
    }

    if (kt % FLUSH == FLUSH - 1 || kt == nk - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] = __fadd_rn(tot[i][j][e], acc[i][j][e]);
            acc[i][j][e] = 0.f;
          }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = I * TILE + mbase + 16 * i + g;
      const int col = J * TILE + nbase + 8 * j + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row + 8 * h;
        if (rr >= P) continue;
        float* dst = S + (size_t)rr * P + col;
        if (col < P) dst[0] = tot[i][j][2 * h];
        if (col + 1 < P) dst[1] = tot[i][j][2 * h + 1];
      }
    }
}

}  // namespace

// C entry point: launches on ``stream`` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for empty shapes or N, ldx not multiples
// of 4). X (P, N) f32 with row stride ldx and 16-byte aligned rows, w (N,)
// f32 or NULL; writes the lower-triangle 128 x 128 tiles of S (P, P) f32
// row-major (the diagonal tiles in full) and leaves the others untouched.
extern "C" int syrk_f32(const float* X, const float* w, int P, int N,
                        int ldx, float* S, void* stream) {
  if (P <= 0 || N <= 0 || N % 4 || ldx % 4 || ldx < N)
    return (int)cudaErrorInvalidValue;
  const int nb = (P + TILE - 1) / TILE;
  const int ntri = nb * (nb + 1) / 2;
  const cudaStream_t s = (cudaStream_t)stream;
  if (w)
    syrk_kernel<true><<<ntri, THREADS, 0, s>>>(X, w, P, N, ldx, S);
  else
    syrk_kernel<false><<<ntri, THREADS, 0, s>>>(X, w, P, N, ldx, S);
  return (int)cudaGetLastError();
}
