// Triangle Gram of the TDVP statistics, S = O^T diag(w) O (w optional and
// of any sign), from an f32 operand in three bf16 tensor-core passes:
//
//   x = hi + lo,  hi = bf16_rn(x),  lo = bf16_rn(x - hi)
//   S_IJ += A_hi B_hi^T + A_hi B_lo^T + A_lo B_hi^T    (A = O w, B = O)
//
// Replaces the TPU kernel vmc_pde_tpu/kernels/syrk.py::syrk (_syrk_kernel)
// and, like it, splits the operand once outside the product:
//
// 1. split_kernel (syrk_split_bf16): one memory-bound pass reads the
//    feature-major X (P, N) -- the per-sample kernel's storage of O -- and
//    w once and writes the bf16 halves of A (and, weighted, of B = X) as
//    (P, Np) row-major arrays, Np = N rounded up to PAD with zeros, so
//    every row is a multiple of 16 bytes (the tensor maps' row stride).
//    x w is rounded in f32 (__fmul_rn) first, as the plain version's O * w.
//
// 2. tiles_kernel (syrk_tiles_bf16): the lower-triangle TILE x TILE output
//    tiles (I >= J), one persistent block per SM walking a tile list that
//    the caller orders in square groups (kernels/syrk.py::tile_list), so
//    the blocks in flight share their operand rows in L2. Per block one
//    producer warp issues TMA loads (128-byte swizzle) of the row tiles
//    I and J, KBOX samples of hi and lo each, into a ring of STAGES stages
//    with full and empty mbarriers; two consumer warpgroups each own 64
//    rows of the tile and issue wgmma m64n128k16 bf16 -> f32 from shared
//    memory, three per 16 samples. The card's tensor cores truncate as
//    they accumulate (a bf16 product over 65536 samples comes out ~6e-5
//    low), so an accumulation takes at most FLUSH stages (512 samples)
//    and is then added into a separate f32 total with ordinary rounded
//    adds; the next one restarts with scale-d = 0. The epilogue writes an
//    off-diagonal tile at (I, J) and its transpose at (J, I) (streaming
//    stores, whole 32-byte sectors in both orientations) and a diagonal
//    tile in full, as computed: S comes out mirrored, with exactly the
//    values of a select of the lower tiles over the upper ones. The entry
//    launches the product once per KCHUNK stages (16384 samples): each
//    launch starts from the totals the previous one stored in the lower
//    tiles, so the sums are the same rounded adds as in one launch, and
//    only the last one writes the mirror. Short launches keep the blocks'
//    sample positions in step, so the operand rows they share stay in L2
//    (tools/gram_probe.py: one launch over N = 65536 is ~1.5x slower).
//
// Bound on the card: tensor-core operations. At N = 16384, P = 9264 the
// lower triangle is ~3 N P^2 bf16 operations, ~4.3 ms at 989 TFLOP/s. A
// stage brings 64 KB for 6.3 MFLOP (96 flop per byte), so at full rate the
// SMs would draw ~10 TB/s of operands, mostly out of L2; device memory
// sees each operand row once per wave of blocks that shares it. ptxas
// reports a warpgroup.wait it injects where the K loop exits: every path
// out of the loop has already waited for all products, so it costs
// nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TILE = 128;           // output tile edge
constexpr int KBOX = 64;            // samples per stage: one 128-byte row
constexpr int STAGES = 3;           // ring depth
constexpr int FLUSH = 8;            // stages per tensor-core accumulation
constexpr int KCHUNK = 256;         // stages per launch (a multiple of FLUSH)
constexpr int PAD = 8;              // Np is a multiple of PAD samples
constexpr int THREADS = 384;        // producer warpgroup + 2 consumers
constexpr int SPLIT_THREADS = 256;  // split pass: 8 samples per thread
constexpr int OP_BYTES = TILE * KBOX * 2;
constexpr int STAGE_BYTES = 4 * OP_BYTES;  // A hi, A lo, B hi, B lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// ---- split pass -----------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi and lo of 8 values, stored as one 16-byte vector each
__device__ __forceinline__ void split8(const float (&x)[8],
                                       __nv_bfloat16* hi,
                                       __nv_bfloat16* lo) {
  float h[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = __bfloat162float(__float2bfloat16_rn(x[e]));
    l[e] = __fsub_rn(x[e], h[e]);
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(
      pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]),
      pack2(h[6], h[7]));
  *reinterpret_cast<uint4*>(lo) = make_uint4(
      pack2(l[0], l[1]), pack2(l[2], l[3]), pack2(l[4], l[5]),
      pack2(l[6], l[7]));
}

__device__ __forceinline__ void load8(const float* src, int k0, int N,
                                      bool vec, float (&x)[8]) {
  if (vec && k0 + 8 <= N) {
    const float4 u = __ldcs(reinterpret_cast<const float4*>(src + k0));
    const float4 v = __ldcs(reinterpret_cast<const float4*>(src + k0 + 4));
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = k0 + e < N ? src[k0 + e] : 0.f;
  }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(SPLIT_THREADS) split_kernel(
    const float* __restrict__ X, const float* __restrict__ w, int P, int N,
    long long ldx, int Np, bool xvec, bool wvec,
    __nv_bfloat16* __restrict__ ops) {
  const int k0 = (blockIdx.x * SPLIT_THREADS + threadIdx.x) * 8;
  if (k0 >= Np) return;
  const size_t plane = (size_t)P * Np;
  float wv[8];
  if (WEIGHTED) load8(w, k0, N, wvec, wv);
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    float x[8];
    load8(X + (size_t)p * ldx, k0, N, xvec, x);
    const size_t at = (size_t)p * Np + k0;
    if (WEIGHTED) {
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = __fmul_rn(x[e], wv[e]);
      split8(a, ops + at, ops + plane + at);
      split8(x, ops + 2 * plane + at, ops + 3 * plane + at);
    } else {
      split8(x, ops + at, ops + plane + at);
    }
  }
}

// ---- product: mbarriers, TMA, wgmma ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of ``parity`` to complete. A wait of more than ~2^32
// cycles (seconds) traps: a ring out of step fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0)
      start = now;
    else if (now - start > (1ll << 32))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T over 16 samples: A 64 rows, B 128 rows, both K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// one stage: 64 samples in four k16 steps, three passes each; descriptors
// advance 32 bytes per step inside the swizzled 128-byte rows
__device__ __forceinline__ void mma_stage(float (&acc)[64], uint64_t a_hi,
                                          uint64_t a_lo, uint64_t b_hi,
                                          uint64_t b_lo, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KBOX / 16; ++kk) {
    const uint64_t step = 2 * kk;
    wgmma_m64n128k16(acc, a_hi + step, b_hi + step, !(fresh && kk == 0));
    wgmma_m64n128k16(acc, a_hi + step, b_lo + step, 1);
    wgmma_m64n128k16(acc, a_lo + step, b_hi + step, 1);
  }
}

__global__ void __launch_bounds__(THREADS, 1) tiles_kernel(
    const __grid_constant__ CUtensorMap a_hi,
    const __grid_constant__ CUtensorMap a_lo,
    const __grid_constant__ CUtensorMap b_hi,
    const __grid_constant__ CUtensorMap b_lo, const int2* __restrict__ tiles,
    int ntiles, int P, int kt0, int kt1, bool first, bool last,
    float* __restrict__ S) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle's alignment
  const uint32_t full = ring + STAGES * STAGE_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int2 ij = tiles[t];
        for (int kt = kt0; kt < kt1; ++kt) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s, dst = ring + s * STAGE_BYTES;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(dst, &a_hi, kt * KBOX, ij.x * TILE, bar);
          tma_load(dst + OP_BYTES, &a_lo, kt * KBOX, ij.x * TILE, bar);
          tma_load(dst + 2 * OP_BYTES, &b_hi, kt * KBOX, ij.y * TILE, bar);
          tma_load(dst + 3 * OP_BYTES, &b_lo, kt * KBOX, ij.y * TILE, bar);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 (wg - 1) .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int row0 = (wg - 1) * 64 + 16 * warp + lane / 4;
    const int col0 = 2 * (lane & 3);
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int s = 0, prev = -1;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int2 ij = tiles[t];
      const int I = ij.x * TILE, J = ij.y * TILE;
      // the total so far: zero, or what the previous launch stored
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = I + row0 + 8 * (e >> 1);
          const int c = J + 8 * i + col0 + (e & 1);
          tot[4 * i + e] =
              first || r >= P || c >= P ? 0.f : S[(size_t)r * P + c];
        }
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t base = ring + s * STAGE_BYTES;
        const uint32_t a = base + (wg - 1) * 64 * 128;
        const bool flush = (kt - kt0) % FLUSH == FLUSH - 1 || kt == kt1 - 1;
        fence_regs(acc);
        wgmma_fence();
        mma_stage(acc, smem_desc(a), smem_desc(a + OP_BYTES),
                  smem_desc(base + 2 * OP_BYTES),
                  smem_desc(base + 3 * OP_BYTES), (kt - kt0) % FLUSH == 0);
        wgmma_commit();
        fence_regs(acc);
        if (flush) {
          // the accumulation ends: add it into the total, rounded
          wgmma_wait<0>();
          fence_regs(acc);
          if (lane == 0) {
            if (prev >= 0) mbar_arrive(empty + 8 * prev);
            mbar_arrive(empty + 8 * s);
          }
          prev = -1;
#pragma unroll
          for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
        } else {
          // keep this stage's products in flight, free the previous one
          wgmma_wait<1>();
          fence_regs(acc);
          if (lane == 0 && prev >= 0) mbar_arrive(empty + 8 * prev);
          prev = s;
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      // epilogue: (I, J) and, in the last launch and off the diagonal, its
      // mirror (J, I)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = I + row0 + 8 * (e >> 1);
          const int c = J + 8 * i + col0 + (e & 1);
          if (r < P && c < P) {
            __stcs(S + (size_t)r * P + c, tot[4 * i + e]);
            if (last && I != J)
              __stcs(S + (size_t)c * P + r, tot[4 * i + e]);
          }
        }
      }
    }
  }
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (P, Np) bf16 row-major, boxes of TILE rows x KBOX samples, 128-byte
// swizzle; rows past P and samples past Np read as zeros
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int P,
                  int Np) {
  const cuuint64_t dims[2] = {(cuuint64_t)Np, (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)Np * 2};
  const cuuint32_t box[2] = {KBOX, TILE};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// C entry points. Each launches on ``stream`` and returns 0 on success, a
// CUDA runtime error code (cudaErrorInvalidValue for shapes it does not
// take), or for a tensor map the driver refused -1000 - its CUresult
// (-1000 alone if cuTensorMapEncodeTiled was not found).

// The split pass: X (P, N) f32 with unit sample stride and row stride ldx,
// w (N,) f32 or NULL; writes ops = [A_hi, A_lo] (unweighted) or [A_hi,
// A_lo, B_hi, B_lo] (weighted, A = X w, B = X), each (P, Np) bf16 with
// zeros in the samples N .. Np - 1; Np >= N a multiple of PAD.
extern "C" int syrk_split_bf16(const float* X, const float* w, int P, int N,
                               long long ldx, int Np, void* ops,
                               void* stream) {
  if (P <= 0 || N <= 0 || Np < N || Np % PAD || (P > 1 && ldx < N))
    return (int)cudaErrorInvalidValue;
  const bool xvec = ((uintptr_t)X % 16 == 0) && (ldx % 4 == 0);
  const bool wvec = ((uintptr_t)w % 16 == 0);
  const dim3 grid((Np / 8 + SPLIT_THREADS - 1) / SPLIT_THREADS,
                  P < 65535 ? P : 65535);
  auto* out = static_cast<__nv_bfloat16*>(ops);
  const cudaStream_t s = (cudaStream_t)stream;
  if (w)
    split_kernel<true><<<grid, SPLIT_THREADS, 0, s>>>(X, w, P, N, ldx, Np,
                                                      xvec, wvec, out);
  else
    split_kernel<false><<<grid, SPLIT_THREADS, 0, s>>>(X, w, P, N, ldx, Np,
                                                       xvec, wvec, out);
  return (int)cudaGetLastError();
}

// The product: ops as the split pass wrote them (n_ops 2 or 4), tiles the
// (ntiles, 2) int32 list of lower tiles (I, J), I >= J, covering every one
// once; writes all of S (P, P) f32 row-major.
extern "C" int syrk_tiles_bf16(const void* ops, int n_ops, int P, int Np,
                               const int* tiles, int ntiles, float* S,
                               void* stream) {
  const int nb = (P + TILE - 1) / TILE;
  if (P <= 0 || Np <= 0 || Np % PAD || (n_ops != 2 && n_ops != 4) ||
      ntiles != nb * (nb + 1) / 2)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return -1000;
  const auto* base = static_cast<const __nv_bfloat16*>(ops);
  const size_t plane = (size_t)P * Np;
  CUtensorMap maps[4];
  for (int m = 0; m < 4; ++m) {
    // unweighted: B is A
    const CUresult r = make_map(enc, &maps[m], base + (m % n_ops) * plane,
                                P, Np);
    if (r != CUDA_SUCCESS) return -1000 - (int)r;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = ntiles < sms ? ntiles : sms;
  const int nk = (Np + KBOX - 1) / KBOX;
  for (int kt0 = 0; kt0 < nk; kt0 += KCHUNK) {
    const int kt1 = kt0 + KCHUNK < nk ? kt0 + KCHUNK : nk;
    tiles_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        maps[0], maps[1], maps[2], maps[3],
        reinterpret_cast<const int2*>(tiles), ntiles, P, kt0, kt1, kt0 == 0,
        kt1 == nk, S);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
