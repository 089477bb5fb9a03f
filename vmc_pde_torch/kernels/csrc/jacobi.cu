// Symmetric eigendecomposition of one small matrix on the device: the
// parallel cyclic Jacobi method, in one block or in a thread block
// cluster of 8 blocks.
//
//   A = V diag(w) V^T,  w ascending, V's columns the eigenvectors
//
// Replaces no TPU kernel: the JAX package's small eigensolves (the top-k
// Ritz matrix of the Cholesky path, vmc_pde_tpu/solver/tdvp.py's
// _randomized_topk_eigh, and the spectral solve of P <= eigh_max_params
// parameters) are jnp.linalg.eigh, which XLA runs inside the step
// program. torch.linalg.eigh on the card reads cuSOLVER's info flag on the
// host after every call, which stops the TDVP step from being captured
// into a CUDA graph; this kernel runs the whole solve on the device and
// never waits.
//
// Bound on the card: latency. A (72, 72) solve moves 41 KB and does ~10^7
// flops over its sweeps, ~3 us of work at the card's rates; a round of
// m/2 rotations is ~30k flops spread over one block, so what sets the time
// is the instructions a round issues and the barriers between rounds.
//
// Layout. The matrix's columns live in slots: block b of a cluster of B
// holds 2w of them (m = 2 B w, n padded with zero rows and columns), A's
// and V's entries of a slot stored as a column (stride m + 1) indexed by
// the matrix's row, and idx[slot] the column's index. A round pairs each
// block's slots into w disjoint pairs, so both columns of a pair are
// always local: the rotation (c, s) of a pair is computed from local
// entries, then written into every block's table of the round's m/2
// rotations (distributed shared memory), and after one cluster barrier
// each block applies the whole round to its own columns in one fused
// two-sided pass: thread (l, g) owns pair l and updates, for the row
// pairs k = g, g + rows, ..., the 2 x 2 block A[{p_k, q_k}, {p_l, q_l}]
// <- J_k^T A J_l (the diagonal block k = l directly: A_pp - t A_pq,
// A_qq + t A_pq, zeros), and V's rows i = g, g + rows, ... of the pair's
// columns. Two barriers a round (the table is double-buffered by round
// parity, so the next round's writes never meet this round's reads); no
// division or modulo by a runtime value inside a round: the pairs are
// conditional adds and subtracts of the round number.
//
// Ordering. A sweep runs 2B - 1 super-rounds. In the first each block
// runs a full round robin over its 2w slots (2w - 1 rounds); in each
// later one it pairs its first half X with its second half Y (w rounds,
// X[l] with Y[(l + r) mod w]). Between super-rounds the 2B halves move
// one step along the circle X_1 -> X_2 -> ... -> X_{B-1} -> Y_{B-1} ->
// Y_{B-2} -> ... -> Y_0 -> X_1 (X_0 stays): the circle method's
// tournament of the halves, so every pair of columns meets once a sweep
// (m - 1 rounds). The halves move through registers in chunks, between
// cluster barriers. With B = 1 there is one super-round and no move.
//
// A sweep ends with the off-diagonal mass summed over the cluster in a
// fixed order (every block takes the same decision); the solve stops when
// it falls below (n eps)^2 of the total, when it stops shrinking, or
// after MAX_SWEEPS. The lower triangle is read, as torch.linalg.eigh reads
// it. The eigenvalues are gathered into every block and ranked (ties by
// index); each block writes its columns' eigenpairs at their ranks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int CLUSTER_BLOCKS = 8;  // the portable cluster size
constexpr int MAX_SWEEPS = 30;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
// a batch of A's row pairs against one of V's rows in a thread's work
// (make_plan)
constexpr int A_BATCH_COST = 2;

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float value = FLT_EPSILON;
};
template <>
struct Eps<double> {
  static constexpr double value = DBL_EPSILON;
};

// the rotation of one pair of a round: s = sin, tau = s / (1 + c) and
// t = s / c of its angle, the pair's indices p and q packed as p | q << 16
template <typename T>
struct alignas(16) Rot {
  T s, tau, t;
  int pq;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of one block, region by region: A's columns and V's
// (stride m + 1: odd, so that a warp's consecutive columns fall in
// distinct banks); two tables of a round's rotations; slot -> index and
// slot -> rank; the blocks' and the warps' partial sums.
template <typename T>
__host__ __device__ size_t smem_layout(int m, int w, int blocks,
                                       size_t* off) {
  const size_t S = 2 * (size_t)w, ld = (size_t)m + 1;
  size_t o = 0;
  off[0] = o;
  o = align16(o + S * ld * sizeof(T));
  off[1] = o;
  o = align16(o + S * ld * sizeof(T));
  off[2] = o;
  o = align16(o + 2 * (size_t)(m / 2) * sizeof(Rot<T>));
  off[3] = o;
  o = align16(o + 2 * S * sizeof(int));
  off[4] = o;
  o = align16(o + (2 * (size_t)blocks + 64) * sizeof(T));
  return o;
}

template <bool CLUSTER>
__device__ __forceinline__ void sync_all() {
  if (CLUSTER) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// the same shared-memory object in block `rank` of the cluster
template <bool CLUSTER, typename P>
__device__ __forceinline__ P* peer(P* p, int rank) {
  return CLUSTER ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1 / sqrt(x): in f32 the hardware's approximation and one Newton step
// (~1 ulp, so that c^2 + s^2 = 1 to rounding)
__device__ __forceinline__ float inv_sqrt(float x) {
  const float y = rsqrtf(x);
  return y * (1.5f - 0.5f * x * y * y);
}
__device__ __forceinline__ double inv_sqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float quotient(float a, float b) {
  return __fdividef(a, b);
}
// a / b in f64: the hardware's approximate reciprocal and two Newton
// steps (each doubles its ~20 correct bits), a few FMAs where the IEEE
// division is a long sequence
__device__ __forceinline__ double quotient(double a, double b) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(b));
  r = fma(r, fma(-b, r, 1.0), r);
  r = fma(r, fma(-b, r, 1.0), r);
  return a * r;
}

// the rotation that zeroes A_pq (identity unless `live`): t = tan of its
// angle, from d = A_qq - A_pp without squaring A_pq / d
template <typename T>
__device__ __forceinline__ Rot<T> rotation(T app, T aqq, T apq, bool live,
                                           int pq) {
  Rot<T> rot;
  rot.s = 0;
  rot.tau = 0;
  rot.t = 0;
  rot.pq = pq;
  if (live) {
    const T d = aqq - app;
    const T t = quotient(d >= T(0) ? 2 * apq : -2 * apq,
                         fabs(d) + sqrt(d * d + 4 * apq * apq));
    const T c = inv_sqrt(T(1) + t * t);
    rot.s = t * c;
    rot.tau = quotient(rot.s, T(1) + c);
    rot.t = t;
  }
  return rot;
}

// (x, y) <- (c x - s y, s x + c y) as x - s (y + tau x), y + s (x - tau y)
// (Rutishauser): c itself rounds to 1 once t^2 < eps, and c x - s y would
// then grow the pair's norm by t^2 / 2 at every late rotation
template <typename T>
__device__ __forceinline__ void rotate(const Rot<T>& r, T& x, T& y) {
  const T x0 = x;
  x = x0 - r.s * (y + r.tau * x0);
  y = y + r.s * (x0 - r.tau * y);
}

// the 2 x 2 block X = A[{p_k, q_k}, {p_l, q_l}] <- J_k^T X J_l: rows by
// row pair k's rotation, then columns by the thread's own pair's; the
// diagonal block (k = l) directly
template <typename T>
__device__ __forceinline__ void rotate_block(const Rot<T>& rk,
                                             const Rot<T>& me, bool diag,
                                             T& x00, T& x01, T& x10,
                                             T& x11) {
  if (diag) {
    const T apq = x01;
    x00 -= me.t * apq;
    x11 += me.t * apq;
    x01 = 0;
    x10 = 0;
  } else {
    rotate(rk, x00, x10);
    rotate(rk, x01, x11);
    rotate(me, x00, x01);
    rotate(me, x10, x11);
  }
}

// CLUSTER: the grid is one cluster of CLUSTER_BLOCKS blocks (else one
// block)
template <bool CLUSTER, typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    jacobi_kernel(const T* __restrict__ a_in, int n, int m, int w, int rows,
                  T* __restrict__ w_out, T* __restrict__ v_out,
                  int* __restrict__ sweeps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int blocks = CLUSTER ? CLUSTER_BLOCKS : 1;
  const int b = blockIdx.x;
  const int S = 2 * w, ld = m + 1, half = m / 2;
  size_t off[5];
  smem_layout<T>(m, w, blocks, off);
  T* A = reinterpret_cast<T*>(smem_raw + off[0]);  // slot s at A + s * ld
  T* V = reinterpret_cast<T*>(smem_raw + off[1]);  // slot s at V + s * ld
  Rot<T>* tab = reinterpret_cast<Rot<T>*>(smem_raw + off[2]);
  int* idx = reinterpret_cast<int*>(smem_raw + off[3]);
  int* rnk = idx + S;
  T* part = reinterpret_cast<T*>(smem_raw + off[4]);  // (off, tot) a block
  T* red = part + 2 * blocks;                          // (off, tot) a warp
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // thread (l, g) of the round's update; the threads past w * rows (the
  // block is rounded up to whole warps) own no pair
  const int l = tid % w;
  const int g = tid < w * rows ? tid / w : m;

  for (int e = tid; e < S * m; e += nthreads) {
    const int s = e / m, i = e - s * m;
    const int j = b * S + s;
    T a = 0;
    if (i < n && j < n) {
      a = i >= j ? a_in[(size_t)i * n + j] : a_in[(size_t)j * n + i];
    }
    A[s * ld + i] = a;
    V[s * ld + i] = i == j ? T(1) : T(0);
  }
  if (tid < S) idx[tid] = b * S + tid;
  // every block of the cluster runs before any writes into another's
  // shared memory
  sync_all<CLUSTER>();

  T prev = T(-1);
  int sweep = 0, parity = 0;
  while (sweep < MAX_SWEEPS) {
    ++sweep;
    for (int sr = 0; sr < 2 * blocks - 1; ++sr) {
      const int n_rounds = sr == 0 ? S - 1 : w;
      for (int r = 0; r < n_rounds; ++r) {
        int sp, sq;  // the slots of pair l
        if (sr == 0) {
          if (l == 0) {
            sp = r;
            sq = S - 1;
          } else {
            sp = r + l;
            if (sp >= S - 1) sp -= S - 1;
            sq = r - l;
            if (sq < 0) sq += S - 1;
          }
        } else {
          sp = l;
          sq = l + r;
          if (sq >= w) sq -= w;
          sq += w;
        }
        Rot<T>* tb = tab + parity * half;
        parity ^= 1;
        __syncthreads();  // the last update (or move) is in place
        if (g < blocks) {
          // pair l's rotation, computed by `blocks` threads, each of which
          // writes it into one block's table
          const int p = idx[sp], q = idx[sq];
          const T apq = A[sq * ld + p];
          peer<CLUSTER>(tb, g)[b * w + l] =
              rotation(A[sp * ld + p], A[sq * ld + q], apq,
                       p < n && q < n && apq != T(0), p | (q << 16));
        }
        sync_all<CLUSTER>();
        // the fused update of this block's columns: every thread's loads
        // of a batch before its stores (two row pairs of A, four rows of
        // V)
        const int mine = b * w + l;
        const Rot<T> me = tb[mine];
        T* cp = A + sp * ld;
        T* cq = A + sq * ld;
        for (int k0 = g; k0 < half; k0 += 2 * rows) {
          const int k1 = k0 + rows < half ? k0 + rows : k0;
          const Rot<T> r0 = tb[k0], r1 = tb[k1];
          const int p0 = r0.pq & 0xffff, q0 = r0.pq >> 16;
          const int p1 = r1.pq & 0xffff, q1 = r1.pq >> 16;
          T a00 = cp[p0], a01 = cq[p0], a10 = cp[q0], a11 = cq[q0];
          T b00 = cp[p1], b01 = cq[p1], b10 = cp[q1], b11 = cq[q1];
          rotate_block(r0, me, k0 == mine, a00, a01, a10, a11);
          rotate_block(r1, me, k1 == mine, b00, b01, b10, b11);
          cp[p0] = a00;
          cq[p0] = a01;
          cp[q0] = a10;
          cq[q0] = a11;
          if (k1 != k0) {
            cp[p1] = b00;
            cq[p1] = b01;
            cp[q1] = b10;
            cq[q1] = b11;
          }
        }
        T* vp = V + sp * ld;
        T* vq = V + sq * ld;
        for (int i0 = g; i0 < n; i0 += 4 * rows) {
          T x[4], y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + j * rows < n ? i0 + j * rows : i0;
            x[j] = vp[i];
            y[j] = vq[i];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + j * rows;
            rotate(me, x[j], y[j]);
            if (i < n) {
              vp[i] = x[j];
              vq[i] = y[j];
            }
          }
        }
      }
      if constexpr (CLUSTER) {
        if (sr == 2 * blocks - 2) break;
        // move the halves: each chunk is read into registers before a
        // cluster barrier and written to its new place after it (a half's
        // LA entries of A, then its LV of V)
        __syncthreads();  // this block's last update is in place
        // where the halves X (0) and Y (1) go: (block, half), X_0 stays
        const int to_b[2] = {b == 0 ? -1 : (b < blocks - 1 ? b + 1 : b),
                             b == 0 ? 1 : b - 1};
        const int to_h[2] = {b < blocks - 1 ? 0 : 1, b == 0 ? 0 : 1};
        constexpr int STAGE = 32 / sizeof(T);  // values a thread carries
        const int LA = w * ld, LV = LA;
        for (int base = 0; base < LA + LV; base += STAGE * nthreads) {
          T buf[2][STAGE];
          int moved[2] = {0, 0};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int j = 0; j < STAGE; ++j) {
              const int e = base + j * nthreads + tid;
              if (e < LA + LV) {
                buf[h][j] = e < LA ? A[h * LA + e] : V[h * LV + e - LA];
              }
            }
            if (base == 0 && tid < w) moved[h] = idx[h * w + tid];
          }
          sync_all<CLUSTER>();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (to_b[h] < 0) continue;
            T* da = peer<CLUSTER>(A, to_b[h]) + to_h[h] * LA;
            T* dv = peer<CLUSTER>(V, to_b[h]) + to_h[h] * LV - LA;
#pragma unroll
            for (int j = 0; j < STAGE; ++j) {
              const int e = base + j * nthreads + tid;
              if (e < LA + LV) (e < LA ? da : dv)[e] = buf[h][j];
            }
            if (base == 0 && tid < w) {
              peer<CLUSTER>(idx, to_b[h])[to_h[h] * w + tid] = moved[h];
            }
          }
          sync_all<CLUSTER>();
        }
      }
    }

    // the off-diagonal and total mass of the cluster's columns
    __syncthreads();
    T o = 0, tot = 0;
    for (int e = tid; e < S * n; e += nthreads) {
      const int s = e / n, i = e - s * n;
      const int j = idx[s];
      if (j < n) {
        const T a = A[s * ld + i];
        tot += a * a;
        if (i != j) o += a * a;
      }
    }
    o = warp_sum(o);
    tot = warp_sum(tot);
    if (lane == 0) {
      red[2 * warp] = o;
      red[2 * warp + 1] = tot;
    }
    __syncthreads();
    if (warp == 0) {
      const int n_warps = nthreads >> 5;
      o = warp_sum(lane < n_warps ? red[2 * lane] : T(0));
      tot = warp_sum(lane < n_warps ? red[2 * lane + 1] : T(0));
      if (lane < blocks) {
        T* dst = peer<CLUSTER>(part, lane);
        dst[2 * b] = o;
        dst[2 * b + 1] = tot;
      }
    }
    sync_all<CLUSTER>();
    o = 0;
    tot = 0;
    for (int d = 0; d < blocks; ++d) {
      o += part[2 * d];
      tot += part[2 * d + 1];
    }
    const T tol = T(n) * Eps<T>::value;
    // converged, or no longer shrinking (rounding level)
    if (o <= tol * tol * tot || (prev >= 0 && o >= prev)) break;
    prev = o;
  }

  if (sweeps_out != nullptr && b == 0 && tid == 0) *sweeps_out = sweep;

  // every column's eigenvalue and index, gathered into every block (the
  // tables are free: every block has passed its last round)
  T* ev = reinterpret_cast<T*>(tab);
  int* ei = reinterpret_cast<int*>(ev + m);
  for (int s = tid; s < S; s += nthreads) {
    const int j = idx[s];
    const T lam = A[s * ld + j];
    for (int d = 0; d < blocks; ++d) {
      peer<CLUSTER>(ev, d)[b * S + s] = lam;
      peer<CLUSTER>(ei, d)[b * S + s] = j;
    }
  }
  sync_all<CLUSTER>();
  // no block touches another's shared memory from here on
  for (int s = tid; s < S; s += nthreads) {
    const int j = idx[s];
    int rank = -1;
    if (j < n) {
      const T lam = A[s * ld + j];
      rank = 0;
      for (int e = 0; e < m; ++e) {
        const int je = ei[e];
        const T le = ev[e];
        rank += je < n && (le < lam || (le == lam && je < j));
      }
      w_out[rank] = lam;
    }
    rnk[s] = rank;
  }
  __syncthreads();
  for (int e = tid; e < S * n; e += nthreads) {
    const int i = e / S, s = e - i * S;
    if (rnk[s] >= 0) v_out[(size_t)i * n + rnk[s]] = V[s * ld + i];
  }
}

// One launch at order n: m = n padded to 2 blocks w columns, `rows` row
// groups of w threads (`threads`: w rows rounded up to whole warps),
// `smem` bytes of shared memory a block.
struct Plan {
  int m, w, rows, threads;
  size_t smem;
};

// The launch at order n in one block or in a cluster of CLUSTER_BLOCKS;
// false where that variant cannot take n. The row groups: the fewest that
// give the least work to the busiest thread, ceil(m/2 / 2 rows) batches
// of two of A's row pairs and ceil(n / 4 rows) of four of V's rows (a
// batch is loaded whole before it is stored), an A batch weighing
// A_BATCH_COST; with w rows <= MAX_THREADS and at least `blocks` groups
// (a round's rotations are written into one block's table per group).
template <typename T>
bool make_plan(int n, bool cluster, Plan* p) {
  const int blocks = cluster ? CLUSTER_BLOCKS : 1;
  if (n < 1 || n > 0xffff) return false;
  const int m = (n + 2 * blocks - 1) / (2 * blocks) * (2 * blocks);
  const int w = m / (2 * blocks), half = m / 2;
  size_t off[5];
  const size_t smem = smem_layout<T>(m, w, blocks, off);
  int hi = half > n ? half : n;
  if (hi < blocks) hi = blocks;
  if (hi > MAX_THREADS / w) hi = MAX_THREADS / w;
  if (smem > (size_t)SMEM_LIMIT || hi < blocks) return false;
  int rows = blocks, cost = -1;
  for (int r = blocks; r <= hi; ++r) {
    const int c = A_BATCH_COST * ((half + 2 * r - 1) / (2 * r)) +
                  (n + 4 * r - 1) / (4 * r);
    if (cost < 0 || c < cost) {
      rows = r;
      cost = c;
    }
  }
  *p = Plan{m, w, rows, (w * rows + 31) / 32 * 32, smem};
  return true;
}

template <typename T>
int reach(bool cluster) {
  Plan p;
  int n = 0;
  while (make_plan<T>(n + 1, cluster, &p)) ++n;
  return n;
}

template <typename T>
int launch(const void* a, int n, int cluster, void* w, void* v,
           void* sweeps, void* stream) {
  Plan p;
  if (!make_plan<T>(n, cluster != 0, &p)) return (int)cudaErrorInvalidValue;
  auto kernel = cluster ? jacobi_kernel<true, T> : jacobi_kernel<false, T>;
  // the dynamic shared memory limit, raised once per variant, dtype and
  // device
  static bool raised[2][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  const int c = cluster != 0;
  if (!raised[c][dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    raised[c][dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c ? CLUSTER_BLOCKS : 1);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a), n, p.m, p.w,
                         p.rows, static_cast<T*>(w), static_cast<T*>(v),
                         static_cast<int*>(sweeps));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster: 0 for the one-block variant, 1 for the cluster's
// (kernels/jacobi.py picks it by order); sweeps (may be null): receives the
// number of sweeps the solve took. Refused where the variant cannot take
// n.
extern "C" int jacobi_eigh_f32(const void* a, int n, int cluster, void* w,
                               void* v, void* sweeps, void* stream) {
  return launch<float>(a, n, cluster, w, v, sweeps, stream);
}

extern "C" int jacobi_eigh_f64(const void* a, int n, int cluster, void* w,
                               void* v, void* sweeps, void* stream) {
  return launch<double>(a, n, cluster, w, v, sweeps, stream);
}

// the largest order a variant takes (kernels/jacobi.py's ONE_BLOCK_REACH
// and REACH state the same)
extern "C" int jacobi_reach(int f64, int cluster) {
  return f64 ? reach<double>(cluster != 0) : reach<float>(cluster != 0);
}
