// Symmetric eigendecomposition of one small matrix on the device: the
// parallel cyclic Jacobi method, in one block up to order 168 (f32) / 118
// (f64), and as a block Jacobi spread over the card above that up to order
// 2048.
//
//   A = V diag(w) V^T,  w ascending, V's columns the eigenvectors
//
// Replaces no TPU kernel: the JAX package's small eigensolves (the top-k
// Ritz matrix of the Cholesky path, vmc_pde_tpu/solver/tdvp.py's
// _randomized_topk_eigh, and the spectral solve of P <= eigh_max_params =
// 2048 parameters) are jnp.linalg.eigh, which XLA runs inside the step
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
// ONE BLOCK (jacobi_kernel). The matrix's columns live in slots of shared
// memory (m = n padded to even, A's and V's entries of a slot stored as a
// column, stride m + 1, indexed by the matrix's row). A round's m/2
// disjoint pairs come from the round robin's circle (conditional adds of
// the round number, no runtime division); the rotation (c, s) of a pair
// is computed by one thread into a table, and after a barrier every thread
// (l, g) of the fused two-sided pass updates, for the row pairs k = g,
// g + rows, ..., the 2 x 2 block A[{p_k, q_k}, {p_l, q_l}] <- J_k^T A J_l
// (the diagonal block k = l directly: A_pp - t A_pq, A_qq + t A_pq,
// zeros), and V's rows i = g, g + rows, ... of its pair's columns. Two
// barriers a round (the table is double-buffered by round parity).
//
// BLOCKS (jacobi_block_kernel), above one block's reach. The padded order
// m (a multiple of 32) is cut into 2K column blocks of BW = 16; a sweep is
// 2K - 1 rounds, each of K disjoint block pairs from the circle method
// over the blocks, so that every pair of blocks meets once a sweep. In a
// round:
//   - each pair's 32 x 32 subproblem A[I, I] (I its two blocks' columns)
//     is rotated in shared memory by one CTA: one inner sweep, not to
//     convergence (the round robin over the 32 columns in a sweep's first
//     round, which also meets the pairs inside each block; the 16 rounds of
//     pairs across the two blocks in every other round), the rotations
//     accumulated into a 32 x 32 orthogonal Q (solve_pair: three roles,
//     one barrier an inner round); the rotated subproblem is written back,
//     and the pair's flag raised;
//   - the previous round's Q's are applied to V in panels of 32 rows
//     (V[:, I_j] <- V[:, I_j] Q_j), and every off-diagonal pair tile
//     A[I_i, I_j], i > j, becomes Q_i^T A[I_i, I_j] Q_j once its two
//     pairs' flags are up, written with its mirror A[I_j, I_i] (A stays
//     exactly symmetric; the lower tile alone is computed);
//   - one grid barrier.
// The products are small: A's in f32 on the CUDA cores (TF32 would
// truncate), each warp four rows of a 32 x 32 output, and in f64 on the
// tensor cores' f64 mma (m8n8k4), each warp two 8 x 8 blocks; the Q's and
// V are f64 whatever the dtype (V's products on the f64 mma), so that an
// f32 solve's V stays as orthogonal as the rotations themselves (each Q
// applied as I + E). A, V and the Q's live in device memory (in L2 at
// these sizes: 2048^2 f32 is 16.8 MB); shared memory holds only the tiles
// in flight, so it no longer sets the reach.
// One cooperative launch does the whole solve: the grid (one or two CTAs
// an SM, all resident) meets at a barrier counted on a word of scratch that
// the launch zeroes, the sweep's count and the decision to stop stay on the
// device, and the launch is captured into a CUDA graph like any other.
// Bound: latency again, one grid barrier and one inner sweep a round (~7
// us of a ~14 us round at 365 f32 / 256 f64 on an H100: shared memory's
// traffic and the barriers, tools/jacobi_probe.py); the work (~8 m^2 BW
// flops a round, ~8 m^3 a sweep) matters only near 2048, where the tiles'
// and V panels' load-compute-store latency sets the time.
//
// Both variants: a sweep ends with the off-diagonal mass (one block: of
// its columns; blocks: the sweep's last round's tiles, each CTA's share
// summed in a fixed order, then the CTAs' in block order, so every CTA
// takes the same decision); the solve stops when it falls below (n eps)^2
// of the total (blocks: (min(n, TOL_ORDER) eps)^2), when it stops
// shrinking, or after MAX_SWEEPS. Rotations are applied in Rutishauser's
// form. The lower triangle is read, as torch.linalg.eigh reads it. The
// eigenvalues are ranked (ties by index) and each column's eigenpair is
// written at its rank.

#include <cuda_runtime.h>

#include <cfloat>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SWEEPS = 30;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
// a batch of A's row pairs against one of V's rows in a thread's work
// (make_plan)
constexpr int A_BATCH_COST = 2;

// the block variant: columns of a block, of a pair (one a lane), threads of
// a CTA (one per (k, l) of a pair's 16 x 16 inner 2 x 2 blocks), the row
// stride of its shared tiles (16-byte rows; 8 banks apart in f64, so that
// the f64 mma's fragments load without conflicts), its largest order, the
// CTAs' partial sums the scratch has room for, and the CTAs an SM may hold
constexpr int BW = 16;
constexpr int PW = 2 * BW;
constexpr int BT = BW * BW;
constexpr int BWARPS = BT / 32;
constexpr int LD = PW + 4;
constexpr int BLOCK_REACH = 2048;
constexpr int MAX_GRID = 1024;
constexpr int CTAS_PER_SM = 2;
// the block variant stops at an off-diagonal mass of (min(n, TOL_ORDER)
// eps)^2 of the total: the one block's (n eps)^2 would leave an
// off-diagonal norm of n eps relative, 1.2e-4 at order 1024 in f32
constexpr int TOL_ORDER = 512;

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
// slot -> rank; the sweep's sums and the warps' partial sums.
template <typename T>
__host__ __device__ size_t smem_layout(int m, size_t* off) {
  const size_t ld = (size_t)m + 1;
  size_t o = 0;
  off[0] = o;
  o = align16(o + (size_t)m * ld * sizeof(T));
  off[1] = o;
  o = align16(o + (size_t)m * ld * sizeof(T));
  off[2] = o;
  o = align16(o + 2 * (size_t)(m / 2) * sizeof(Rot<T>));
  off[3] = o;
  o = align16(o + 2 * (size_t)m * sizeof(int));
  off[4] = o;
  o = align16(o + (2 + 64) * sizeof(T));
  return o;
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

// The block variant's rotation, the same as `rotation`'s: in f64 from one
// root, y = 1 / sqrt(d^2 + 4 A_pq^2): cos 2a = |d| y and sin 2a = +-2 A_pq
// y give t = sin 2a / (1 + cos 2a) and c = sqrt((1 + cos 2a) / 2), side by
// side (two dependent roots and divisions on the lookahead's chain where
// `rotation` has four: 2-3% off a round at 256-411 f64 on an H100,
// tools/jacobi_probe.py's plain_rotation copy); in f32 `rotation` itself.
template <typename T>
__device__ __forceinline__ Rot<T> block_rotation(T app, T aqq, T apq,
                                                 bool live) {
  if constexpr (std::is_same<T, float>::value) {
    return rotation(app, aqq, apq, live, 0);
  } else {
    Rot<T> rot;
    rot.s = 0;
    rot.tau = 0;
    rot.t = 0;
    rot.pq = 0;
    if (live) {
      const T d = aqq - app;
      const T y = rsqrt(d * d + 4 * apq * apq);
      const T g = fabs(d) * y;
      const T t = quotient((d >= T(0) ? 2 * apq : -2 * apq) * y, T(1) + g);
      const T c = sqrt(T(0.5) + T(0.5) * g);
      rot.s = t * c;
      rot.tau = quotient(rot.s, T(1) + c);
      rot.t = t;
    }
    return rot;
  }
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

// rotate() on f64 columns (Q and V of an f32 solve): the rotation's own
// (s, tau), the arithmetic in f64
template <typename T>
__device__ __forceinline__ void rotate64(const Rot<T>& r, double& x,
                                         double& y) {
  const double s = r.s, tau = r.tau, x0 = x;
  x = x0 - s * (y + tau * x0);
  y = y + s * (x0 - tau * y);
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

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    jacobi_kernel(const T* __restrict__ a_in, int n, int m, int rows,
                  T* __restrict__ w_out, T* __restrict__ v_out,
                  int* __restrict__ sweeps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = m, ld = m + 1, half = m / 2, w = half;
  size_t off[5];
  smem_layout<T>(m, off);
  T* A = reinterpret_cast<T*>(smem_raw + off[0]);  // slot s at A + s * ld
  T* V = reinterpret_cast<T*>(smem_raw + off[1]);  // slot s at V + s * ld
  Rot<T>* tab = reinterpret_cast<Rot<T>*>(smem_raw + off[2]);
  int* idx = reinterpret_cast<int*>(smem_raw + off[3]);
  int* rnk = idx + S;
  T* part = reinterpret_cast<T*>(smem_raw + off[4]);  // (off, tot)
  T* red = part + 2;                                   // (off, tot) a warp
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // thread (l, g) of the round's update; the threads past w * rows (the
  // block is rounded up to whole warps) own no pair
  const int l = tid % w;
  const int g = tid < w * rows ? tid / w : m;

  for (int e = tid; e < S * m; e += nthreads) {
    const int s = e / m, i = e - s * m;
    T a = 0;
    if (i < n && s < n) {
      a = i >= s ? a_in[(size_t)i * n + s] : a_in[(size_t)s * n + i];
    }
    A[s * ld + i] = a;
    V[s * ld + i] = i == s ? T(1) : T(0);
  }
  if (tid < S) idx[tid] = tid;

  T prev = T(-1);
  int sweep = 0, parity = 0;
  while (sweep < MAX_SWEEPS) {
    ++sweep;
    for (int r = 0; r < S - 1; ++r) {
      int sp, sq;  // the slots of pair l: the circle over the S slots
      if (l == 0) {
        sp = r;
        sq = S - 1;
      } else {
        sp = r + l;
        if (sp >= S - 1) sp -= S - 1;
        sq = r - l;
        if (sq < 0) sq += S - 1;
      }
      Rot<T>* tb = tab + parity * half;
      parity ^= 1;
      __syncthreads();  // the last update is in place
      if (g == 0) {
        const int p = idx[sp], q = idx[sq];
        const T apq = A[sq * ld + p];
        tb[l] = rotation(A[sp * ld + p], A[sq * ld + q], apq,
                         p < n && q < n && apq != T(0), p | (q << 16));
      }
      __syncthreads();
      // the fused update of the columns: every thread's loads of a batch
      // before its stores (two row pairs of A, four rows of V)
      const Rot<T> me = tb[l];
      T* cp = A + sp * ld;
      T* cq = A + sq * ld;
      for (int k0 = g; k0 < half; k0 += 2 * rows) {
        const int k1 = k0 + rows < half ? k0 + rows : k0;
        const Rot<T> r0 = tb[k0], r1 = tb[k1];
        const int p0 = r0.pq & 0xffff, q0 = r0.pq >> 16;
        const int p1 = r1.pq & 0xffff, q1 = r1.pq >> 16;
        T a00 = cp[p0], a01 = cq[p0], a10 = cp[q0], a11 = cq[q0];
        T b00 = cp[p1], b01 = cq[p1], b10 = cp[q1], b11 = cq[q1];
        rotate_block(r0, me, k0 == l, a00, a01, a10, a11);
        rotate_block(r1, me, k1 == l, b00, b01, b10, b11);
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

    // the off-diagonal and total mass
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
      if (lane == 0) {
        part[0] = o;
        part[1] = tot;
      }
    }
    __syncthreads();
    o = part[0];
    tot = part[1];
    const T tol = T(n) * Eps<T>::value;
    // converged, or no longer shrinking (rounding level)
    if (o <= tol * tol * tot || (prev >= 0 && o >= prev)) break;
    prev = o;
  }

  if (sweeps_out != nullptr && tid == 0) *sweeps_out = sweep;

  // every column's eigenvalue and index (the tables are free: the last
  // round has passed)
  T* ev = reinterpret_cast<T*>(tab);
  int* ei = reinterpret_cast<int*>(ev + m);
  for (int s = tid; s < S; s += nthreads) {
    const int j = idx[s];
    ev[s] = A[s * ld + j];
    ei[s] = j;
  }
  __syncthreads();
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

// -- the block variant --------------------------------------------------

// Shared memory of a CTA, by window: the pair's subproblem (two buffers:
// an inner round reads one and writes the other, so one barrier a round),
// its Q (f64) and the rotations of the last three inner rounds; a tile's
// operands (Q_i - I, Q_j - I), the product's middle factor U and the
// output Y (stride PW + 1 for its transposed read); a V panel and Q_j - I
// (f64); the ranking's eigenvalues and inverse permutation; the
// reductions.
template <typename T>
struct BlockShared {
  union {
    struct {
      T S[2][PW][LD];
      double Q[PW][LD];
      Rot<T> rot[3][BW];  // each pair's rotation, by round mod 3
    } a;
    struct {
      T X[PW][LD];
      T Qi[PW][LD];
      T Qj[PW][LD];
      T U[PW][LD];
      T Y[PW][PW + 1];
    } b;
    struct {
      double X[PW][LD];
      double E[PW][LD];
    } v;
    struct {
      T d[BLOCK_REACH];
      int inv[BLOCK_REACH];
    } out;
  };
  T red[2 * BWARPS];
  T dec[2];
};

// solves of the block variant on this device, counted by the kernel itself
// (a CUDA graph's replays call no wrapper; jacobi_block_solves reads it)
__device__ unsigned block_solves;

// a poll of a word another CTA writes (relaxed: two polls go out
// together; the fence after the wait orders what follows)
__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// a release of this CTA's writes (ordered before by a barrier) with an
// add to, or a raise of, a word other CTAs poll: the thread goes on at
// once
__device__ __forceinline__ void release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void release_max(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.max.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// the grid's barrier: every CTA resident (a cooperative launch), arrivals
// counted on a word the launch zeroed; the `epoch`-th barrier waits for
// epoch * gridDim.x arrivals
__device__ __forceinline__ void grid_sync(unsigned* ctr, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    release_add(ctr, 1u);
    const unsigned target = epoch * gridDim.x;
    while (load_relaxed(ctr) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// the blocks (P, Q) of pair i in round r: the circle method over nb blocks
__device__ __forceinline__ void pair_blocks(int i, int r, int nb, int& P,
                                            int& Q) {
  const int M = nb - 1;
  if (i == 0) {
    P = r;
    Q = M;
  } else {
    P = r + i;
    if (P >= M) P -= M;
    Q = r - i;
    if (Q < 0) Q += M;
  }
}

// pair l's columns (p, q) of a subproblem in inner round r: the circle over
// the 32 columns (full), or the columns of the first block against the
// second's, shifted by r
__device__ __forceinline__ void inner_pair(int l, int r, bool full, int& p,
                                           int& q) {
  if (full) {
    if (l == 0) {
      p = r;
      q = PW - 1;
    } else {
      p = r + l;
      if (p >= PW - 1) p -= PW - 1;
      q = r - l;
      if (q < 0) q += PW - 1;
    }
  } else {
    p = l;
    q = l + r;
    if (q >= BW) q -= BW;
    q += BW;
  }
}

// column c of a pair of blocks (P, Q): the first BW in P, the rest in Q
__device__ __forceinline__ int pair_col(int P, int Q, int c) {
  return c < BW ? P * BW + c : Q * BW + c - BW;
}

// the pair l and side (0: p, 1: q) of column c in inner round r: the
// inverse of inner_pair
__device__ __forceinline__ void inner_slot(int c, int r, bool full, int& l,
                                           int& side) {
  if (full) {
    int d = c - r;  // (c - r) mod 31
    if (d < 0) d += PW - 1;
    if (c == PW - 1) {
      l = 0;
      side = 1;
    } else if (d < BW) {
      l = d;
      side = 0;
    } else {
      l = PW - 1 - d;
      side = 1;
    }
  } else if (c < BW) {
    l = c;
    side = 0;
  } else {
    l = c - BW - r;
    if (l < 0) l += BW;
    side = 1;
  }
}

// where the lookahead of inner round r finds pair `lane` of round r + 1:
// its columns (p1, q1) sit in round r's pairs (a1, b1) and (a2, b2) (never
// one pair: an inner sweep meets each pair once), on sides s1 and s2, k1
// and k2 those pairs' indices
struct Ahead {
  int p1, q1, k1, k2, a1, b1, a2, b2, s1, s2;
};

__device__ __forceinline__ Ahead ahead_slots(int lane, int r, bool full) {
  Ahead h;
  inner_pair(lane, r + 1, full, h.p1, h.q1);
  inner_slot(h.p1, r, full, h.k1, h.s1);
  inner_slot(h.q1, r, full, h.k2, h.s2);
  inner_pair(h.k1, r, full, h.a1, h.b1);
  inner_pair(h.k2, r, full, h.a2, h.b2);
  return h;
}

// A pair (P, Q)'s subproblem rotated by one inner sweep, written back
// (symmetric, from its lower triangle), Q (f64: accumulated from the
// rotations in f64 whatever T, so that V, which takes its update from the
// Q's, stays orthogonal to f64's rounding plus the rotations' own) to
// q_out; its mass added to (off, tot) when `mass`. One barrier an inner
// round, three roles:
//  - warps 0-3 apply round r's rotations (from the table) to the
//    subproblem, thread (k, l) its 2 x 2 blocks (k, l) and (k + 8, l);
//  - warp 7's first 16 lanes compute round r + 1's rotations meanwhile,
//    each from the three entries of its pair that round r leaves, which it
//    computes itself from round r's inputs by the same arithmetic as the
//    threads that own them (so the table holds the rotations that the
//    updated subproblem gives): the rotation chain, the round's critical
//    path, never waits for the update, and the next round's indices are
//    found in its shadow;
//  - warps 4-6 apply round r - 1's rotations to Q's columns.
// The table holds three rounds (r - 1, r, r + 1).
template <typename T>
__device__ void solve_pair(T* __restrict__ A, int m, int n, int P, int Q,
                           bool full, double* __restrict__ q_out,
                           BlockShared<T>& sh, bool mass, T& off, T& tot) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < PW * PW; e += BT) {
    const int r = e / PW, c = e % PW;
    sh.a.S[0][r][c] =
        __ldcg(A + (size_t)pair_col(P, Q, r) * m + pair_col(P, Q, c));
    sh.a.Q[r][c] = r == c ? 1.0 : 0.0;
  }
  const int rounds = full ? PW - 1 : BW;
  const bool ahead = warp == BWARPS - 1 && lane < BW;
  auto live = [&](int p, int q, T apq) {
    return pair_col(P, Q, p) < n && pair_col(P, Q, q) < n && apq != T(0);
  };
  __syncthreads();
  Ahead h{};
  if (ahead) {  // round 0's rotations
    int p, q;
    inner_pair(lane, 0, full, p, q);
    const T(*S)[LD] = sh.a.S[0];
    sh.a.rot[0][lane] =
        block_rotation(S[p][p], S[q][q], S[q][p], live(p, q, S[q][p]));
    h = ahead_slots(lane, 0, full);
  }
  __syncthreads();
  for (int r = 0, r3 = 0; r <= rounds; ++r, r3 = r3 == 2 ? 0 : r3 + 1) {
    const Rot<T>* tb = sh.a.rot[r3];
    const T(*S)[LD] = sh.a.S[r & 1];
    if (warp < BWARPS / 2) {
      if (r < rounds) {
        const int k = tid / BW, l = tid % BW;
        int pk0, qk0, pk1, qk1, pl, ql;
        inner_pair(k, r, full, pk0, qk0);
        inner_pair(k + BW / 2, r, full, pk1, qk1);
        inner_pair(l, r, full, pl, ql);
        T(*Sn)[LD] = sh.a.S[(r + 1) & 1];
        const Rot<T> rk0 = tb[k], rk1 = tb[k + BW / 2], rl = tb[l];
        T x00 = S[pk0][pl], x01 = S[pk0][ql], x10 = S[qk0][pl],
          x11 = S[qk0][ql];
        T y00 = S[pk1][pl], y01 = S[pk1][ql], y10 = S[qk1][pl],
          y11 = S[qk1][ql];
        rotate_block(rk0, rl, k == l, x00, x01, x10, x11);
        rotate_block(rk1, rl, k + BW / 2 == l, y00, y01, y10, y11);
        Sn[pk0][pl] = x00;
        Sn[pk0][ql] = x01;
        Sn[qk0][pl] = x10;
        Sn[qk0][ql] = x11;
        Sn[pk1][pl] = y00;
        Sn[pk1][ql] = y01;
        Sn[qk1][pl] = y10;
        Sn[qk1][ql] = y11;
      }
    } else if (warp < BWARPS - 1) {
      if (r > 0) {
        // Q's rows u / 16 + 6 j in the columns of pair u % 16 of the
        // round before
        const int u = tid - BT / 2, l = u % BW;
        const Rot<T> rl = sh.a.rot[r3 == 0 ? 2 : r3 - 1][l];
        int pl, ql;
        inner_pair(l, r - 1, full, pl, ql);
        for (int row = u / BW; row < PW; row += (BT / 2 - 32) / BW) {
          double* qr = sh.a.Q[row];
          double x = qr[pl], y = qr[ql];
          rotate64(rl, x, y);
          qr[pl] = x;
          qr[ql] = y;
        }
      }
    } else if (ahead && r + 1 < rounds) {
      const int p1 = h.p1, q1 = h.q1, a1 = h.a1, b1 = h.b1, a2 = h.a2,
                b2 = h.b2, s1 = h.s1, s2 = h.s2;
      const Rot<T> R1 = tb[h.k1], R2 = tb[h.k2];
      // the two new diagonal entries, as rotate_block's diagonal branch
      // leaves them
      T x00 = S[a1][a1], x11 = S[b1][b1];
      const T t1 = S[a1][b1];
      x00 -= R1.t * t1;
      x11 += R1.t * t1;
      const T app = s1 ? x11 : x00;
      T z00 = S[a2][a2], z11 = S[b2][b2];
      const T t2 = S[a2][b2];
      z00 -= R2.t * t2;
      z11 += R2.t * t2;
      const T aqq = s2 ? z11 : z00;
      // the new (q1, p1): block (k2, k1)'s entry (s2, s1)
      T y00 = S[a2][a1], y01 = S[a2][b1], y10 = S[b2][a1], y11 = S[b2][b1];
      rotate_block(R2, R1, false, y00, y01, y10, y11);
      const T apq = s2 ? (s1 ? y11 : y10) : (s1 ? y01 : y00);
      if (r + 2 < rounds) h = ahead_slots(lane, r + 1, full);
      sh.a.rot[r3 == 2 ? 0 : r3 + 1][lane] =
          block_rotation(app, aqq, apq, live(p1, q1, apq));
    }
    __syncthreads();
  }
  const T(*S)[LD] = sh.a.S[rounds & 1];
  for (int e = tid; e < PW * PW; e += BT) {
    const int r = e / PW, c = e % PW;
    const T v = r >= c ? S[r][c] : S[c][r];
    A[(size_t)pair_col(P, Q, r) * m + pair_col(P, Q, c)] = v;
    q_out[e] = sh.a.Q[r][c];
    if (mass) {
      tot += v * v;
      if (r != c) off += v * v;
    }
  }
  __syncthreads();  // before the shared memory is reused
}

// out[i] = sum_k L[k][r0 + i] R[k][lane], i < 4: four rows of an f32
// product, the lane's column (CUDA cores)
__device__ __forceinline__ void rows4(const float (*L)[LD],
                                      const float (*R)[LD], int r0, int lane,
                                      float out[4]) {
  float a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll 8
  for (int k = 0; k < PW; ++k) {
    const float x = R[k][lane];
    const float4 l = *reinterpret_cast<const float4*>(&L[k][r0]);
    a0 = fmaf(l.x, x, a0);
    a1 = fmaf(l.y, x, a1);
    a2 = fmaf(l.z, x, a2);
    a3 = fmaf(l.w, x, a3);
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
  out[3] = a3;
}

// D += A B on the f64 tensor cores: an 8 x 4 A (a = A[gid][tig]), a 4 x 8
// B (b = B[tig][gid]), D's row gid, columns 2 tig and 2 tig + 1, with gid =
// lane / 4, tig = lane % 4
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// An 8 x 8 block (rows r0.., columns c0..) of sum_k L(r, k) R[k][c] on the
// f64 tensor cores, L(r, k) = L[k][r] (trans) or L[r][k]: the lane's
// (d0, d1) at row r0 + gid, columns c0 + 2 tig, + 1.
template <bool TRANS>
__device__ __forceinline__ void block8(const double (*L)[LD],
                                       const double (*R)[LD], int r0, int c0,
                                       int lane, double& d0, double& d1) {
  const int gid = lane >> 2, tig = lane & 3;
  d0 = 0;
  d1 = 0;
#pragma unroll
  for (int k0 = 0; k0 < PW; k0 += 4) {
    const double a = TRANS ? L[k0 + tig][r0 + gid] : L[r0 + gid][k0 + tig];
    dmma(d0, d1, a, R[k0 + tig][c0 + gid]);
  }
}

// The pair tile A[I_i, I_j] <- Q_i^T A[I_i, I_j] Q_j (rows of pair (Pi,
// Qi), columns of (Pj, Qj)), written with its mirror, once both pairs'
// flags (fi, fj) pass `round` (the tile's own loads go out before the
// wait); its mass (twice: the mirror) added to (off, tot) when `mass`.
// Each Q is applied as I + E (E from the f64 Q, rounded to T once): U = X
// + E_i^T X, then U + U E_j, each sum of products taken first and the
// matrix added once, so that a late round, whose E are below the tile's
// rounding, leaves it as it was (products with Q itself would round every
// entry again every round).
template <typename T>
__device__ void update_tile(T* __restrict__ A, int m, int Pi, int Qi, int Pj,
                            int Qj, const double* __restrict__ qi,
                            const double* __restrict__ qj, const unsigned* fi,
                            const unsigned* fj, unsigned round,
                            BlockShared<T>& sh, bool mass, T& off, T& tot) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T x[PW * PW / BT];
#pragma unroll
  for (int h = 0; h < PW * PW / BT; ++h) {
    const int e = tid + h * BT, k = e / PW, c = e % PW;
    x[h] = __ldcg(A + (size_t)pair_col(Pi, Qi, k) * m + pair_col(Pj, Qj, c));
  }
  if (tid == 0) {
    for (;;) {
      const unsigned a = load_relaxed(fi), b = load_relaxed(fj);
      if (a > round && b > round) break;
    }
    __threadfence();
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < PW * PW / BT; ++h) {
    const int e = tid + h * BT, k = e / PW, c = e % PW;
    sh.b.X[k][c] = x[h];
    sh.b.Qi[k][c] = T(__ldcg(qi + e) - (k == c ? 1.0 : 0.0));
    sh.b.Qj[k][c] = T(__ldcg(qj + e) - (k == c ? 1.0 : 0.0));
  }
  __syncthreads();
  if constexpr (std::is_same<T, float>::value) {
    // U = X + E_i^T X, four rows a warp, stored transposed for the next
    // product (the warp reads back only its own rows)
    const int r0 = 4 * warp;
    T u[4], y[4];
    rows4(sh.b.Qi, sh.b.X, r0, lane, u);
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] += sh.b.X[r0 + i][lane];
    *reinterpret_cast<float4*>(&sh.b.U[lane][r0]) =
        make_float4(u[0], u[1], u[2], u[3]);
    __syncwarp();
    rows4(sh.b.U, sh.b.Qj, r0, lane, y);
    const int col = pair_col(Pj, Qj, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] += u[i];
      A[(size_t)pair_col(Pi, Qi, r0 + i) * m + col] = y[i];
      sh.b.Y[r0 + i][lane] = y[i];
    }
  } else {
    // two 8 x 8 blocks a warp: row block warp / 2, column blocks 2 (warp %
    // 2) and the next
    const int gid = lane >> 2, tig = lane & 3;
    const int r0 = 8 * (warp >> 1), c0 = 16 * (warp & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * h + 2 * tig;
      double d0, d1;
      block8<true>(sh.b.Qi, sh.b.X, r0, c0 + 8 * h, lane, d0, d1);
      sh.b.U[r0 + gid][c] = d0 + sh.b.X[r0 + gid][c];
      sh.b.U[r0 + gid][c + 1] = d1 + sh.b.X[r0 + gid][c + 1];
    }
    __syncthreads();
    const size_t row = (size_t)pair_col(Pi, Qi, r0 + gid) * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * h + 2 * tig;
      double d0, d1;
      block8<false>(sh.b.U, sh.b.Qj, r0, c0 + 8 * h, lane, d0, d1);
      d0 += sh.b.U[r0 + gid][c];
      d1 += sh.b.U[r0 + gid][c + 1];
      *reinterpret_cast<double2*>(A + row + pair_col(Pj, Qj, c)) =
          make_double2(d0, d1);
      sh.b.Y[r0 + gid][c] = d0;
      sh.b.Y[r0 + gid][c + 1] = d1;
    }
  }
  __syncthreads();
  for (int e = tid; e < PW * PW; e += BT) {
    const int c = e / PW, r = e % PW;
    const T v = sh.b.Y[r][c];
    A[(size_t)pair_col(Pj, Qj, c) * m + pair_col(Pi, Qi, r)] = v;
    if (mass) {
      off += 2 * v * v;
      tot += 2 * v * v;
    }
  }
  __syncthreads();
}

// V[rows, I_j] <- V[rows, I_j] Q_j for a panel of 32 rows from `row0` and
// pair j's blocks (Pj, Qj), as V + V E_j (update_tile), in f64 on the
// tensor cores whatever T: V is kept in f64 (and rounded to T at the end).
template <typename T>
__device__ void update_v(double* __restrict__ V, int m, int row0, int Pj,
                         int Qj, const double* __restrict__ qj,
                         BlockShared<T>& sh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < PW * PW; e += BT) {
    const int r = e / PW, c = e % PW;
    sh.v.X[r][c] = __ldcg(V + (size_t)(row0 + r) * m + pair_col(Pj, Qj, c));
    sh.v.E[r][c] = __ldcg(qj + e) - (r == c ? 1.0 : 0.0);
  }
  __syncthreads();
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 8 * (warp >> 1), c0 = 16 * (warp & 1);
  const size_t row = (size_t)(row0 + r0 + gid) * m;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 8 * h + 2 * tig;
    double d0, d1;
    block8<false>(sh.v.X, sh.v.E, r0, c0 + 8 * h, lane, d0, d1);
    *reinterpret_cast<double2*>(V + row + pair_col(Pj, Qj, c)) =
        make_double2(d0 + sh.v.X[r0 + gid][c], d1 + sh.v.X[r0 + gid][c + 1]);
  }
  __syncthreads();
}

// V's panel item v of round vr (its Q's at qr): panel v / K, pair v % K
template <typename T>
__device__ void v_item(double* __restrict__ V, int m, int K, int vr, int v,
                       const double* __restrict__ qr, BlockShared<T>& sh) {
  const int panel = v / K, j = v - panel * K;
  int P, Q;
  pair_blocks(j, vr, 2 * K, P, Q);
  update_v(V, m, panel * PW, P, Q, qr + (size_t)j * PW * PW, sh);
}

// The block variant's grid: A (m x m), V (m x m, f64), Q (two rounds' K
// 32 x 32, f64),
// part (two sums a CTA), ctrl (the barrier's word, then each pair's flag:
// the rounds whose Q it has published), inv (rank -> column) in scratch.
// A round: each CTA c < K solves pair c and raises its flag; then the
// previous round's V panels (they wait for nothing) and this round's pair
// tiles (each waits for its two pairs' flags); one grid barrier.
template <typename T>
__global__ void __launch_bounds__(BT, CTAS_PER_SM)
    jacobi_block_kernel(const T* __restrict__ a_in, int n, int m,
                        T* __restrict__ A, double* __restrict__ V,
                        double* __restrict__ Qb, T* __restrict__ part,
                        unsigned* __restrict__ ctrl, int* __restrict__ inv,
                        T* __restrict__ w_out, T* __restrict__ v_out,
                        int* __restrict__ sweeps_out) {
  __shared__ __align__(16) BlockShared<T> sh;
  const int G = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nb = m / BW, K = nb / 2, M = nb - 1;  // blocks, pairs, rounds
  const int n_tiles = K * (K - 1) / 2, n_v = (m / PW) * K;
  // this CTA's first tile: they are dealt out from CTA K, the pairs' CTAs
  // last; the previous round's V panels go before the tiles, to the CTAs
  // without a pair while they are few (v_free), else dealt out likewise
  const int first = (cta + G - K % G) % G;
  const bool v_free = G > K && n_v <= 3 * (G - K);
  const size_t mm = (size_t)m * m, q_round = (size_t)K * PW * PW;
  unsigned* ctr = ctrl;
  unsigned* flags = ctrl + 1;
  unsigned epoch = 0;

  for (size_t e = (size_t)cta * BT + tid; e < mm; e += (size_t)G * BT) {
    const int i = (int)(e / m), j = (int)(e - (size_t)i * m);
    T a = 0;
    if (i < n && j < n) {
      a = i >= j ? a_in[(size_t)i * n + j] : a_in[(size_t)j * n + i];
    }
    A[e] = a;
    V[e] = i == j ? 1.0 : 0.0;
  }
  grid_sync(ctr, ++epoch);

  T prev = T(-1);
  int sweep = 0, rc = 0, vr = -1;  // rounds so far; V's pending round
  while (sweep < MAX_SWEEPS) {
    ++sweep;
    T off = 0, tot = 0;  // this thread's share of the last round's mass
    for (int r = 0; r < M; ++r, ++rc) {
      const bool last = r == M - 1;
      double* q_now = Qb + (rc & 1) * q_round;
      for (int i = cta; i < K; i += G) {
        int P, Q;
        pair_blocks(i, r, nb, P, Q);
        solve_pair(A, m, n, P, Q, r == 0, q_now + (size_t)i * PW * PW, sh,
                   last, off, tot);
        if (tid == 0) release_max(flags + i, (unsigned)rc + 1);
      }
      if (vr >= 0) {
        const double* q_prev = Qb + ((rc - 1) & 1) * q_round;
        if (!v_free) {
          for (int v = first; v < n_v; v += G) {
            v_item(V, m, K, vr, v, q_prev, sh);
          }
        } else if (cta >= K) {
          for (int v = cta - K; v < n_v; v += G - K) {
            v_item(V, m, K, vr, v, q_prev, sh);
          }
        }
      }
      for (int t = first; t < n_tiles; t += G) {
        // tile t = (i, j), i > j, in the lower triangle's row order
        int i = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)t)) * 0.5f);
        while (i * (i - 1) / 2 > t) --i;
        while ((i + 1) * i / 2 <= t) ++i;
        const int j = t - i * (i - 1) / 2;
        int Pi, Qi, Pj, Qj;
        pair_blocks(i, r, nb, Pi, Qi);
        pair_blocks(j, r, nb, Pj, Qj);
        update_tile(A, m, Pi, Qi, Pj, Qj, q_now + (size_t)i * PW * PW,
                    q_now + (size_t)j * PW * PW, flags + i, flags + j,
                    (unsigned)rc, sh, last, off, tot);
      }
      vr = r;
      if (last) {
        // this CTA's share, summed in a fixed order
        off = warp_sum(off);
        tot = warp_sum(tot);
        if (lane == 0) {
          sh.red[2 * warp] = off;
          sh.red[2 * warp + 1] = tot;
        }
        __syncthreads();
        if (tid == 0) {
          T o = 0, s = 0;
          for (int w = 0; w < BWARPS; ++w) {
            o += sh.red[2 * w];
            s += sh.red[2 * w + 1];
          }
          part[2 * cta] = o;
          part[2 * cta + 1] = s;
        }
      }
      grid_sync(ctr, ++epoch);
    }
    // the sweep's mass, the CTAs' shares summed in the same order by each
    if (warp == 0) {
      T o = 0, s = 0;
      for (int c = lane; c < G; c += 32) {
        o += __ldcg(part + 2 * c);
        s += __ldcg(part + 2 * c + 1);
      }
      o = warp_sum(o);
      s = warp_sum(s);
      if (lane == 0) {
        sh.dec[0] = o;
        sh.dec[1] = s;
      }
    }
    __syncthreads();
    const T o = sh.dec[0], s = sh.dec[1];
    const T tol = T(n < TOL_ORDER ? n : TOL_ORDER) * Eps<T>::value;
    // converged, or no longer shrinking (rounding level)
    if (o <= tol * tol * s || (prev >= 0 && o >= prev)) break;
    prev = o;
  }
  for (int x = first; x < n_v; x += G) {
    v_item(V, m, K, vr, x, Qb + ((rc - 1) & 1) * q_round, sh);
  }
  grid_sync(ctr, ++epoch);

  if (cta == 0 && tid == 0) {
    if (sweeps_out != nullptr) *sweeps_out = sweep;
    atomicAdd(&block_solves, 1u);
  }
  // the eigenvalues (A's diagonal) ranked, ties by index; rank -> column
  for (int j = tid; j < n; j += BT) sh.out.d[j] = __ldcg(A + (size_t)j * m + j);
  __syncthreads();
  for (int j = cta * BT + tid; j < n; j += G * BT) {
    const T lam = sh.out.d[j];
    int rank = 0;
    for (int e = 0; e < n; ++e) {
      const T le = sh.out.d[e];
      rank += le < lam || (le == lam && e < j);
    }
    w_out[rank] = lam;
    inv[rank] = j;
  }
  grid_sync(ctr, ++epoch);
  for (int j = tid; j < n; j += BT) sh.out.inv[j] = __ldcg(inv + j);
  __syncthreads();
  const size_t nn = (size_t)n * n;
  for (size_t e = (size_t)cta * BT + tid; e < nn; e += (size_t)G * BT) {
    const int i = (int)(e / n), r = (int)(e - (size_t)i * n);
    v_out[e] = T(__ldcg(V + (size_t)i * m + sh.out.inv[r]));
  }
}

// One launch of the one-block variant at order n: m = n padded to even,
// `rows` row groups of m/2 threads (`threads`: rounded up to whole warps),
// `smem` bytes of shared memory.
struct Plan {
  int m, rows, threads;
  size_t smem;
};

// The launch in one block; false where it cannot take n. The row groups:
// the fewest that give the least work to the busiest thread, ceil(m/2 /
// 2 rows) batches of two of A's row pairs and ceil(n / 4 rows) of four of
// V's rows (a batch is loaded whole before it is stored), an A batch
// weighing A_BATCH_COST; with m/2 rows <= MAX_THREADS.
template <typename T>
bool make_plan(int n, Plan* p) {
  if (n < 1 || n > 0xffff) return false;
  const int m = (n + 1) / 2 * 2, w = m / 2, half = m / 2;
  size_t off[5];
  const size_t smem = smem_layout<T>(m, off);
  int hi = half > n ? half : n;
  if (hi > MAX_THREADS / w) hi = MAX_THREADS / w;
  if (smem > (size_t)SMEM_LIMIT || hi < 1) return false;
  int rows = 1, cost = -1;
  for (int r = 1; r <= hi; ++r) {
    const int c = A_BATCH_COST * ((half + 2 * r - 1) / (2 * r)) +
                  (n + 4 * r - 1) / (4 * r);
    if (cost < 0 || c < cost) {
      rows = r;
      cost = c;
    }
  }
  *p = Plan{m, rows, (w * rows + 31) / 32 * 32, smem};
  return true;
}

// The block variant at order n: m = n padded to a multiple of PW, the
// scratch's regions (256-byte aligned) and its bytes; false past its reach.
struct BlockPlan {
  int m;
  size_t a, v, q, part, ctrl, inv, bytes;
};

template <typename T>
bool make_block_plan(int n, BlockPlan* p) {
  if (n < 1 || n > BLOCK_REACH) return false;
  const int m = (n + PW - 1) / PW * PW, K = m / PW;
  auto up = [](size_t x) { return (x + 255) & ~size_t(255); };
  size_t o = 0;
  p->m = m;
  p->a = o;
  o = up(o + (size_t)m * m * sizeof(T));
  p->v = o;
  o = up(o + (size_t)m * m * sizeof(double));
  p->q = o;
  o = up(o + 2 * (size_t)K * PW * PW * sizeof(double));
  p->part = o;
  o = up(o + 2 * (size_t)MAX_GRID * sizeof(T));
  p->ctrl = o;
  o = up(o + (1 + (size_t)K) * sizeof(unsigned));
  p->inv = o;
  o = up(o + (size_t)m * sizeof(int));
  p->bytes = o;
  return true;
}

// The block variant's grid: a CTA for each pair and each pair tile (the
// V panels share the tiles' CTAs), one an SM while a round's items (tiles
// and V panels) are under three an SM (a pair's CTA then has its SM to
// itself), up to `per_sm` (at most CTAS_PER_SM) an SM above that.
int block_grid(int m, int sms, int per_sm) {
  const int K = m / PW, tiles = K * (K - 1) / 2, items = tiles + (m / PW) * K;
  const int slots = items > 3 * sms ? sms * per_sm : sms;
  int g = K + tiles;
  if (g > slots) g = slots;
  return g < MAX_GRID ? g : MAX_GRID;
}

template <typename T>
int reach(int variant) {
  if (variant != 0) {
    BlockPlan p;
    int n = 0;
    while (make_block_plan<T>(n + 1, &p)) ++n;
    return n;
  }
  Plan p;
  int n = 0;
  while (make_plan<T>(n + 1, &p)) ++n;
  return n;
}

// the current device's SMs and the block variant's CTAs an SM holds (at
// most CTAS_PER_SM), found once per dtype and device
template <typename T>
int block_slots(int* sms, int* per_sm) {
  static int cached[64][2] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev][0] == 0) {
    int count = 0, occ = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, jacobi_block_kernel<T>, BT, 0);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached[dev][0] = count;
    cached[dev][1] = occ < CTAS_PER_SM ? occ : CTAS_PER_SM;
  }
  *sms = cached[dev][0];
  *per_sm = cached[dev][1];
  return 0;
}

template <typename T>
int launch_blocks(const void* a, int n, void* w, void* v, void* sweeps,
                  void* scratch, cudaStream_t stream) {
  BlockPlan p;
  if (!make_block_plan<T>(n, &p) || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0, per_sm = 0;
  const int code = block_slots<T>(&sms, &per_sm);
  if (code != 0) return code;
  char* s = static_cast<char*>(scratch);
  unsigned* ctrl = reinterpret_cast<unsigned*>(s + p.ctrl);
  cudaError_t e = cudaMemsetAsync(
      ctrl, 0, (1 + (size_t)p.m / PW) * sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(block_grid(p.m, sms, per_sm));
  cfg.blockDim = dim3(BT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, jacobi_block_kernel<T>, static_cast<const T*>(a), n, p.m,
      reinterpret_cast<T*>(s + p.a), reinterpret_cast<double*>(s + p.v),
      reinterpret_cast<double*>(s + p.q), reinterpret_cast<T*>(s + p.part),
      ctrl,
      reinterpret_cast<int*>(s + p.inv), static_cast<T*>(w),
      static_cast<T*>(v), static_cast<int*>(sweeps));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, int n, int variant, void* w, void* v,
           void* sweeps, void* scratch, void* stream) {
  if (variant != 0) {
    return launch_blocks<T>(a, n, w, v, sweeps, scratch,
                            (cudaStream_t)stream);
  }
  Plan p;
  if (!make_plan<T>(n, &p)) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory limit, raised once per dtype and device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(jacobi_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  jacobi_kernel<T><<<1, p.threads, p.smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), n, p.m, p.rows, static_cast<T*>(w),
      static_cast<T*>(v), static_cast<int*>(sweeps));
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 for one block, 1 for the block variant (kernels/jacobi.py
// picks it by order); sweeps (may be null): receives the number of sweeps
// the solve took; scratch: jacobi_scratch_bytes(n, f64, variant) bytes of
// device memory (none for one block). Refused where the variant cannot
// take n.
extern "C" int jacobi_eigh_f32(const void* a, int n, int variant, void* w,
                               void* v, void* sweeps, void* scratch,
                               void* stream) {
  return launch<float>(a, n, variant, w, v, sweeps, scratch, stream);
}

extern "C" int jacobi_eigh_f64(const void* a, int n, int variant, void* w,
                               void* v, void* sweeps, void* scratch,
                               void* stream) {
  return launch<double>(a, n, variant, w, v, sweeps, scratch, stream);
}

// the largest order a variant takes (kernels/jacobi.py's ONE_BLOCK_REACH
// and REACH state the same)
extern "C" int jacobi_reach(int f64, int variant) {
  return f64 ? reach<double>(variant) : reach<float>(variant);
}

// the block variant's solves on the current device so far, counted by the
// kernel (every replay of a captured solve among them; waits for the
// device), or -1 on an error
extern "C" int jacobi_block_solves(void) {
  unsigned count = 0;
  if (cudaMemcpyFromSymbol(&count, block_solves, sizeof(count)) !=
      cudaSuccess) {
    return -1;
  }
  return (int)count;
}

// the scratch a solve of order n needs (0 for one block, or past the
// variant's reach)
extern "C" int jacobi_scratch_bytes(int n, int f64, int variant) {
  if (variant == 0) return 0;
  BlockPlan p;
  const bool ok = f64 ? make_block_plan<double>(n, &p)
                      : make_block_plan<float>(n, &p);
  return ok ? (int)p.bytes : 0;
}
