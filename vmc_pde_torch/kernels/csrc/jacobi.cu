// Symmetric eigendecomposition of one small matrix in one block: the
// parallel cyclic Jacobi method with round-robin pair ordering.
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
// flops over its sweeps, ~3 us of work at the card's rates; what sets its
// time is the chain of block barriers, three per round, m - 1 rounds per
// sweep. Design: A and V live in shared memory (row stride m + 1, so that
// the column updates hit 32 banks), the m/2 disjoint pairs of a round
// rotate together: one thread per pair computes (c, s) that zero A[p][q],
// then every thread updates rows (J^T A), then columns (A J, V J), and the
// rotated entries are set to 0. A sweep ends with a block reduction of
// the off-diagonal mass; the solve stops when it falls below (m eps)^2 of
// the total, when it stops shrinking, or after MAX_SWEEPS. An odd n gets
// a bye in every round. The lower triangle is read, as torch.linalg.eigh
// reads it. The eigenvalues are sorted by rank (ties by index) with their
// vectors.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_SWEEPS = 30;

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

// the k-th pair of round r of the round-robin schedule of m (even) players
__device__ __forceinline__ void pair_of(int r, int k, int m, int& p, int& q) {
  const int M = m - 1;
  if (k == 0) {
    p = r % M;
    q = M;
  } else {
    p = (r + k) % M;
    q = (r - k + M) % M;
  }
  if (p > q) {
    const int t = p;
    p = q;
    q = t;
  }
}

template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < THREADS / 32; ++w) s += scratch[w];
    scratch[THREADS / 32] = s;
  }
  __syncthreads();
  return scratch[THREADS / 32];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    jacobi_kernel(const T* __restrict__ a_in, int n, int m, T* __restrict__ w,
                  T* __restrict__ v_out, int* __restrict__ sweeps_out) {
  extern __shared__ unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  const int ld = m + 1;
  T* V = A + m * ld;
  T* cs = V + m * ld;          // (c, s) per pair
  T* scratch = cs + m;         // THREADS / 32 + 1 partial sums
  const int tid = threadIdx.x;
  const int half = m / 2;

  for (int idx = tid; idx < m * m; idx += THREADS) {
    const int i = idx / m, j = idx % m;
    T a = 0;
    if (i < n && j < n) a = i >= j ? a_in[i * n + j] : a_in[j * n + i];
    A[i * ld + j] = a;
    V[i * ld + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();

  T prev_off = T(-1);
  int sweep = 0;
  while (sweep < MAX_SWEEPS) {
    ++sweep;
    for (int r = 0; r < m - 1; ++r) {
      if (tid < half) {
        int p, q;
        pair_of(r, tid, m, p, q);
        T c = 1, s = 0;
        const T apq = A[p * ld + q];
        if (q < n && apq != T(0)) {
          const T theta = (A[q * ld + q] - A[p * ld + p]) / (2 * apq);
          const T t = (theta >= 0 ? T(1) : T(-1)) /
                      (fabs(theta) + sqrt(T(1) + theta * theta));
          c = T(1) / sqrt(T(1) + t * t);
          s = t * c;
        }
        cs[2 * tid] = c;
        cs[2 * tid + 1] = s;
      }
      __syncthreads();
      // rows: A <- J^T A
      for (int idx = tid; idx < half * m; idx += THREADS) {
        const int k = idx / m, j = idx % m;
        const T s = cs[2 * k + 1];
        if (s == T(0)) continue;
        const T c = cs[2 * k];
        int p, q;
        pair_of(r, k, m, p, q);
        const T ap = A[p * ld + j], aq = A[q * ld + j];
        A[p * ld + j] = c * ap - s * aq;
        A[q * ld + j] = s * ap + c * aq;
      }
      __syncthreads();
      // columns: A <- A J, V <- V J
      for (int idx = tid; idx < half * m; idx += THREADS) {
        const int k = idx / m, i = idx % m;
        const T s = cs[2 * k + 1];
        if (s == T(0)) continue;
        const T c = cs[2 * k];
        int p, q;
        pair_of(r, k, m, p, q);
        const T ap = A[i * ld + p], aq = A[i * ld + q];
        A[i * ld + p] = c * ap - s * aq;
        A[i * ld + q] = s * ap + c * aq;
        const T vp = V[i * ld + p], vq = V[i * ld + q];
        V[i * ld + p] = c * vp - s * vq;
        V[i * ld + q] = s * vp + c * vq;
      }
      __syncthreads();
      if (tid < half && cs[2 * tid + 1] != T(0)) {
        int p, q;
        pair_of(r, tid, m, p, q);
        A[p * ld + q] = 0;
        A[q * ld + p] = 0;
      }
      __syncthreads();
    }
    T off = 0, tot = 0;
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      const T a = A[i * ld + j];
      tot += a * a;
      if (i != j) off += a * a;
    }
    off = block_sum(off, scratch);
    tot = block_sum(tot, scratch);
    const T tol = T(m) * Eps<T>::value;
    // converged, or no longer shrinking (rounding level)
    if (off <= tol * tol * tot || (prev_off >= 0 && off >= prev_off)) break;
    prev_off = off;
  }

  if (sweeps_out != nullptr && tid == 0) *sweeps_out = sweep;

  // sort by rank: eigenvalue i goes to column rank(i)
  for (int idx = tid; idx < n * n; idx += THREADS) {
    const int i = idx / n, row = idx % n;
    const T wi = A[i * ld + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T wj = A[j * ld + j];
      rank += (wj < wi) || (wj == wi && j < i);
    }
    if (row == 0) w[rank] = wi;
    v_out[row * n + rank] = V[row * ld + i];
  }
}

template <typename T>
int launch(const void* a, int n, void* w, void* v, void* sweeps,
           void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int m = n + (n & 1);
  const size_t smem =
      sizeof(T) * (2 * (size_t)m * (m + 1) + m + THREADS / 32 + 1);
  cudaError_t e = cudaFuncSetAttribute(
      jacobi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  jacobi_kernel<T><<<1, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), n, m, static_cast<T*>(w),
      static_cast<T*>(v), static_cast<int*>(sweeps));
  return (int)cudaGetLastError();
}

}  // namespace

// sweeps (may be null): receives the number of sweeps the solve took
extern "C" int jacobi_eigh_f32(const void* a, int n, void* w, void* v,
                               void* sweeps, void* stream) {
  return launch<float>(a, n, w, v, sweeps, stream);
}

extern "C" int jacobi_eigh_f64(const void* a, int n, void* w, void* v,
                               void* sweeps, void* stream) {
  return launch<double>(a, n, w, v, sweeps, stream);
}
