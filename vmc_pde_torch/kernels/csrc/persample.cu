// Per-sample statistics of a coupling flow in one CUDA kernel: logp, the
// coordinate score g, the Hessian quadratic trace along the equation's
// trace directions, and the O row (grad_theta logp) of every sample.
//
// Replaces the TPU kernel vmc_pde_tpu/kernels/persample.py::
// make_per_sample_pallas in plain mode, and computes the mathematics of its
// reference functions _forward (forward flow, Gauss or Student-t latent),
// _backward (hand-written parameter and coordinate backward) and
// _tile_quad_jet (second-order jets: one (value, first, second) triple per
// direction), for every coupling variant with or without the learned
// global affine.
//
// Student-t latent: the two theta-only scalars the TPU kernel takes from
// outside (student_t_consts: nu, c0 = lgam((nu+d)/2) - lgam(nu/2) -
// d/2 log(nu pi), dg = (psi((nu+d)/2) - psi(nu/2))/2 - d/(2 nu)) ride in
// fconst, so the kernel never evaluates lgamma or digamma. Per sample,
// logp = c0 - sum L_diag - (nu+d)/2 log1p(q/nu) + logjac; every
// q-derived gradient scales by s = (nu+d)/(nu+q), and the nu row is
// (nu-1)(dg - log1p(q/nu)/2 + s q/(2 nu)).
// Global affine (per block, after the coupling): z = g ym + g_offset,
// logjac += d log g; the backward writes the g row sum(ym zbar) + d/g and
// the g_offset rows zbar, then continues with g zbar; the jets' tangents
// scale by g. ym is recomputed from the saves (v1 is its up half, the down
// half couple(u2, s1(v1), t1(v1))), so it costs no saves.
//
// Bound on the card: the (P, N) f32 O store -- 607 MB per right-hand side at
// P = 9264, N = 16384 -- against ~5 GFLOP of scalar f32 work, mostly the 16
// jets. Design: one thread per sample; theta, the latent inverse factor W,
// the trace directions and the block plan in shared memory (warp-wide
// broadcast reads); O, g and the forward saves written feature-major
// (feature * N + sample), so a warp's 32 stores hit 32 neighbouring words.
// Threads past N exit after the shared-memory load: any N runs.
//
// Split mode (SPLIT = true) replaces emit_split=True of the same TPU kernel:
// instead of the f32 O it stores the bf16 hi/lo split of o = O - shift
// (hi = rn(o), lo = rn(o - hi), as parallel/stats._split_bf16 makes it),
// and the column sums and column max |o| over the batch. The TPU carried
// those in its sequential grid; here blocks run in any order, so each warp
// reduces every row across its 32 samples with shuffles, lane 0 writes the
// warp's partial to (n_warps, P) buffers, and split_finish sums them in a
// fixed order: deterministic, no atomics. All 32 lanes must reach every
// shuffle, so in split mode the threads past N stay alive on a clamped
// sample, contribute 0 to the sum and the max, and store nothing. Bound at
// the chunked path's shape (P = 9264, N = 65536): the pair store, 2.43 GB,
// ~0.72 ms at 3.35 TB/s, plus the partials (152 MB written and read).
//
// The block plan (meta) is built by vmc_pde_torch/kernels/persample.py::
// block_plan; the constants below must match the ones there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int HDR = 16;
constexpr int MAX_DIM = 64;
constexpr int MAX_HALF = 32;
constexpr int MAX_WIDTH = 64;
constexpr int MAX_LAYERS = 4;
constexpr int NET_REC = 5 * MAX_LAYERS;
constexpr int BLOCK_REC = 8 + 4 * NET_REC + 2 * MAX_HALF + 2;
// slot of a block record holding the g_scale and g_offset offsets
constexpr int GA_REC = 8 + 4 * NET_REC + 2 * MAX_HALF;
constexpr int THREADS = 64;

enum Variant { ADDITIVE = 0, AFFINE = 1, SCALE = 2, SCALE_SHIFT = 3 };
enum Net { S1 = 0, S2 = 1, T1 = 2, T2 = 3 };

constexpr unsigned FULL_MASK = 0xffffffffu;

// One sample's view of the feature-major (features, N) buffers. The saves
// have one column per launched thread (stride Ns >= N); the outputs one per
// sample. SPLIT selects what o(p, v) does with the O entry v of row p.
template <bool SPLIT>
struct Sample {
  float* saves;
  float* O;                  // plain mode: (P, N) f32
  __nv_bfloat16* hi;         // split mode: (P, N) bf16 pair of O - shift
  __nv_bfloat16* lo;
  const float* shift;        // (P,)
  float* psum;               // (n_warps, P) per-warp partial sums of o
  float* pmax;               // (n_warps, P) per-warp partial max |o|
  size_t Ns;
  size_t N;
  size_t n;
  size_t warp;
  int P;
  bool valid;                // n < N (split-mode tail threads are not)
  __device__ float& sv(int k) const { return saves[(size_t)k * Ns + n]; }
  __device__ void o(int p, float v) const {
    if (!SPLIT) {
      O[(size_t)p * N + n] = v;
      return;
    }
    const float x = valid ? v - __ldg(shift + p) : 0.f;
    if (valid) {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      hi[(size_t)p * N + n] = h;
      lo[(size_t)p * N + n] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
    float s = x, m = fabsf(x);
    for (int k = 16; k > 0; k >>= 1) {
      s += __shfl_xor_sync(FULL_MASK, s, k);
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, k));
    }
    if ((threadIdx.x & 31) == 0) {
      psum[warp * P + p] = s;
      pmax[warp * P + p] = m;
    }
  }
};

// Layer record of a net: in, out, bias offset, weight offset, save offset.
__device__ __forceinline__ const int* layer(const int* blk, int net, int l) {
  return blk + 8 + net * NET_REC + 5 * l;
}

__device__ __forceinline__ float couple_fwd(int variant, float u, float s,
                                            float t) {
  switch (variant) {
    case ADDITIVE: return u + s;
    case AFFINE: return u * expf(s) + t;
    case SCALE: return u * expf(s);
    default: return u * expf(s) + s;  // SCALE_SHIFT
  }
}

// y = alpha * tanh(... tanh(h W0 + b0) ...); each layer's tanh output is
// saved for the backward and the jets.
template <class Smp>
__device__ void mlp_fwd(const int* blk, int net, int nl, const float* th,
                        float alpha, const float* hin, float* y,
                        const Smp& S) {
  float h[MAX_WIDTH], a[MAX_WIDTH];
  for (int i = 0; i < layer(blk, net, 0)[0]; ++i) h[i] = hin[i];
  int out = 0;
  for (int l = 0; l < nl; ++l) {
    const int* r = layer(blk, net, l);
    const int in = r[0];
    out = r[1];
    const float* b = th + r[2];
    const float* w = th + r[3];
    for (int o = 0; o < out; ++o) {
      float acc = b[o];
      for (int i = 0; i < in; ++i) acc = fmaf(h[i], w[i * out + o], acc);
      a[o] = tanhf(acc);
      S.sv(r[4] + o) = a[o];
    }
    for (int o = 0; o < out; ++o) h[o] = a[o];
  }
  for (int o = 0; o < out; ++o) y[o] = alpha * h[o];
}

// Backward of mlp_fwd for the output cotangent ybar: writes the net's O
// rows (biases, then row-major weights) and adds the input cotangent to
// xacc.
template <class Smp>
__device__ void mlp_bwd(const int* blk, int net, int nl, const float* th,
                        float alpha, const float* hin, const float* ybar,
                        float* xacc, const Smp& S) {
  float abar[MAX_WIDTH], xbar[MAX_WIDTH];
  const int* last = layer(blk, net, nl - 1);
  for (int o = 0; o < last[1]; ++o) {
    const float t = S.sv(last[4] + o);
    abar[o] = ybar[o] * alpha * (1.f - t * t);
  }
  for (int l = nl - 1; l >= 0; --l) {
    const int* r = layer(blk, net, l);
    const int in = r[0], out = r[1];
    const float* w = th + r[3];
    const int* prev = l > 0 ? layer(blk, net, l - 1) : nullptr;
    for (int o = 0; o < out; ++o) S.o(r[2] + o, abar[o]);
    for (int i = 0; i < in; ++i) {
      const float hi = prev ? S.sv(prev[4] + i) : hin[i];
      float acc = 0.f;
      for (int o = 0; o < out; ++o) {
        S.o(r[3] + i * out + o, hi * abar[o]);
        acc = fmaf(w[i * out + o], abar[o], acc);
      }
      xbar[i] = acc;
    }
    if (prev) {
      for (int i = 0; i < in; ++i) {
        const float t = S.sv(prev[4] + i);
        abar[i] = xbar[i] * (1.f - t * t);
      }
    }
  }
  for (int i = 0; i < layer(blk, net, 0)[0]; ++i) xacc[i] += xbar[i];
}

// First and second tangents of the net output along one direction, from
// those of its input (h1, h2); primal tanh values come from the saves.
// Bias enters the primal only; tanh'' = -2 tanh (1 - tanh^2).
template <class Smp>
__device__ void mlp_jet(const int* blk, int net, int nl, const float* th,
                        float alpha, const float* h1in, const float* h2in,
                        float* y1, float* y2, const Smp& S) {
  float h1[MAX_WIDTH], h2[MAX_WIDTH], a1[MAX_WIDTH], a2[MAX_WIDTH];
  for (int i = 0; i < layer(blk, net, 0)[0]; ++i) {
    h1[i] = h1in[i];
    h2[i] = h2in[i];
  }
  int out = 0;
  for (int l = 0; l < nl; ++l) {
    const int* r = layer(blk, net, l);
    const int in = r[0];
    out = r[1];
    const float* w = th + r[3];
    for (int o = 0; o < out; ++o) {
      float p1 = 0.f, p2 = 0.f;
      for (int i = 0; i < in; ++i) {
        p1 = fmaf(h1[i], w[i * out + o], p1);
        p2 = fmaf(h2[i], w[i * out + o], p2);
      }
      const float t = S.sv(r[4] + o);
      const float s = 1.f - t * t;
      a1[o] = s * p1;
      a2[o] = s * p2 - 2.f * t * s * p1 * p1;
    }
    for (int o = 0; o < out; ++o) {
      h1[o] = a1[o];
      h2[o] = a2[o];
    }
  }
  for (int o = 0; o < out; ++o) {
    y1[o] = alpha * h1[o];
    y2[o] = alpha * h2[o];
  }
}

// Primal conditioner output s = alpha * (last tanh), from the saves.
template <class Smp>
__device__ void net_out(const int* blk, int net, int nl, float alpha,
                        float* s, const Smp& S) {
  const int* last = layer(blk, net, nl - 1);
  for (int o = 0; o < last[1]; ++o) s[o] = alpha * S.sv(last[4] + o);
}

// Backward of v = couple(u, s, t) for the cotangent vbar, including the
// log-Jacobian's d(sum s)/ds = 1 for the scaling variants.
__device__ void couple_bwd(int variant, int m, const float* vbar,
                           const float* u, const float* s, float* sbar,
                           float* tbar, float* ubar) {
  for (int i = 0; i < m; ++i) {
    if (variant == ADDITIVE) {
      sbar[i] = vbar[i];
      ubar[i] = vbar[i];
      continue;
    }
    const float es = expf(s[i]);
    ubar[i] = vbar[i] * es;
    tbar[i] = vbar[i];
    sbar[i] = variant == SCALE_SHIFT ? vbar[i] * (u[i] * es + 1.f) + 1.f
                                     : vbar[i] * u[i] * es + 1.f;
  }
}

// Jets of v = couple(u, s, t): u0/s0 primal, (u1, u2), (s1, s2), (t1, t2)
// first and second tangents. exp'' = exp (s'' + s'^2),
// (u e)'' = u'' e + 2 u' e' + u e''.
__device__ void couple_jet(int variant, int m, const float* u0,
                           const float* u1, const float* u2, const float* s0,
                           const float* s1, const float* s2, const float* t1,
                           const float* t2, float* v1, float* v2) {
  for (int i = 0; i < m; ++i) {
    if (variant == ADDITIVE) {
      v1[i] = u1[i] + s1[i];
      v2[i] = u2[i] + s2[i];
      continue;
    }
    const float e = expf(s0[i]);
    const float e1 = e * s1[i];
    const float e2 = e * (s2[i] + s1[i] * s1[i]);
    v1[i] = u1[i] * e + u0[i] * e1;
    v2[i] = u2[i] * e + 2.f * u1[i] * e1 + u0[i] * e2;
    if (variant == AFFINE) {
      v1[i] += t1[i];
      v2[i] += t2[i];
    } else if (variant == SCALE_SHIFT) {
      v1[i] += s1[i];
      v2[i] += s2[i];
    }
  }
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS) persample_kernel(
    const float* __restrict__ x, const float* __restrict__ theta,
    const float* __restrict__ fconst, const int* __restrict__ meta_g, int N,
    int P, int n_fconst, int n_meta, float* __restrict__ logp_out,
    float* __restrict__ g_out, float* __restrict__ quad_out,
    float* __restrict__ O, __nv_bfloat16* __restrict__ O_hi,
    __nv_bfloat16* __restrict__ O_lo, const float* __restrict__ shift,
    float* __restrict__ psum, float* __restrict__ pmax,
    float* __restrict__ saves) {
  extern __shared__ float smem[];
  float* th = smem;
  float* fc = smem + P;
  int* meta = reinterpret_cast<int*>(smem + P + n_fconst);
  for (int i = threadIdx.x; i < P; i += blockDim.x) th[i] = theta[i];
  for (int i = threadIdx.x; i < n_fconst; i += blockDim.x) fc[i] = fconst[i];
  for (int i = threadIdx.x; i < n_meta; i += blockDim.x) meta[i] = meta_g[i];
  __syncthreads();
  const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = n < (size_t)N;
  if (!SPLIT && !valid) return;
  // split mode: a tail thread runs the last sample and stores nothing
  const size_t n_in = valid ? n : (size_t)N - 1;

  const int d = meta[0], nb = meta[1], k_dirs = meta[2];
  const int off_L = meta[4], off_ld = meta[5], off_mu = meta[6];
  const bool student = meta[8] != 0;
  const int off_dp = meta[9];
  const float* W = fc;  // U^{-1}, row-major (d, d)
  const float* offset = W + d * d;
  const float* dirs = offset + d;
  const float* alphas = dirs + k_dirs * d;
  // Student-t: nu, c0, dg (computed from theta by the wrapper)
  const float nu = student ? alphas[nb] : 0.f;
  const Sample<SPLIT> S{saves, O, O_hi, O_lo, shift, psum, pmax,
                        (size_t)gridDim.x * blockDim.x, (size_t)N, n,
                        n / 32, P, valid};

  float z[MAX_DIM];
  for (int i = 0; i < d; ++i) z[i] = x[n_in * d + i];

  // ---- forward: real -> latent, saving what the backward and jets reuse
  float logjac = 0.f;
  float u1[MAX_HALF], u2[MAX_HALF], v1[MAX_HALF], sv[MAX_HALF], tv[MAX_HALF];
  for (int b = 0; b < nb; ++b) {
    const int* blk = meta + HDR + b * BLOCK_REC;
    const int variant = blk[0], n_up = blk[1], n_down = blk[2], nl = blk[3];
    const int* up = blk + 8 + 4 * NET_REC;
    const int* down = up + MAX_HALF;
    const float alpha = alphas[b];
    for (int i = 0; i < n_up; ++i) S.sv(blk[4] + i) = u1[i] = z[up[i]];
    for (int i = 0; i < n_down; ++i) S.sv(blk[5] + i) = u2[i] = z[down[i]];
    mlp_fwd(blk, S2, nl, th, alpha, u2, sv, S);
    if (variant == AFFINE) mlp_fwd(blk, T2, nl, th, alpha, u2, tv, S);
    for (int i = 0; i < n_up; ++i) {
      S.sv(blk[6] + i) = v1[i] = couple_fwd(variant, u1[i], sv[i], tv[i]);
      if (variant != ADDITIVE) logjac += sv[i];
    }
    mlp_fwd(blk, S1, nl, th, alpha, v1, sv, S);
    if (variant == AFFINE) mlp_fwd(blk, T1, nl, th, alpha, v1, tv, S);
    for (int i = 0; i < n_down; ++i) {
      z[down[i]] = couple_fwd(variant, u2[i], sv[i], tv[i]);
      if (variant != ADDITIVE) logjac += sv[i];
    }
    for (int i = 0; i < n_up; ++i) z[up[i]] = v1[i];
    if (blk[7]) {  // global affine
      const float g = th[blk[GA_REC]];
      const float* g_off = th + blk[GA_REC + 1];
      for (int i = 0; i < d; ++i) z[i] = fmaf(g, z[i], g_off[i]);
      logjac += d * logf(g);
    }
  }

  // ---- latent: y = W (z - offset - mu), q = |y|^2
  float y[MAX_DIM];
  float q = 0.f, sum_ld = 0.f;
  for (int i = 0; i < d; ++i) {
    float acc = 0.f;
    for (int j = 0; j < d; ++j)
      acc = fmaf(W[i * d + j], z[j] - offset[j] - th[off_mu + j], acc);
    y[i] = acc;
    q = fmaf(acc, acc, q);
    sum_ld += th[off_ld + i];
  }
  // Student-t: dlogp/dq = -s/2 with s = (nu+d)/(nu+q) (Gauss: s = 1)
  const float l1q = student ? log1pf(q / nu) : 0.f;
  const float s_t = student ? (nu + d) / (nu + q) : 1.f;
  if (valid)
    logp_out[n] = student
        ? alphas[nb + 1] - sum_ld - 0.5f * (nu + d) * l1q + logjac
        : -0.5f * (d * 1.8378770664093453f + 2.f * sum_ld + q) + logjac;

  // ---- backward. Latent (Gauss; Student-t scales each q-derived term by
  // s): dlogp/dU[i,j] = (W^T y)_i y_j, dlogp/dL_diag_i =
  // (W^T y)_i y_i exp(L_diag_i) - 1, dlogp/dmu = W^T y, dlogp/dz = -W^T y.
  float zbar[MAX_DIM];
  {
    float wty[MAX_DIM];
    for (int i = 0; i < d; ++i) {
      float acc = 0.f;
      for (int j = 0; j < d; ++j) acc = fmaf(W[j * d + i], y[j], acc);
      acc *= s_t;
      wty[i] = acc;
      zbar[i] = -acc;
      S.o(off_mu + i, acc);
      S.o(off_ld + i, acc * y[i] * expf(th[off_ld + i]) - 1.f);
    }
    int k = off_L;  // strictly-upper entries in row-major (triu) order
    for (int i = 0; i < d; ++i)
      for (int j = i + 1; j < d; ++j) S.o(k++, wty[i] * y[j]);
    if (student)
      S.o(off_dp, (nu - 1.f) * (alphas[nb + 2] - 0.5f * l1q
                                + s_t * q / (2.f * nu)));
  }
  for (int b = nb - 1; b >= 0; --b) {
    const int* blk = meta + HDR + b * BLOCK_REC;
    const int variant = blk[0], n_up = blk[1], n_down = blk[2], nl = blk[3];
    const int* up = blk + 8 + 4 * NET_REC;
    const int* down = up + MAX_HALF;
    const float alpha = alphas[b];
    float v1bar[MAX_HALF], v2bar[MAX_HALF], sbar[MAX_HALF], tbar[MAX_HALF],
        ubar[MAX_HALF];
    for (int i = 0; i < n_up; ++i) {
      u1[i] = S.sv(blk[4] + i);
      v1[i] = S.sv(blk[6] + i);
    }
    for (int i = 0; i < n_down; ++i) u2[i] = S.sv(blk[5] + i);
    net_out(blk, S1, nl, alpha, sv, S);
    if (blk[7]) {
      // global affine z = g ym + g_offset: g row sum(ym zbar) + d/g,
      // g_offset rows zbar, then ym's cotangent g zbar. ym's down half is
      // recomputed from the saves as the forward made it
      if (variant == AFFINE) net_out(blk, T1, nl, alpha, tv, S);
      const float g = th[blk[GA_REC]];
      float acc = 0.f;
      for (int i = 0; i < n_up; ++i) acc = fmaf(v1[i], zbar[up[i]], acc);
      for (int i = 0; i < n_down; ++i)
        acc = fmaf(couple_fwd(variant, u2[i], sv[i], tv[i]), zbar[down[i]],
                   acc);
      S.o(blk[GA_REC], acc + d / g);
      for (int i = 0; i < d; ++i) {
        S.o(blk[GA_REC + 1] + i, zbar[i]);
        zbar[i] *= g;
      }
    }
    for (int i = 0; i < n_up; ++i) v1bar[i] = zbar[up[i]];
    for (int i = 0; i < n_down; ++i) v2bar[i] = zbar[down[i]];
    // v2 = couple(u2, s1(v1), t1(v1))
    couple_bwd(variant, n_down, v2bar, u2, sv, sbar, tbar, ubar);
    mlp_bwd(blk, S1, nl, th, alpha, v1, sbar, v1bar, S);
    if (variant == AFFINE) mlp_bwd(blk, T1, nl, th, alpha, v1, tbar, v1bar, S);
    // v1 = couple(u1, s2(u2), t2(u2)); ubar (the u2 cotangent) accumulates
    net_out(blk, S2, nl, alpha, sv, S);
    couple_bwd(variant, n_up, v1bar, u1, sv, sbar, tbar, v2bar);
    mlp_bwd(blk, S2, nl, th, alpha, u2, sbar, ubar, S);
    if (variant == AFFINE) mlp_bwd(blk, T2, nl, th, alpha, u2, tbar, ubar, S);
    for (int i = 0; i < n_up; ++i) zbar[up[i]] = v2bar[i];
    for (int i = 0; i < n_down; ++i) zbar[down[i]] = ubar[i];
  }
  if (valid)
    for (int i = 0; i < d; ++i) g_out[(size_t)i * N + n] = zbar[i];

  // ---- Hessian quadratic trace: per direction v, the second derivative
  // of t -> logp(x + t v) by second-order jets (x' = v, x'' = 0).
  if (k_dirs == 0) return;
  float quad = 0.f;
  for (int j = 0; j < k_dirs; ++j) {
    float z1[MAX_DIM], z2[MAX_DIM];
    for (int i = 0; i < d; ++i) {
      z1[i] = dirs[j * d + i];
      z2[i] = 0.f;
    }
    float lj2 = 0.f;
    for (int b = 0; b < nb; ++b) {
      const int* blk = meta + HDR + b * BLOCK_REC;
      const int variant = blk[0], n_up = blk[1], n_down = blk[2],
                nl = blk[3];
      const int* up = blk + 8 + 4 * NET_REC;
      const int* down = up + MAX_HALF;
      const float alpha = alphas[b];
      float a1[MAX_HALF], a2[MAX_HALF], c1[MAX_HALF], c2[MAX_HALF];
      float s1[MAX_HALF], s2[MAX_HALF], t1[MAX_HALF], t2[MAX_HALF];
      float w1[MAX_HALF], w2[MAX_HALF];
      for (int i = 0; i < n_up; ++i) {
        u1[i] = S.sv(blk[4] + i);
        a1[i] = z1[up[i]];
        a2[i] = z2[up[i]];
      }
      for (int i = 0; i < n_down; ++i) {
        u2[i] = S.sv(blk[5] + i);
        c1[i] = z1[down[i]];
        c2[i] = z2[down[i]];
      }
      // v1 jets from u1's and s2(u2)'s (and t2(u2)'s)
      mlp_jet(blk, S2, nl, th, alpha, c1, c2, s1, s2, S);
      if (variant == AFFINE) mlp_jet(blk, T2, nl, th, alpha, c1, c2, t1, t2, S);
      net_out(blk, S2, nl, alpha, sv, S);
      couple_jet(variant, n_up, u1, a1, a2, sv, s1, s2, t1, t2, w1, w2);
      if (variant != ADDITIVE)
        for (int i = 0; i < n_up; ++i) lj2 += s2[i];
      // v2 jets from u2's and s1(v1)'s (and t1(v1)'s)
      mlp_jet(blk, S1, nl, th, alpha, w1, w2, s1, s2, S);
      if (variant == AFFINE) mlp_jet(blk, T1, nl, th, alpha, w1, w2, t1, t2, S);
      net_out(blk, S1, nl, alpha, sv, S);
      couple_jet(variant, n_down, u2, c1, c2, sv, s1, s2, t1, t2, a1, a2);
      if (variant != ADDITIVE)
        for (int i = 0; i < n_down; ++i) lj2 += s2[i];
      for (int i = 0; i < n_up; ++i) {
        z1[up[i]] = w1[i];
        z2[up[i]] = w2[i];
      }
      for (int i = 0; i < n_down; ++i) {
        z1[down[i]] = a1[i];
        z2[down[i]] = a2[i];
      }
      if (blk[7]) {
        const float g = th[blk[GA_REC]];
        for (int i = 0; i < d; ++i) {
          z1[i] *= g;
          z2[i] *= g;
        }
      }
    }
    // with y' = W z', y'' = W z'': q' = 2 q1, q'' = 2 q2 below. Gauss:
    // logp'' = -q''/2 + logjac''. Student-t: logp = f(q) + ..., f' = -h1,
    // f'' = h1 / (nu (1 + q/nu)), h1 = (nu+d) / (2 nu (1 + q/nu))
    float q1 = 0.f, q2 = 0.f;
    for (int i = 0; i < d; ++i) {
      float p1 = 0.f, p2 = 0.f;
      for (int k = 0; k < d; ++k) {
        p1 = fmaf(W[i * d + k], z1[k], p1);
        p2 = fmaf(W[i * d + k], z2[k], p2);
      }
      q1 = fmaf(y[i], p1, q1);
      q2 += p1 * p1 + y[i] * p2;
    }
    if (student) {
      const float onepu = 1.f + q / nu;
      const float h1 = 0.5f * (nu + d) / nu / onepu;
      const float h2 = h1 / nu / onepu;
      quad += lj2 - (h1 * 2.f * q2 - h2 * 4.f * q1 * q1);
    } else {
      quad += lj2 - q2;
    }
  }
  if (valid) quad_out[n] = quad;
}

// Column sums and max of the split mode from the (n_warps, P) per-warp
// partials: one thread per row p, the warps summed in index order, so the
// result does not depend on the order in which blocks ran.
__global__ void split_finish(const float* __restrict__ psum,
                             const float* __restrict__ pmax, int n_warps,
                             int P, float* __restrict__ colsum,
                             float* __restrict__ colmax) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f, m = 0.f;
  for (int w = 0; w < n_warps; ++w) {
    s += psum[(size_t)w * P + p];
    m = fmaxf(m, pmax[(size_t)w * P + p]);
  }
  colsum[p] = s;
  colmax[p] = m;
}

template <bool SPLIT>
int launch(const float* x, const float* theta, const float* fconst,
           const int* meta, int N, int P, int n_fconst, int n_meta,
           float* logp, float* g, float* quad, float* O,
           __nv_bfloat16* O_hi, __nv_bfloat16* O_lo, const float* shift,
           float* psum, float* pmax, float* saves, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)P + n_fconst) + sizeof(int) * n_meta;
  cudaError_t err = cudaFuncSetAttribute(
      persample_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + THREADS - 1) / THREADS;
  persample_kernel<SPLIT><<<blocks, THREADS, smem, stream>>>(
      x, theta, fconst, meta, N, P, n_fconst, n_meta, logp, g, quad, O, O_hi,
      O_lo, shift, psum, pmax, saves);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: launch on ``stream`` and return cudaGetLastError() (0 on
// success). x (N, d) row-major; theta (P,); fconst = [W (d*d), offset (d),
// dirs (k*d), alphas (n_blocks), and for Student-t nu, c0, dg]; meta the
// block plan. Outputs: logp (N,),
// g (d, N), quad (N,) (may be null when the plan has no directions), and O
// (P, N) f32 -- or, split, O_hi and O_lo (P, N) bf16 of O - shift, colsum
// and colmax (P,). Scratch: saves (n_saves, ceil(N / 64) * 64) and, split,
// psum and pmax (ceil(N / 64) * 2, P).
extern "C" int persample_f32(const float* x, const float* theta,
                             const float* fconst, const int* meta, int N,
                             int P, int n_fconst, int n_meta, float* logp,
                             float* g, float* quad, float* O, float* saves,
                             void* stream) {
  return launch<false>(x, theta, fconst, meta, N, P, n_fconst, n_meta, logp,
                       g, quad, O, nullptr, nullptr, nullptr, nullptr,
                       nullptr, saves, (cudaStream_t)stream);
}

extern "C" int persample_split_f32(
    const float* x, const float* theta, const float* fconst, const int* meta,
    int N, int P, int n_fconst, int n_meta, const float* shift, float* logp,
    float* g, float* quad, void* O_hi, void* O_lo, float* colsum,
    float* colmax, float* psum, float* pmax, float* saves, void* stream) {
  const int err = launch<true>(
      x, theta, fconst, meta, N, P, n_fconst, n_meta, logp, g, quad, nullptr,
      (__nv_bfloat16*)O_hi, (__nv_bfloat16*)O_lo, shift, psum, pmax, saves,
      (cudaStream_t)stream);
  if (err != 0) return err;
  const int n_warps = ((N + THREADS - 1) / THREADS) * (THREADS / 32);
  split_finish<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      psum, pmax, n_warps, P, colsum, colmax);
  return (int)cudaGetLastError();
}
