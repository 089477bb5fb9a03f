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
// global affine, at any dim, coupling half, conditioner width and depth,
// and any number of coupling blocks (none: the latent alone, behind
// SanityFlow's learned scale z = s x where the flow has one).
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
// What bounds it on the card. At fokkerPlanck32 (P = 9264, 16 trace
// directions) one sample costs ~635k f32 operations, ~90% of them the 16
// second-order jets, and writes 37 KB of O: at N = 16384 the (P, N) f32
// store is 607 MB (0.18 ms at 3.35 TB/s) against 10.4 GFLOP (0.155 ms at
// the 67 TFLOP/s FFMA peak) -- a balanced bound, so the design has to feed
// both the FMA pipe and the store stream. The jets grow as d k: at d = 128
// (64 directions) they are ~95% of the operations. The design:
//
// - Tiles of T samples (T in {8, 16, 32}, the wrapper's tile_plan), one
//   block per tile, or, with a workspace or in split mode at a large P, a
//   grid of blocks each running every grid-th tile in order.
// - A block's regions (block_layout): theta (repacked by the wrapper:
//   every layer zero-padded to MW x MW at the register width, rows 16-byte
//   aligned), the constants (W^T = U^{-T} with rows padded to 8, the
//   trace directions, ...), the block plan, the tile's arrays (forward
//   saves, W^T y, quad terms) and the work rows (the backward's rows, the
//   jets' tangents). The plan and the per-sample scalars sit in shared
//   memory; each of the others sits there where it fits (the plan's
//   ``where``), else theta and the constants are read from their inputs
//   and the tile's arrays and the work rows from the block's slice of a
//   global workspace (which stays in L2). The saves are sample-minor (save
//   k of sample s at k * T + s): a warp's reads hit 32 banks.
// - Forward and backward run over (sample, unit) items of the whole block,
//   one phase per layer between barriers, ILP items per thread; an affine
//   block's two conditioners go through the same phases.
// - The jets run one (sample, direction) pair per thread: the pair's
//   tangents z', z'' live in the work rows (slot-minor). At the register
//   width (MW = 16: every layer and half at most 16 wide, every region in
//   shared memory) each conditioner layer's input, output and accumulators
//   sit in registers (indexed only by unrolled loops), each weight row read
//   as 16-byte broadcast loads, the next row loaded while the current one
//   is used. Wider flows take the chunked body (MW = 0): a layer's outputs
//   in chunks of REGISTER_WIDTH in registers, its input tangents read from
//   the work rows (the half's for the first layer, a layer buffer after),
//   so no array grows with the width. The sum over directions is a fixed
//   loop per sample. |W z'|^2 walks W's upper triangle only.
// - O rows are written cooperatively along the sample axis of the
//   feature-major (P, N) output: 16-byte streaming stores (__stcs: 4 f32
//   samples, or 8 bf16 samples of each split half), each row's T samples
//   in T/4 (T/8) neighbouring lanes. Rows the tile's ragged edge cuts, or
//   rows that are not 16-byte aligned (N % 4 or N % 8 nonzero), store
//   element by element under a mask: any N runs.
// - The forward saves never leave the block; DUMP (a template flag) copies
//   them out for tools/persample_blocks.py when a buffer is given.
//
// Measured on an H100 (PERF.md, section 6): 1.04-1.05 ms of kernel time at
// N = 16384, 17% of the bound; split mode 5.1-5.4 ms at N = 65536, 13-14%.
// The jets take ~62% of a block's cycles and run at ~21% of the FFMA rate:
// each broadcast weight load feeds 8 FMAs per lane, so shared-memory
// bandwidth caps them at half of it, and one 207 KB block per SM (8 warps)
// leaves the rest to latency. The O stores overlap the arithmetic: a build
// without them (tools/persample_probe.py) is under 1% faster.
//
// Split mode (SPLIT = true) replaces emit_split=True of the same TPU kernel:
// instead of the f32 O it stores the bf16 hi/lo split of o = O - shift
// (hi = rn(o), lo = rn(o - hi), as parallel/stats._split_bf16 makes it),
// and the column sums and column max |o| over the batch. Each row's T
// values reduce in a fixed order (each lane's 8 in sequence, then an xor
// tree over the row's lanes) into the block's (grid, P) partial, its tiles
// in order, and split_finish sums the partials in block order:
// deterministic, no atomics. Samples past N contribute 0 to the sum and
// the max.
//
// The block plan (meta) and the block's layout are built by
// vmc_pde_torch/kernels/persample.py; the constants below must match the
// ones there (tests/test_torch_persample.py parses them from this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

// the block's dynamic shared memory (layout: block_layout)
extern __shared__ __align__(16) float smem[];

namespace {

constexpr int HDR = 20;
// a block record's fixed part: variant, n_up, n_down, n_layers, the save
// offsets of u1, u2 and v1, the global-affine flag, g_scale's and
// g_offset's offsets in theta and in the repacked theta
constexpr int BLOCK_HDR = 12;
// a conditioner layer's record: in, out, bias and weight offsets in theta
// (the O rows), save offset of its tanh output, bias and weight offsets
// and row stride in the repacked theta
constexpr int LAYER_REC = 8;
constexpr int MAX_THREADS = 256;
// shared (SW, T) scratch rows of the backward (SW: the flow's widest
// layer or half, meta[14]), and per-sample scalars
constexpr int N_SCRATCH = 8;
constexpr int N_PER_SAMPLE = 5;
// the jets' register arrays at the register width; the chunked body's
// output chunk
constexpr int REGISTER_WIDTH = 16;

enum Variant { ADDITIVE = 0, AFFINE = 1, SCALE = 2, SCALE_SHIFT = 3 };
enum Net { S1 = 0, S2 = 1, T1 = 2, T2 = 3 };
// a block's regions that may sit in shared memory, by their bit in
// ``where``: theta, the constants, the tile's arrays, the work rows
enum Region { TH = 1, FC = 2, TILE = 4, WORK = 8, ALL = 15 };

// Float offsets of one block's regions: in shared memory, or (the tile's
// arrays and the work rows) in the block's workspace slice. theta and the
// constants outside shared memory are read from their inputs. The
// backward's rows (z, zb, y, swy, the scratch) and the jets' tangents and
// layer buffers are never live together and share the work rows. The
// wrapper computes the same layout (persample.smem_floats) and passes its
// shared bytes and workspace floats; the launch refuses a mismatch.
struct Layout {
  int th, fc, meta, ps, tile, work, shared, ws;
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline Layout block_layout(int Pk, int nf, int nm,
                                               int nsv, int d, int k, int T,
                                               int J, int SW, int JB,
                                               int where) {
  Layout L;
  int o = 0, w = 0;
  L.th = o;
  if (where & TH) o += up4(Pk);
  L.fc = o;
  if (where & FC) o += up4(nf);
  L.meta = o;
  o += up4(nm);
  L.ps = o;
  o += N_PER_SAMPLE * T;
  const int tile = (nsv + d + k) * T;
  const int back = 4 * d * T + N_SCRATCH * SW * T;
  const int jet = k ? (2 * d + JB) * J : 0;
  const int work = up4(back > jet ? back : jet);
  int& at_tile = where & TILE ? o : w;
  L.tile = at_tile;
  at_tile += tile;
  int& at_work = where & WORK ? o : w;
  L.work = at_work;
  at_work += work;
  L.shared = o;
  L.ws = w;
  return L;
}

// Record of a conditioner layer (LAYER_REC ints) of the block record blk.
__device__ __forceinline__ const int* layer(const int* blk, int net, int l) {
  return blk + BLOCK_HDR + (net * blk[3] + l) * LAYER_REC;
}

// The block's ind_up; its ind_down follow them.
__device__ __forceinline__ const int* up_half(const int* blk) {
  return blk + BLOCK_HDR + 4 * blk[3] * LAYER_REC;
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

// What the block shares: its regions and its tile.
struct Ctx {
  const float* th;   // repacked theta
  const float* fc;   // W^T (rows padded to d8), offset, dirs, alphas, ...
  const int* meta;
  float* sv;         // saves, (n_saves, T)
  float* z;          // coordinates, (d, T)
  float* zb;         // their cotangent
  float* y;          // latent y = W (z - offset - mu)
  float* wy;         // W^T y
  float* swy;        // s W^T y (s = 1 for Gauss)
  float* sc;         // N_SCRATCH (SW, T) rows
  float* ps;         // per-sample scalars (N_PER_SAMPLE, T)
  float* qb;         // per-pair quad terms, (k, T)
  float* jz;         // jet tangents z', z'' (2 d, J), then layer buffers
  int T, logT, J;
  int n0, nv;        // first sample of the tile, valid samples in it
  int N, P;
  bool first;        // the block's first tile
};

// One O row's values for the tile: c * A[s] * B[s] + e (B null: 1).
struct RowSrc {
  const float* A;
  const float* B;
  float c, e;
};

// The tile's O rows [row0, row0 + n_rows) of feature-major (P, N) output,
// the row r's values from src(r). V samples per lane, the row's T samples
// in T / V neighbouring lanes; vector stores where the row is aligned and
// whole, element stores under the sample mask elsewhere. Split mode: the
// bf16 pair of v - shift, and the row's sum and max |.| over the tile's
// valid samples (each lane's V in order, then an xor tree over the row's
// lanes), added by the row's first lane to the block's partial.
template <bool SPLIT>
struct Store {
  float* O;
  __nv_bfloat16* hi;
  __nv_bfloat16* lo;
  const float* shift;
  float* psum;
  float* pmax;

  template <class F>
  __device__ void rows(const Ctx& C, int row0, int n_rows, F src) const {
    constexpr int V = SPLIT ? 8 : 4, LOG_V = SPLIT ? 3 : 2;
    const int log_per_row = C.logT - LOG_V;
    const int per_row = 1 << log_per_row;  // 1, 2 or 4 (8 for f32, T = 32)
    const int items = n_rows << log_per_row;
    const bool vec_ok = (C.N % V) == 0;
#pragma unroll 4
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int r = it >> log_per_row;
      const int s0 = (it & (per_row - 1)) * V;
      const RowSrc q = src(r);
      float v[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q.A + s0 + j);
        float4 b = make_float4(1.f, 1.f, 1.f, 1.f);
        if (q.B) b = *reinterpret_cast<const float4*>(q.B + s0 + j);
        v[j] = fmaf(q.c * a.x, b.x, q.e);
        v[j + 1] = fmaf(q.c * a.y, b.y, q.e);
        v[j + 2] = fmaf(q.c * a.z, b.z, q.e);
        v[j + 3] = fmaf(q.c * a.w, b.w, q.e);
      }
      const int p = row0 + r;
      const size_t base = (size_t)p * C.N + C.n0 + s0;
      const bool whole = vec_ok && s0 + V <= C.nv;
      if (!SPLIT) {
        if (whole) {
          __stcs(reinterpret_cast<float4*>(O + base),
                 make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (s0 + j < C.nv) __stcs(O + base + j, v[j]);
        }
        continue;
      }
      const float sh = __ldg(shift + p);
      float sum = 0.f, mx = 0.f;
      // hi = rn(x), lo = rn(x - hi), two samples per conversion (the same
      // rounding as one at a time)
      __nv_bfloat162 h2[V / 2], l2[V / 2];
#pragma unroll
      for (int j = 0; j < V; j += 2) {
        const float x0 = s0 + j < C.nv ? v[j] - sh : 0.f;
        const float x1 = s0 + j + 1 < C.nv ? v[j + 1] - sh : 0.f;
        h2[j / 2] = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h2[j / 2]);
        l2[j / 2] = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        sum += x0;
        sum += x1;
        mx = fmaxf(mx, fmaxf(fabsf(x0), fabsf(x1)));
      }
      if (whole) {
        uint32_t hw[V / 2], lw[V / 2];
#pragma unroll
        for (int j = 0; j < V / 2; ++j) {
          memcpy(&hw[j], &h2[j], 4);
          memcpy(&lw[j], &l2[j], 4);
        }
        __stcs(reinterpret_cast<int4*>(hi + base),
               make_int4(hw[0], hw[1], hw[2], hw[3]));
        __stcs(reinterpret_cast<int4*>(lo + base),
               make_int4(lw[0], lw[1], lw[2], lw[3]));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (s0 + j < C.nv) {
            hi[base + j] = j & 1 ? __high2bfloat16(h2[j / 2])
                                 : __low2bfloat16(h2[j / 2]);
            lo[base + j] = j & 1 ? __high2bfloat16(l2[j / 2])
                                 : __low2bfloat16(l2[j / 2]);
          }
      }
      if (per_row > 1) {
        // the row's lanes are a naturally aligned group of the warp
        const int lane = threadIdx.x & 31;
        const unsigned gmask = ((1u << per_row) - 1u)
                               << (lane & ~(per_row - 1));
        for (int k = 1; k < per_row; k <<= 1) {
          sum += __shfl_xor_sync(gmask, sum, k);
          mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, k));
        }
      }
      if (s0 == 0) {
        // the block's partial over its tiles, in their order
        const size_t at = (size_t)blockIdx.x * C.P + p;
        psum[at] = C.first ? sum : psum[at] + sum;
        pmax[at] = C.first ? mx : fmaxf(pmax[at], mx);
      }
    }
  }
};

// Items of a block-wide phase each thread runs together (independent
// chains of shared loads and FMAs, so their latencies overlap).
constexpr int ILP = 4;

// Forward of one block's nets na and, if nb_ >= 0, nb_ (S2 and T2, or S1
// and T1: the same widths and input) from their input save rows, layer by
// layer over (net, unit, sample) items: each layer's tanh output goes to
// its save rows.
__device__ void fwd_nets(const Ctx& C, const int* blk, int na, int nb_,
                         int in_sv) {
  const int nl = blk[3];
  for (int l = 0; l < nl; ++l) {
    const int ca = layer(blk, na, l)[1], in = layer(blk, na, l)[0];
    const int ld = layer(blk, na, l)[7];
    const int items = (nb_ >= 0 ? 2 * ca : ca) << C.logT;
    for (int base = threadIdx.x; base < items; base += ILP * blockDim.x) {
      const float* w[ILP];
      const float* h[ILP];
      float acc[ILP];
      int dst[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        int it = base + u * blockDim.x;
        dst[u] = -1;
        if (it >= items) it = base;  // a duplicate, not stored
        const int s = it & (C.T - 1);
        int o = it >> C.logT, net = na;
        if (o >= ca) {
          o -= ca;
          net = nb_;
        }
        const int* r = layer(blk, net, l);
        w[u] = C.th + r[6] + o;
        h[u] = C.sv + ((l ? layer(blk, net, l - 1)[4] : in_sv) << C.logT) + s;
        acc[u] = C.th[r[5] + o];
        if (base + u * blockDim.x < items) dst[u] = ((r[4] + o) << C.logT) + s;
      }
      for (int i = 0; i < in; ++i) {
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          acc[u] = fmaf(h[u][i << C.logT], w[u][i * ld], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u)
        if (dst[u] >= 0) C.sv[dst[u]] = tanhf(acc[u]);
    }
    __syncthreads();
  }
}

// Backward of one block's nets na and, if nb_ >= 0, nb_ (S1 and T1, or
// S2 and T2: the same widths and input) for the output cotangents ybar_a
// and ybar_b (rows, T), in the same phases: writes their O rows (biases,
// then row-major weights) and adds the input cotangents to ``xacc``
// (rows, T), na's then nb_'s. sc: four (SW, T) scratch rows, ab and xb per
// net.
template <bool SPLIT>
__device__ void bwd_nets(const Ctx& C, const Store<SPLIT>& out,
                         const int* blk, int na, int nb_, float alpha,
                         int in_sv, const float* ybar_a, const float* ybar_b,
                         float* xacc, float* sc, int SW) {
  const int nl = blk[3], nn = nb_ >= 0 ? 2 : 1;
  const int rows_T = SW << C.logT;
  // per net m: its net, and its ab and xb rows (swapped after each layer)
  auto net_of = [&](int m) { return m ? nb_ : na; };
  float *ab0 = sc, *xb0 = sc + rows_T;
  float *ab1 = sc + 2 * rows_T, *xb1 = sc + 3 * rows_T;
  const int w_last = layer(blk, na, nl - 1)[1] << C.logT;
  for (int it = threadIdx.x; it < nn * w_last; it += blockDim.x) {
    const int m = it >= w_last, j = it - m * w_last;
    const float t = C.sv[(layer(blk, net_of(m), nl - 1)[4] << C.logT) + j];
    (m ? ab1 : ab0)[j] = (m ? ybar_b : ybar_a)[j] * alpha * (1.f - t * t);
  }
  __syncthreads();
  for (int l = nl - 1; l >= 0; --l) {
    const int in = layer(blk, na, l)[0], outw = layer(blk, na, l)[1];
    // row q = i outw + o; (q + 1/2) / outw is never an integer, so its f32
    // quotient truncates to i for every q < 2^16 (larger layers divide)
    const float inv_out = 1.f / outw;
    const bool divide = in * outw >= (1 << 16);
    for (int m = 0; m < nn; ++m) {
      const int* r = layer(blk, net_of(m), l);
      const int hin = l ? layer(blk, net_of(m), l - 1)[4] : in_sv;
      const float* abm = m ? ab1 : ab0;
      out.rows(C, r[2], outw, [&](int o) {
        return RowSrc{abm + (o << C.logT), nullptr, 1.f, 0.f};
      });
      out.rows(C, r[3], in * outw, [&](int q) {
        const int i = divide ? q / outw : (int)((q + 0.5f) * inv_out);
        return RowSrc{C.sv + ((hin + i) << C.logT),
                      abm + ((q - i * outw) << C.logT), 1.f, 0.f};
      });
    }
    // input cotangents over (net, unit, sample) items; with one net the
    // first layer's add straight into xacc
    const int per = in << C.logT, items = nn * per;
    for (int base = threadIdx.x; base < items; base += ILP * blockDim.x) {
      const float* w[ILP];
      const float* a[ILP];
      float acc[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int it = min(base + u * blockDim.x, items - 1);
        const int m = it >= per, j = it - m * per;
        const int* r = layer(blk, net_of(m), l);
        w[u] = C.th + r[6] + (j >> C.logT) * r[7];
        a[u] = (m ? ab1 : ab0) + (j & (C.T - 1));
        acc[u] = 0.f;
      }
      for (int o = 0; o < outw; ++o) {
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          acc[u] = fmaf(w[u][o], a[u][o << C.logT], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int it = base + u * blockDim.x;
        if (it >= items) continue;
        const int m = it >= per, j = it - m * per;
        if (l) {
          const float t =
              C.sv[(layer(blk, net_of(m), l - 1)[4] << C.logT) + j];
          (m ? xb1 : xb0)[j] = acc[u] * (1.f - t * t);
        } else if (nn == 1) {
          xacc[j] += acc[u];
        } else {
          (m ? xb1 : xb0)[j] = acc[u];
        }
      }
    }
    __syncthreads();
    float* tmp = ab0;
    ab0 = xb0;
    xb0 = tmp;
    tmp = ab1;
    ab1 = xb1;
    xb1 = tmp;
  }
  if (nn == 2) {
    const int per = layer(blk, na, 0)[0] << C.logT;
    for (int it = threadIdx.x; it < per; it += blockDim.x)
      xacc[it] += ab0[it] + ab1[it];
    __syncthreads();
  }
}

// Backward of v = couple(u, s, t) for the cotangent vbar, including the
// log-Jacobian's d(sum s)/ds = 1 for the scaling variants.
__device__ __forceinline__ void couple_bwd(int variant, float vbar, float u,
                                           float s, float& sbar, float& tbar,
                                           float& ubar) {
  if (variant == ADDITIVE) {
    sbar = vbar;
    tbar = 0.f;
    ubar = vbar;
    return;
  }
  const float es = expf(s);
  ubar = vbar * es;
  tbar = vbar;
  sbar = variant == SCALE_SHIFT ? vbar * (u * es + 1.f) + 1.f
                                : vbar * u * es + 1.f;
}

// Jets of v = couple(u, s, t): u0/s0 primal, (u1, u2), (s1, s2), (t1, t2)
// first and second tangents. exp'' = exp (s'' + s'^2),
// (u e)'' = u'' e + 2 u' e' + u e''.
__device__ __forceinline__ void couple_jet(int variant, float u0, float u1,
                                           float u2, float s0, float s1,
                                           float s2, float t1, float t2,
                                           float& v1, float& v2) {
  if (variant == ADDITIVE) {
    v1 = u1 + s1;
    v2 = u2 + s2;
    return;
  }
  const float e = expf(s0);
  const float e1 = e * s1;
  const float e2 = e * (s2 + s1 * s1);
  v1 = u1 * e + u0 * e1;
  v2 = u2 * e + 2.f * u1 * e1 + u0 * e2;
  if (variant == AFFINE) {
    v1 += t1;
    v2 += t2;
  } else if (variant == SCALE_SHIFT) {
    v1 += s1;
    v2 += s2;
  }
}

// One pair's jet through a net at the register width MW: (h1, h2) the
// first and second tangents of the net's input on entry, of its last tanh
// layer's output on return (before alpha). Every layer is zero-padded to
// MW x MW in the repacked theta (persample.kernel_layout) and the inputs
// past ``in`` are zero, so the body is straight-line code over registers,
// each weight row read as 16-byte broadcast loads, the next row loaded
// while the current one is used; primal tanh values from the saves. Bias
// enters the primal only; tanh'' = -2 tanh (1 - tanh^2).
template <int MW>
__device__ __forceinline__ void jet_net(const Ctx& C, const int* blk, int net,
                                        int s, float (&h1)[MW],
                                        float (&h2)[MW]) {
  const int nl = blk[3];
  for (int l = 0; l < nl; ++l) {
    const int* r = layer(blk, net, l);
    const int out = r[1];
    const float* w = C.th + r[6];
    float p1[MW], p2[MW];
    constexpr int Q = MW / 4;
#pragma unroll
    for (int o = 0; o < MW; ++o) p1[o] = p2[o] = 0.f;
    float4 wn[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      wn[q] = *reinterpret_cast<const float4*>(w + 4 * q);
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      float4 wc[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) wc[q] = wn[q];
      if (i + 1 < MW) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          wn[q] = *reinterpret_cast<const float4*>(w + (i + 1) * MW + 4 * q);
      }
      const float a = h1[i], b = h2[i];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        p1[4 * q] = fmaf(a, wc[q].x, p1[4 * q]);
        p2[4 * q] = fmaf(b, wc[q].x, p2[4 * q]);
        p1[4 * q + 1] = fmaf(a, wc[q].y, p1[4 * q + 1]);
        p2[4 * q + 1] = fmaf(b, wc[q].y, p2[4 * q + 1]);
        p1[4 * q + 2] = fmaf(a, wc[q].z, p1[4 * q + 2]);
        p2[4 * q + 2] = fmaf(b, wc[q].z, p2[4 * q + 2]);
        p1[4 * q + 3] = fmaf(a, wc[q].w, p1[4 * q + 3]);
        p2[4 * q + 3] = fmaf(b, wc[q].w, p2[4 * q + 3]);
      }
    }
    const float* t = C.sv + (r[4] << C.logT) + s;
#pragma unroll
    for (int o = 0; o < MW; ++o) {
      if (o < out) {
        const float tv = t[o << C.logT];
        const float sd = 1.f - tv * tv;
        h1[o] = sd * p1[o];
        h2[o] = sd * p2[o] - 2.f * tv * sd * p1[o] * p1[o];
      } else {
        h1[o] = h2[o] = 0.f;
      }
    }
  }
}

// One pair's jet through a net in the chunked body, for any widths: each
// layer's outputs in chunks of REGISTER_WIDTH, accumulated in registers
// over the layer's input tangents, which it reads from the pair's rows --
// the first layer's from the tangents z', z'' at the half's coordinates
// ``in_idx``, a later layer's from the layer buffer the one before wrote
// (two buffers of (2 H, J) at B, H the widest hidden layer, in turn).
// Weight rows as 16-byte broadcast loads (each row padded to a multiple
// of 4, so a chunk's loads past it stay in the row's padding or are
// skipped). The last layer hands each output's tangents to
// ``emit(o, h1, h2)`` (before alpha).
template <class Emit>
__device__ __forceinline__ void jet_net_chunked(const Ctx& C, const int* blk,
                                                int net, int s,
                                                const int* in_idx, float* B,
                                                int H, Emit emit) {
  constexpr int RW = REGISTER_WIDTH, Q = RW / 4;
  const int nl = blk[3], J = C.J, slot = threadIdx.x;
  const float* Z1 = C.jz + slot;
  const float* Z2 = C.jz + C.meta[0] * J + slot;
  for (int l = 0; l < nl; ++l) {
    const int* r = layer(blk, net, l);
    const int in = r[0], out = r[1], ld = r[7];
    const float* w = C.th + r[6];
    const float* src = B + ((l - 1) & 1) * 2 * H * J + slot;
    float* dst = l + 1 < nl ? B + (l & 1) * 2 * H * J + slot : nullptr;
    const float* t = C.sv + (r[4] << C.logT) + s;
    for (int o0 = 0; o0 < out; o0 += RW) {
      float p1[RW], p2[RW];
#pragma unroll
      for (int o = 0; o < RW; ++o) p1[o] = p2[o] = 0.f;
      for (int i = 0; i < in; ++i) {
        float a, b;
        if (l) {
          a = src[i * J];
          b = src[(H + i) * J];
        } else {
          const int c = in_idx[i] * J;
          a = Z1[c];
          b = Z2[c];
        }
        const float* wr = w + i * ld + o0;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (o0 + 4 * q < ld) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * q);
            p1[4 * q] = fmaf(a, wv.x, p1[4 * q]);
            p2[4 * q] = fmaf(b, wv.x, p2[4 * q]);
            p1[4 * q + 1] = fmaf(a, wv.y, p1[4 * q + 1]);
            p2[4 * q + 1] = fmaf(b, wv.y, p2[4 * q + 1]);
            p1[4 * q + 2] = fmaf(a, wv.z, p1[4 * q + 2]);
            p2[4 * q + 2] = fmaf(b, wv.z, p2[4 * q + 2]);
            p1[4 * q + 3] = fmaf(a, wv.w, p1[4 * q + 3]);
            p2[4 * q + 3] = fmaf(b, wv.w, p2[4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < RW; ++o) {
        if (o0 + o < out) {
          const float tv = t[(o0 + o) << C.logT];
          const float sd = 1.f - tv * tv;
          const float g1 = sd * p1[o];
          const float g2 = sd * p2[o] - 2.f * tv * sd * p1[o] * p1[o];
          if (dst) {
            dst[(o0 + o) * J] = g1;
            dst[(H + o0 + o) * J] = g2;
          } else {
            emit(o0 + o, g1, g2);
          }
        }
      }
    }
  }
}

// The Hessian quadratic trace: per direction v, the second derivative of
// t -> logp(x + t v) by second-order jets (x' = v, x'' = 0), one (sample,
// direction) pair per thread and jet slot. Per block, at the register
// width, four net passes -- t2 and s2 from the down half's tangents, then
// t1 and s1 from the new up half's -- through one jet_net call site; in the
// chunked body per half the s net's coupling and then the t net's shift
// added in place (the t net reads the other half, which neither changes).
template <int MW>
__device__ void jets(const Ctx& C, float* __restrict__ quad_out) {
  constexpr int NW = MW ? MW : 1;
  const int* meta = C.meta;
  const int d = meta[0], nb = meta[1], k_dirs = meta[2], H = meta[10];
  const int J = C.J;
  const bool student = meta[8] != 0;
  const int logT = C.logT, T = C.T;
  const int d8 = (d + 7) & ~7;
  const float* WT = C.fc;
  const float* dirs = WT + d * d8 + d;
  const float* alphas = dirs + k_dirs * d;
  const float nu = student ? alphas[nb] : 0.f;
  const float scale = meta[17] >= 0 ? C.th[meta[17]] : 1.f;
  const float* qv = C.ps + T;
  float* Z1 = C.jz;
  float* Z2 = C.jz + d * J;
  float* B = C.jz + 2 * d * J;
  const int slot = threadIdx.x;
  const int pairs = k_dirs << logT;
  for (int p0 = 0; p0 < pairs; p0 += J) {
    const int p = p0 + slot;
    if (slot < J && p < pairs) {
      const int s = p & (T - 1), j = p >> logT;
      for (int c = 0; c < d; ++c) {
        Z1[c * J + slot] = scale * dirs[j * d + c];
        Z2[c * J + slot] = 0.f;
      }
      float lj2 = 0.f;
      for (int b = 0; b < nb; ++b) {
        const int* blk = meta + meta[HDR + b];
        const int variant = blk[0], n_up = blk[1], n_down = blk[2],
                  nl = blk[3];
        const int* up = up_half(blk);
        const int* down = up + n_up;
        const float alpha = alphas[b];
        if constexpr (MW > 0) {
          float h1[NW], h2[NW], t1[NW], t2[NW];
          // pass 0: t2(u2), 1: s2(u2) -> v1, 2: t1(v1), 3: s1(v1) -> v2
          for (int pass = variant == AFFINE ? 0 : 1; pass < 4;
               pass += variant == AFFINE ? 1 : 2) {
            const bool first = pass < 2, tnet = !(pass & 1);
            const int* in_idx = first ? down : up;
            const int n_in = first ? n_down : n_up;
            const int* out_idx = first ? up : down;
            const int n_out = first ? n_up : n_down;
#pragma unroll
            for (int i = 0; i < MW; ++i) {
              if (i < n_in) {
                h1[i] = Z1[in_idx[i] * J + slot];
                h2[i] = Z2[in_idx[i] * J + slot];
              } else {
                h1[i] = h2[i] = 0.f;
              }
            }
            jet_net<MW>(C, blk, pass == 0 ? T2 : pass == 1 ? S2
                                : pass == 2 ? T1 : S1,
                        s, h1, h2);
            if (tnet) {
#pragma unroll
              for (int i = 0; i < MW; ++i) {
                t1[i] = h1[i];
                t2[i] = h2[i];
              }
              continue;
            }
            if (variant != AFFINE) {
#pragma unroll
              for (int i = 0; i < MW; ++i) t1[i] = t2[i] = 0.f;
            }
            // the half's jets: v = couple(u, s(.), t(.)) with u's primal
            // from the saves and its tangents in place
            const float* u0 = C.sv + (blk[first ? 4 : 5] << logT) + s;
            const float* s0 =
                C.sv + (layer(blk, first ? S2 : S1, nl - 1)[4] << logT) + s;
#pragma unroll
            for (int i = 0; i < MW; ++i) {
              if (i < n_out) {
                const int c = out_idx[i] * J + slot;
                float w1, w2;
                couple_jet(variant, u0[i << logT], Z1[c], Z2[c],
                           alpha * s0[i << logT], alpha * h1[i],
                           alpha * h2[i], alpha * t1[i], alpha * t2[i], w1,
                           w2);
                Z1[c] = w1;
                Z2[c] = w2;
                if (variant != ADDITIVE) lj2 += alpha * h2[i];
              }
            }
          }
        } else {
          for (int half = 0; half < 2; ++half) {
            const bool first = half == 0;
            const int* in_idx = first ? down : up;
            const int* out_idx = first ? up : down;
            const float* u0 = C.sv + (blk[first ? 4 : 5] << logT) + s;
            const float* s0 =
                C.sv + (layer(blk, first ? S2 : S1, nl - 1)[4] << logT) + s;
            jet_net_chunked(
                C, blk, first ? S2 : S1, s, in_idx, B, H,
                [&](int o, float a1, float a2) {
                  const int c = out_idx[o] * J + slot;
                  float w1, w2;
                  couple_jet(variant, u0[o << logT], Z1[c], Z2[c],
                             alpha * s0[o << logT], alpha * a1, alpha * a2,
                             0.f, 0.f, w1, w2);
                  Z1[c] = w1;
                  Z2[c] = w2;
                  if (variant != ADDITIVE) lj2 += alpha * a2;
                });
            if (variant == AFFINE)
              jet_net_chunked(C, blk, first ? T2 : T1, s, in_idx, B, H,
                              [&](int o, float a1, float a2) {
                                const int c = out_idx[o] * J + slot;
                                Z1[c] += alpha * a1;
                                Z2[c] += alpha * a2;
                              });
          }
        }
        if (blk[7]) {
          const float g = C.th[blk[10]];
          for (int c = 0; c < d; ++c) {
            Z1[c * J + slot] *= g;
            Z2[c * J + slot] *= g;
          }
        }
      }
      // with y' = W z', y'' = W z'': q' = 2 q1, q'' = 2 q2, q1 = z'.W^T y,
      // q2 = |W z'|^2 + z''.W^T y. Gauss: logp'' = -q''/2 + logjac''.
      // Student-t: logp = f(q) + ..., f' = -h1, f'' = h1 / (nu (1 +
      // q/nu)), h1 = (nu+d) / (2 nu (1 + q/nu))
      float q1 = 0.f, q2 = 0.f;
      for (int c = 0; c < d; ++c) {
        const float wyc = C.wy[(c << logT) + s];
        q1 = fmaf(Z1[c * J + slot], wyc, q1);
        q2 = fmaf(Z2[c * J + slot], wyc, q2);
      }
      // W is upper triangular: (W z')_i sums over c >= i
      for (int i0 = 0; i0 < d; i0 += 8) {
        float pw[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) pw[m] = 0.f;
        for (int c = i0; c < d; ++c) {
          const float zc = Z1[c * J + slot];
          const float4 wa =
              *reinterpret_cast<const float4*>(WT + c * d8 + i0);
          const float4 wb =
              *reinterpret_cast<const float4*>(WT + c * d8 + i0 + 4);
          pw[0] = fmaf(wa.x, zc, pw[0]);
          pw[1] = fmaf(wa.y, zc, pw[1]);
          pw[2] = fmaf(wa.z, zc, pw[2]);
          pw[3] = fmaf(wa.w, zc, pw[3]);
          pw[4] = fmaf(wb.x, zc, pw[4]);
          pw[5] = fmaf(wb.y, zc, pw[5]);
          pw[6] = fmaf(wb.z, zc, pw[6]);
          pw[7] = fmaf(wb.w, zc, pw[7]);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) q2 = fmaf(pw[m], pw[m], q2);
      }
      float quad;
      if (student) {
        const float onepu = 1.f + qv[s] / nu;
        const float hh1 = 0.5f * (nu + d) / nu / onepu;
        const float hh2 = hh1 / nu / onepu;
        quad = lj2 - (hh1 * 2.f * q2 - hh2 * 4.f * q1 * q1);
      } else {
        quad = lj2 - q2;
      }
      C.qb[p] = quad;
    }
  }
  __syncthreads();
  if (threadIdx.x < C.nv) {
    const int s = threadIdx.x;
    float quad = 0.f;
    for (int j = 0; j < k_dirs; ++j) quad += C.qb[(j << logT) + s];
    quad_out[C.n0 + s] = quad;
  }
}

// out[i][s] = sum_j WT[i * si + j * sj] in[j][s] over the tile's (d, T)
// rows (WT = W^T with rows of d8: si = 1, sj = d8 applies W; si = d8,
// sj = 1 applies W^T), ILP items per thread.
__device__ void latent_product(const Ctx& C, const float* WT, int si, int sj,
                               const float* in, float* out) {
  const int d = C.meta[0], items = d << C.logT;
  for (int base = threadIdx.x; base < items; base += ILP * blockDim.x) {
    const float* w[ILP];
    const float* x[ILP];
    float acc[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int it = min(base + u * blockDim.x, items - 1);
      w[u] = WT + (it >> C.logT) * si;
      x[u] = in + (it & (C.T - 1));
      acc[u] = 0.f;
    }
    for (int j = 0; j < d; ++j) {
#pragma unroll
      for (int u = 0; u < ILP; ++u)
        acc[u] = fmaf(w[u][j * sj], x[u][j << C.logT], acc[u]);
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u)
      if (base + u * blockDim.x < items) out[base + u * blockDim.x] = acc[u];
  }
}

// One tile of the kernel: its samples' forward, latent, backward with the
// O rows and g, and the jets, in phases between barriers.
template <bool SPLIT, bool DUMP, int MW>
__device__ __forceinline__ void run_tile(
    Ctx& C, const float* __restrict__ x, float* __restrict__ logp_out,
    float* __restrict__ g_out, float* __restrict__ quad_out,
    const Store<SPLIT>& out, float* __restrict__ saves_out) {
  const int* meta = C.meta;
  const int d = meta[0], nb = meta[1], k_dirs = meta[2];
  const int n_sv = meta[7], SW = meta[14];
  const int logT = C.logT, T = C.T;
  const int off_L = meta[4], off_ld = meta[5], off_mu = meta[6];
  const bool student = meta[8] != 0;
  const int off_dp = meta[9], mu_k = meta[12], ld_k = meta[13];
  // SanityFlow's learned scale z = s x (1 for a flow without one)
  const int scale_k = meta[17];
  const float scale = scale_k >= 0 ? C.th[scale_k] : 1.f;
  const int d8 = (d + 7) & ~7;
  const float* WT = C.fc;  // W^T: WT[j * d8 + i] = W[i, j]
  const float* offset = WT + d * d8;
  const float* dirs = offset + d;
  const float* alphas = dirs + k_dirs * d;
  // Student-t: nu, c0, dg (computed from theta by the wrapper)
  const float nu = student ? alphas[nb] : 0.f;
  float* lj = C.ps;          // logjac
  float* qv = C.ps + T;      // q = |y|^2
  float* stv = C.ps + 2 * T; // s = (nu+d)/(nu+q) (1 for Gauss)
  float* l1v = C.ps + 3 * T; // log1p(q/nu)
  float* rowv = C.ps + 4 * T;  // one per-sample O row (nu, g_scale, scale)

  // the tile's samples; lanes past N run the last sample and store nothing
  for (int it = threadIdx.x; it < d * T; it += blockDim.x) {
    const int s = it / d, i = it - s * d;
    const int n = C.n0 + min(s, C.nv - 1);
    C.z[(i << logT) + s] = scale * x[(size_t)n * d + i];
  }
  if (threadIdx.x < T) lj[threadIdx.x] = scale_k >= 0 ? d * logf(scale) : 0.f;
  __syncthreads();

  // ---- forward: real -> latent, saving what the backward and jets reuse
  for (int b = 0; b < nb; ++b) {
    const int* blk = meta + meta[HDR + b];
    const int variant = blk[0], n_up = blk[1], n_down = blk[2], nl = blk[3];
    const int* up = up_half(blk);
    const int* down = up + n_up;
    const float alpha = alphas[b];
    for (int it = threadIdx.x; it < ((n_up + n_down) << logT);
         it += blockDim.x) {
      const int s = it & (T - 1), i = it >> logT;
      if (i < n_up)
        C.sv[((blk[4] + i) << logT) + s] = C.z[(up[i] << logT) + s];
      else
        C.sv[((blk[5] + i - n_up) << logT) + s] =
            C.z[(down[i - n_up] << logT) + s];
    }
    __syncthreads();
    const bool aff = variant == AFFINE;
    fwd_nets(C, blk, S2, aff ? T2 : -1, blk[5]);
    // v1 = couple(u1, s2(u2), t2(u2)) over (unit, sample) items; the
    // log-Jacobian's sum over the units one lane per sample, in order
    const float* s2v = C.sv + (layer(blk, S2, nl - 1)[4] << logT);
    const float* t2v = C.sv + (layer(blk, T2, nl - 1)[4] << logT);
    for (int it = threadIdx.x; it < (n_up << logT); it += blockDim.x) {
      const int s = it & (T - 1), i = it >> logT;
      const float v1 =
          couple_fwd(variant, C.sv[(blk[4] << logT) + it], alpha * s2v[it],
                     aff ? alpha * t2v[it] : 0.f);
      C.sv[(blk[6] << logT) + it] = v1;
      C.z[(up[i] << logT) + s] = v1;
    }
    if (threadIdx.x < T && variant != ADDITIVE) {
      float acc = lj[threadIdx.x];
      for (int i = 0; i < n_up; ++i)
        acc += alpha * s2v[(i << logT) + threadIdx.x];
      lj[threadIdx.x] = acc;
    }
    __syncthreads();
    fwd_nets(C, blk, S1, aff ? T1 : -1, blk[6]);
    const float* s1v = C.sv + (layer(blk, S1, nl - 1)[4] << logT);
    const float* t1v = C.sv + (layer(blk, T1, nl - 1)[4] << logT);
    for (int it = threadIdx.x; it < (n_down << logT); it += blockDim.x) {
      const int s = it & (T - 1), i = it >> logT;
      C.z[(down[i] << logT) + s] =
          couple_fwd(variant, C.sv[(blk[5] << logT) + it], alpha * s1v[it],
                     aff ? alpha * t1v[it] : 0.f);
    }
    if (threadIdx.x < T && variant != ADDITIVE) {
      float acc = lj[threadIdx.x];
      for (int i = 0; i < n_down; ++i)
        acc += alpha * s1v[(i << logT) + threadIdx.x];
      lj[threadIdx.x] = acc;
    }
    __syncthreads();
    if (blk[7]) {  // global affine
      const float g = C.th[blk[10]];
      const float* g_off = C.th + blk[11];
      for (int it = threadIdx.x; it < (d << logT); it += blockDim.x)
        C.z[it] = fmaf(g, C.z[it], g_off[it >> logT]);
      if (threadIdx.x < T) lj[threadIdx.x] += d * logf(g);
      __syncthreads();
    }
  }
  if (DUMP) {
    for (int it = threadIdx.x; it < (n_sv << logT); it += blockDim.x) {
      const int s = it & (T - 1), k = it >> logT;
      if (s < C.nv) saves_out[(size_t)k * C.N + C.n0 + s] = C.sv[it];
    }
  }

  // ---- latent: y = W (z - offset - mu), q = |y|^2
  // z - offset - mu in place (the forward is done with z)
  for (int it = threadIdx.x; it < (d << logT); it += blockDim.x) {
    const int i = it >> logT;
    C.z[it] -= offset[i] + C.th[mu_k + i];
  }
  __syncthreads();
  latent_product(C, WT, 1, d8, C.z, C.y);  // y_i = sum_j W[i, j] u_j
  __syncthreads();
  if (threadIdx.x < T) {
    const int s = threadIdx.x;
    float q = 0.f, sum_ld = 0.f;
    for (int i = 0; i < d; ++i) {
      const float yv = C.y[(i << logT) + s];
      q = fmaf(yv, yv, q);
      sum_ld += C.th[ld_k + i];
    }
    // Student-t: dlogp/dq = -s/2 with s = (nu+d)/(nu+q) (Gauss: s = 1)
    const float l1q = student ? log1pf(q / nu) : 0.f;
    const float s_t = student ? (nu + d) / (nu + q) : 1.f;
    qv[s] = q;
    stv[s] = s_t;
    l1v[s] = l1q;
    if (s < C.nv)
      logp_out[C.n0 + s] =
          student ? alphas[nb + 1] - sum_ld - 0.5f * (nu + d) * l1q + lj[s]
                  : -0.5f * (d * 1.8378770664093453f + 2.f * sum_ld + q) +
                        lj[s];
    if (student)
      rowv[s] = (nu - 1.f) * (alphas[nb + 2] - 0.5f * l1q +
                              s_t * q / (2.f * nu));
  }
  __syncthreads();
  // W^T y, its s-scaled copy, and zbar = -s W^T y
  latent_product(C, WT, d8, 1, C.y, C.wy);  // (W^T y)_i
  __syncthreads();
  for (int it = threadIdx.x; it < (d << logT); it += blockDim.x) {
    const float v = C.wy[it] * stv[it & (T - 1)];
    C.swy[it] = v;
    C.zb[it] = -v;
  }
  __syncthreads();

  // ---- backward. Latent (Gauss; Student-t scales each q-derived term by
  // s): dlogp/dU[i,j] = (W^T y)_i y_j, dlogp/dL_diag_i =
  // (W^T y)_i y_i exp(L_diag_i) - 1, dlogp/dmu = W^T y, dlogp/dz = -W^T y.
  out.rows(C, off_mu, d, [&](int i) {
    return RowSrc{C.swy + (i << logT), nullptr, 1.f, 0.f};
  });
  out.rows(C, off_ld, d, [&](int i) {
    return RowSrc{C.swy + (i << logT), C.y + (i << logT),
                  expf(C.th[ld_k + i]), -1.f};
  });
  // strictly-upper entries in row-major (triu) order: row i holds d - 1 - i
  // of them, from start(i) = i (2 d - 1 - i) / 2 on
  out.rows(C, off_L, d * (d - 1) / 2, [&](int q) {
    const float b2 = 2.f * d - 1.f;
    int i = (int)(0.5f * (b2 - sqrtf(fmaxf(b2 * b2 - 8.f * q, 0.f))));
    i = max(0, min(i, d - 2));
    while (i > 0 && i * (2 * d - 1 - i) / 2 > q) --i;
    while ((i + 1) * (2 * d - 2 - i) / 2 <= q) ++i;
    const int c = i + 1 + q - i * (2 * d - 1 - i) / 2;
    return RowSrc{C.swy + (i << logT), C.y + (c << logT), 1.f, 0.f};
  });
  if (student)
    out.rows(C, off_dp, 1,
             [&](int) { return RowSrc{rowv, nullptr, 1.f, 0.f}; });
  __syncthreads();

  // scratch rows: four for bwd_nets, then the couplings' cotangents
  float* SB = C.sc + 4 * (SW << logT);
  float* TB = C.sc + 5 * (SW << logT);
  float* UB = C.sc + 6 * (SW << logT);
  float* V1B = C.sc + 7 * (SW << logT);
  for (int b = nb - 1; b >= 0; --b) {
    const int* blk = meta + meta[HDR + b];
    const int variant = blk[0], n_up = blk[1], n_down = blk[2], nl = blk[3];
    const int* up = up_half(blk);
    const int* down = up + n_up;
    const float alpha = alphas[b];
    const int* sl1 = layer(blk, S1, nl - 1);
    const int* tl1 = layer(blk, T1, nl - 1);
    const int* sl2 = layer(blk, S2, nl - 1);
    if (blk[7]) {
      // global affine z = g ym + g_offset: g row sum(ym zbar) + d/g,
      // g_offset rows zbar, then ym's cotangent g zbar. ym's down half is
      // recomputed from the saves as the forward made it
      const float g = C.th[blk[10]];
      if (threadIdx.x < T) {
        const int s = threadIdx.x;
        float acc = 0.f;
        for (int i = 0; i < n_up; ++i)
          acc = fmaf(C.sv[((blk[6] + i) << logT) + s],
                     C.zb[(up[i] << logT) + s], acc);
        for (int i = 0; i < n_down; ++i) {
          const float sv = alpha * C.sv[((sl1[4] + i) << logT) + s];
          const float tv =
              variant == AFFINE ? alpha * C.sv[((tl1[4] + i) << logT) + s]
                                : 0.f;
          acc = fmaf(couple_fwd(variant, C.sv[((blk[5] + i) << logT) + s],
                                sv, tv),
                     C.zb[(down[i] << logT) + s], acc);
        }
        rowv[s] = acc + d / g;
      }
      __syncthreads();
      out.rows(C, blk[8], 1,
               [&](int) { return RowSrc{rowv, nullptr, 1.f, 0.f}; });
      out.rows(C, blk[9], d, [&](int i) {
        return RowSrc{C.zb + (i << logT), nullptr, 1.f, 0.f};
      });
      __syncthreads();
      for (int it = threadIdx.x; it < (d << logT); it += blockDim.x)
        C.zb[it] *= g;
      __syncthreads();
    }
    // v2 = couple(u2, s1(v1), t1(v1))
    for (int it = threadIdx.x; it < ((n_up + n_down) << logT);
         it += blockDim.x) {
      const int s = it & (T - 1), i = it >> logT;
      if (i < n_up) {
        V1B[it] = C.zb[(up[i] << logT) + s];
        continue;
      }
      const int j = i - n_up, js = (j << logT) + s;
      couple_bwd(variant, C.zb[(down[j] << logT) + s],
                 C.sv[((blk[5] + j) << logT) + s],
                 alpha * C.sv[((sl1[4] + j) << logT) + s], SB[js], TB[js],
                 UB[js]);
    }
    __syncthreads();
    const bool aff = variant == AFFINE;
    bwd_nets(C, out, blk, S1, aff ? T1 : -1, alpha, blk[6], SB, TB, V1B,
             C.sc, SW);
    // v1 = couple(u1, s2(u2), t2(u2)); its u1 cotangent is zbar[up]
    for (int it = threadIdx.x; it < (n_up << logT); it += blockDim.x) {
      const int s = it & (T - 1), i = it >> logT;
      couple_bwd(variant, V1B[it], C.sv[((blk[4] + i) << logT) + s],
                 alpha * C.sv[((sl2[4] + i) << logT) + s], SB[it], TB[it],
                 C.zb[(up[i] << logT) + s]);
    }
    __syncthreads();
    bwd_nets(C, out, blk, S2, aff ? T2 : -1, alpha, blk[5], SB, TB, UB,
             C.sc, SW);
    for (int it = threadIdx.x; it < (n_down << logT); it += blockDim.x) {
      const int s = it & (T - 1), i = it >> logT;
      C.zb[(down[i] << logT) + s] = UB[it];
    }
    __syncthreads();
  }
  if (scale_k >= 0) {
    // SanityFlow's z = s x: the s row sum(x zbar) + d/s, then s zbar
    if (threadIdx.x < T) {
      const int s = threadIdx.x;
      const float* xs = x + (size_t)(C.n0 + min(s, C.nv - 1)) * d;
      float acc = 0.f;
      for (int i = 0; i < d; ++i)
        acc = fmaf(xs[i], C.zb[(i << logT) + s], acc);
      rowv[s] = acc + d / scale;
    }
    __syncthreads();
    out.rows(C, meta[16], 1,
             [&](int) { return RowSrc{rowv, nullptr, 1.f, 0.f}; });
    for (int it = threadIdx.x; it < (d << logT); it += blockDim.x)
      C.zb[it] *= scale;
    __syncthreads();
  }
  for (int it = threadIdx.x; it < (d << logT); it += blockDim.x) {
    const int s = it & (T - 1), i = it >> logT;
    if (s < C.nv) g_out[(size_t)i * C.N + C.n0 + s] = C.zb[it];
  }

  // ---- Hessian quadratic trace (its tangents reuse the backward's rows)
  if (k_dirs == 0) return;
  __syncthreads();
  jets<MW>(C, quad_out);
}

// The kernel: the block's regions (block_layout, with the plan's
// ``where``; the register-width kernel has every region in shared memory
// and reads them through pointers the compiler knows are shared), then
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... in order.
template <bool SPLIT, bool DUMP, int MW>
__global__ void __launch_bounds__(MAX_THREADS, 1) persample_kernel(
    const float* __restrict__ x, const float* __restrict__ theta_k,
    const float* __restrict__ fconst, const int* __restrict__ meta_g, int N,
    int n_fconst, int n_meta, int T, int J, int where_arg,
    float* __restrict__ ws, float* __restrict__ logp_out,
    float* __restrict__ g_out, float* __restrict__ quad_out,
    Store<SPLIT> out, float* __restrict__ saves_out, int n_tiles) {
  const int where = MW > 0 ? ALL : where_arg;
  const int d = meta_g[0], k_dirs = meta_g[2];
  const int P = meta_g[3], n_sv = meta_g[7], Pk = meta_g[11];
  const Layout L = block_layout(Pk, n_fconst, n_meta, n_sv, d, k_dirs, T, J,
                                meta_g[14], MW > 0 ? 0 : meta_g[15], where);
  if (where & TH) {
    // Pk is a multiple of 4 (kernel_layout pads it), L.th is 0
    const float4* src = reinterpret_cast<const float4*>(theta_k);
    float4* dst = reinterpret_cast<float4*>(smem + L.th);
#pragma unroll 4
    for (int i = threadIdx.x; i < Pk / 4; i += blockDim.x)
      dst[i] = __ldg(src + i);
  }
  if (where & FC)
    for (int i = threadIdx.x; i < n_fconst; i += blockDim.x)
      smem[L.fc + i] = fconst[i];
  int* meta = reinterpret_cast<int*>(smem + L.meta);
  for (int i = threadIdx.x; i < n_meta; i += blockDim.x) meta[i] = meta_g[i];

  float* wsb = L.ws ? ws + (size_t)blockIdx.x * L.ws : nullptr;
  float* tile = where & TILE ? smem + L.tile : wsb + L.tile;
  float* work = where & WORK ? smem + L.work : wsb + L.work;
  Ctx C;
  C.th = where & TH ? smem + L.th : theta_k;
  C.fc = where & FC ? smem + L.fc : fconst;
  C.meta = meta;
  C.sv = tile;
  C.wy = tile + n_sv * T;
  C.qb = C.wy + d * T;
  C.z = work;
  C.zb = work + d * T;
  C.y = work + 2 * d * T;
  C.swy = work + 3 * d * T;
  C.sc = work + 4 * d * T;
  C.jz = work;
  C.ps = smem + L.ps;
  C.T = T;
  C.logT = 31 - __clz(T);
  C.J = J;
  C.N = N;
  C.P = P;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // the loads above, or the previous tile's last reads, are done
    __syncthreads();
    C.first = t == (int)blockIdx.x;
    C.n0 = t * T;
    C.nv = min(T, N - C.n0);
    run_tile<SPLIT, DUMP, MW>(C, x, logp_out, g_out, quad_out, out,
                              saves_out);
  }
}

// Column sums and max of the split mode from the (n_parts, P) per-block
// partials: one thread per row p, the blocks summed in index order, so the
// result does not depend on the order in which blocks ran.
__global__ void split_finish(const float* __restrict__ psum,
                             const float* __restrict__ pmax, int n_parts,
                             int P, float* __restrict__ colsum,
                             float* __restrict__ colmax) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f, m = 0.f;
  for (int w = 0; w < n_parts; ++w) {
    s += psum[(size_t)w * P + p];
    m = fmaxf(m, pmax[(size_t)w * P + p]);
  }
  colsum[p] = s;
  colmax[p] = m;
}

// The launch's shape, as persample.tile_plan gives it.
struct Shape {
  int N, n_fconst, n_meta, T, threads, J, mw, where, smem, ws, grid;
};

template <bool SPLIT, bool DUMP, int MW>
int launch_mw(const float* x, const float* theta_k, const float* fconst,
              const int* meta, const Shape& S, float* ws, float* logp,
              float* g, float* quad, const Store<SPLIT>& out, float* saves,
              cudaStream_t stream) {
  auto kern = persample_kernel<SPLIT, DUMP, MW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<S.grid, S.threads, S.smem, stream>>>(
      x, theta_k, fconst, meta, S.N, S.n_fconst, S.n_meta, S.T, S.J, S.where,
      ws, logp, g, quad, out, saves, (S.N + S.T - 1) / S.T);
  return (int)cudaGetLastError();
}

// Checks the launch shape against the layout (the wrapper's shared bytes
// and workspace floats must be this file's) and dispatches on the register
// width MW.
template <bool SPLIT, bool DUMP>
int launch(const float* x, const float* theta_k, const float* fconst,
           const int* meta, const int* hdr, const Shape& S, float* ws,
           float* logp, float* g, float* quad, const Store<SPLIT>& out,
           float* saves, cudaStream_t stream) {
  const int T = S.T, k = hdr[2];
  const Layout L = block_layout(hdr[11], S.n_fconst, S.n_meta, hdr[7],
                                hdr[0], k, T, S.J, hdr[14],
                                S.mw ? 0 : hdr[15], S.where);
  if ((T != 8 && T != 16 && T != 32) || S.threads % 32 || S.threads < T ||
      S.threads > MAX_THREADS || S.J > S.threads || (k && S.J < 1) ||
      S.where < 0 || S.where > ALL || (S.mw && S.where != ALL) ||
      S.smem != (int)(sizeof(float) * L.shared) || S.ws != L.ws ||
      (L.ws && !ws) || S.grid < 1 || S.grid > (S.N + T - 1) / T)
    return (int)cudaErrorInvalidValue;
  switch (S.mw) {
    case 16:
      return launch_mw<SPLIT, DUMP, 16>(x, theta_k, fconst, meta, S, ws,
                                        logp, g, quad, out, saves, stream);
    case 0:
      return launch_mw<SPLIT, DUMP, 0>(x, theta_k, fconst, meta, S, ws,
                                       logp, g, quad, out, saves, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points: launch on ``stream`` and return cudaGetLastError() (0 on
// success). x (N, d) row-major; theta_k the repacked theta
// (persample.kernel_layout); fconst = [W^T (d rows of d8), offset (d), dirs
// (k*d), alphas (n_blocks), and for Student-t nu, c0, dg]; meta the block
// plan, on the device, and hdr its first HDR entries on the host. The tile
// T, threads per block, jet slots J, register width mw, the regions in
// shared memory (where), the block's shared bytes, its workspace floats
// and the grid come from persample.tile_plan; ws: grid x ws floats (null
// when ws is 0). Outputs: logp (N,), g (d, N), quad (N,) (may be null when
// the plan has no directions), and O (P, N) f32 -- or, split, O_hi and
// O_lo (P, N) bf16 of O - shift, colsum and colmax (P,), with the scratch
// psum and pmax (grid, P). saves: null, or an (n_saves, N) buffer that
// receives the forward saves.
extern "C" int persample_f32(const float* x, const float* theta_k,
                             const float* fconst, const int* meta,
                             const int* hdr, int N, int n_fconst, int n_meta,
                             int tile, int threads, int jet_slots, int mw,
                             int where, int smem_bytes, int ws_floats,
                             int grid, float* ws, float* logp, float* g,
                             float* quad, float* O, float* saves,
                             void* stream) {
  const Shape S{N, n_fconst, n_meta, tile, threads, jet_slots, mw, where,
                smem_bytes, ws_floats, grid};
  const Store<false> out{O, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (saves)
    return launch<false, true>(x, theta_k, fconst, meta, hdr, S, ws, logp,
                               g, quad, out, saves, (cudaStream_t)stream);
  return launch<false, false>(x, theta_k, fconst, meta, hdr, S, ws, logp, g,
                              quad, out, nullptr, (cudaStream_t)stream);
}

extern "C" int persample_split_f32(
    const float* x, const float* theta_k, const float* fconst,
    const int* meta, const int* hdr, int N, int n_fconst, int n_meta,
    int tile, int threads, int jet_slots, int mw, int where, int smem_bytes,
    int ws_floats, int grid, float* ws, const float* shift, float* logp,
    float* g, float* quad, void* O_hi, void* O_lo, float* colsum,
    float* colmax, float* psum, float* pmax, void* stream) {
  const Shape S{N, n_fconst, n_meta, tile, threads, jet_slots, mw, where,
                smem_bytes, ws_floats, grid};
  const Store<true> out{nullptr, (__nv_bfloat16*)O_hi, (__nv_bfloat16*)O_lo,
                        shift, psum, pmax};
  const int err = launch<true, false>(x, theta_k, fconst, meta, hdr, S, ws,
                                      logp, g, quad, out, nullptr,
                                      (cudaStream_t)stream);
  if (err != 0) return err;
  split_finish<<<(hdr[3] + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      psum, pmax, grid, hdr[3], colsum, colmax);
  return (int)cudaGetLastError();
}
