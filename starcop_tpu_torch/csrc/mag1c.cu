// Hand-written Hopper (sm_90a) kernels of the matched filter.
//
// Replaces the Pallas kernels of two routes of starcop_tpu/ops/mag1c_pallas.py.
//
// The unmasked direct-swh route (acrwl1mf_resident_swh, :1413):
//
//   init_stats  <- _init_stats_swh_kernel (:1332): per column block the mean
//                  m0 and the centred covariance C0 = xc^T xc / n at f32.
//   filter_round, filter_glue
//               <- _resident_swh_kernel (:1361) = _resident_filter_body
//                  (:1103) + the in-kernel Woodbury glue _glue_math (:776).
//
// The masked route, every served granule (acrwl1mf_fused(glue="fused") with
// a weight row, built by _make_round_calls :1543):
//
//   filter_round_masked (FIRST)      <- _first_round_kernel (:594)
//   filter_round_masked (LOOP/FINAL) <- _loop_round_kernel (:664)
//   filter_glue (n per block)        <- their last-tile _glue_body (:539)
//   init_stats_masked                <- the XLA einsum of the weighted
//                                       statistics (:1790-1824); a kernel here
//                                       for the f32 conditioning of C0.
//
// The masked kernels are the unmasked ones instantiated with MASKED = true:
// they take the (H, W) uint8 valid mask and the scene width W, which need
// not be a multiple of step. A pixel counts only if its column b*step + j is
// < W (tested before any load: the ragged last block would otherwise read
// past the cube) and its mask byte is set. Other pixels contribute xc = 0 by
// a select, never a multiply (the sensor fill -9999 and NaN must not reach a
// sum), and come out with mf = 0 and R = 1. They are never read back from
// the carry rows either, so a block with no valid pixel (whose Woodbury base
// is NaN) stays inert. JAX pre-centres a masked copy of the cube on HBM
// (:1796-1798); here the raw cube is read in place and centred in registers.
//
// The TPU kernel keeps a whole 1280x54x50 f32 column block (13.8 MB) resident
// in VMEM across all iterations. An SM has 228 KB of shared memory, so here
// the cube is streamed once per pass instead: one filter_round launch per
// pass over the whole cube (grid: pixel chunks x column blocks), each CTA
// writing per-chunk partial sums, and one filter_glue launch (one CTA per
// block) that reduces the partials in a fixed order and runs the rank-2
// Woodbury update. Every pass reads the cube once, so every launch is bound
// by HBM bytes (4*H*W*S per pass, plus the 1-byte mask when masked); the
// arithmetic is a few FMAs per byte.
//
// Layout: the cube is the (H, W, S) float32 scene as it is uploaded. Pixel
// p = h*step + j of column block b lies at ((h*W + b*step + j)*S); the
// per-pixel outputs mf and R are (nb, P) rows in that order, P = H*step
// (the ragged block's columns past W included, at mf = 0 and R = 1).
//
// Numerics: float32 values and FMAs on the cube, no TF32 and no tensor cores.
// No float atomics: each CTA owns fixed pixels and every reduction runs in a
// fixed order, so a rerun is bitwise identical. Cross-chunk reductions and
// the glue's dot products accumulate in f64.
//
// Interface: plain C functions taking raw pointers and the caller's stream;
// bindings.cpp registers them as torch ops. Each returns the cudaError_t of
// its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;       // pixels per shared-memory tile in init_stats (one warp)
constexpr float kEpsilon = 1e-9f;
constexpr float kScaling = 1e5f;

enum RoundMode { kFirst = 0, kLoop = 1, kFinal = 2 };

struct Pixel {
  long long off;  // float offset of band 0 in the cube
  bool ok;        // counts in the statistics (always true unmasked)
};

// Pixel p of block b. Masked: the column test comes first, so neither the
// mask nor the cube is read for a column past W.
template <bool MASKED>
__device__ __forceinline__ Pixel locate(const unsigned char* __restrict__ valid, int p, int b,
                                        int step, int W, int S) {
  const int h = p / step;
  const int col = b * step + (p - h * step);
  const long long hw = (long long)h * W + col;
  bool ok = true;
  if constexpr (MASKED) ok = col < W && valid[hw] != 0;
  return {hw * S, ok};
}

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same, bitwise identical sum.
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// ---------------------------------------------------------------------------
// init_stats / init_stats_masked, pass 1: per (chunk, block) partial moments.
//
// A CTA walks its chunk in tiles of kSub pixels staged in shared memory.
// Each tile is centred on the mean of its valid pixels and folded into the
// running mean and centred scatter by Chan et al.'s pairwise update,
//   M += M_tile + (n_run n_tile / n) d d^T,  mean += d n_tile / n,
// with d = mean_tile - mean and n_tile the tile's VALID count, so every sum
// accumulates centred values. Masked, invalid rows of the tile hold 0 and a
// tile with no valid pixel is skipped (no 0/0). Thread (ty, tx) of a
// 16 x 16 grid owns scatter entries (ty + 16 i, tx + 16 k), i, k < TS, over
// SP = 16 * TS >= S bands (padding bands stay zero).
// Partial record per (b, c): [n | mean(S) | scatter(S*S)].
// ---------------------------------------------------------------------------
template <int TS, bool MASKED>
__global__ void __launch_bounds__(kThreads)
init_stats_partial_kernel(const float* __restrict__ x, const unsigned char* __restrict__ valid,
                          float* __restrict__ partial, int W, int S, int step, int P,
                          int chunk, int nchunks) {
  constexpr int SP = 16 * TS;
  __shared__ float tile[kSub][SP + 1];
  __shared__ float mean[SP], delta[SP];
  __shared__ unsigned char tile_ok[kSub];
  __shared__ int tile_n;

  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int p_beg = c * chunk;
  const int p_end = min(P, p_beg + chunk);

  float acc[TS][TS];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k < TS; ++k) acc[i][k] = 0.f;

  for (int e = tid; e < kSub * (SP + 1); e += kThreads) (&tile[0][0])[e] = 0.f;
  if (tid < SP) mean[tid] = delta[tid] = 0.f;
  __syncthreads();

  int n_run = 0;
  for (int p0 = p_beg; p0 < p_end; p0 += kSub) {
    const int n_span = min(kSub, p_end - p0);
    int n_tile = n_span;
    if constexpr (MASKED) {
      if (tid < kSub) {  // warp 0 marks the tile's valid pixels
        const bool ok = tid < n_span && locate<true>(valid, p0 + tid, b, step, W, S).ok;
        const unsigned vote = __ballot_sync(0xffffffffu, ok);
        tile_ok[tid] = ok;
        if (tid == 0) tile_n = __popc(vote);
      }
      __syncthreads();
      n_tile = tile_n;
      if (n_tile == 0) {  // uniform across the CTA
        __syncthreads();
        continue;
      }
    }
    for (int e = tid; e < n_span * S; e += kThreads) {
      const int pl = e / S, s = e - pl * S;
      const long long off = locate<false>(valid, p0 + pl, b, step, W, S).off;
      if constexpr (MASKED)
        tile[pl][s] = tile_ok[pl] ? x[off + s] : 0.f;
      else
        tile[pl][s] = x[off + s];
    }
    __syncthreads();
    const float n_new = (float)(n_run + n_tile);
    if (tid < S) {
      float m = 0.f;
      for (int pl = 0; pl < n_span; ++pl) m += tile[pl][tid];
      m /= (float)n_tile;
      for (int pl = 0; pl < n_span; ++pl) {
        if constexpr (MASKED)
          tile[pl][tid] = tile_ok[pl] ? tile[pl][tid] - m : 0.f;
        else
          tile[pl][tid] -= m;
      }
      delta[tid] = m - mean[tid];
      mean[tid] += delta[tid] * ((float)n_tile / n_new);
    }
    __syncthreads();
    const float coef = (float)n_run * ((float)n_tile / n_new);
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int k = 0; k < TS; ++k)
        acc[i][k] = fmaf(coef * delta[ty + 16 * i], delta[tx + 16 * k], acc[i][k]);
    for (int pl = 0; pl < n_span; ++pl) {
      float av[TS], bv[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i) av[i] = tile[pl][ty + 16 * i];
#pragma unroll
      for (int k = 0; k < TS; ++k) bv[k] = tile[pl][tx + 16 * k];
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int k = 0; k < TS; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
    }
    n_run += n_tile;
    __syncthreads();
  }

  float* rec = partial + ((long long)b * nchunks + c) * (1 + S + S * S);
  if (tid == 0) rec[0] = (float)n_run;
  if (tid < S) rec[1 + tid] = mean[tid];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k < TS; ++k) {
      const int a = ty + 16 * i, bb = tx + 16 * k;
      if (a < S && bb < S) rec[1 + S + a * S + bb] = acc[i][k];
    }
}

// ---------------------------------------------------------------------------
// init_stats, pass 2: one CTA per block combines the chunk records in chunk
// order in f64 by the same pairwise rule:
//   m = sum_c n_c mean_c / n,
//   C = sum_c [M_c + n_c (mean_c - m)(mean_c - m)^T] / n,
// with n clamped to >= 1 (a block with no valid pixel gets m0 = 0, C0 = 0,
// as JAX's max(sum w, 1)).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
init_stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ m0,
                         float* __restrict__ c0, int S, int nchunks) {
  extern __shared__ double mean_all[];  // S
  const int b = blockIdx.x, tid = threadIdx.x;
  const int rec_len = 1 + S + S * S;
  const float* base = partial + (long long)b * nchunks * rec_len;

  double n = 0.0;
  for (int c = 0; c < nchunks; ++c) n += (double)base[(long long)c * rec_len];
  n = fmax(n, 1.0);
  for (int s = tid; s < S; s += kThreads) {
    double acc = 0.0;
    for (int c = 0; c < nchunks; ++c) {
      const float* rec = base + (long long)c * rec_len;
      acc += (double)rec[0] * (double)rec[1 + s];
    }
    mean_all[s] = acc / n;
    m0[(long long)b * S + s] = (float)(acc / n);
  }
  __syncthreads();
  for (int e = tid; e < S * S; e += kThreads) {
    const int a = e / S, bb = e - a * S;
    double acc = 0.0;
    for (int c = 0; c < nchunks; ++c) {
      const float* rec = base + (long long)c * rec_len;
      const double da = (double)rec[1 + a] - mean_all[a];
      const double db = (double)rec[1 + bb] - mean_all[bb];
      acc += (double)rec[1 + S + e] + (double)rec[0] * da * db;
    }
    c0[(long long)b * S * S + e] = (float)(acc / n);
  }
}

// ---------------------------------------------------------------------------
// filter_round / filter_round_masked: one streaming pass of the reweighted
// filter.
//
// A warp handles one pixel at a time (U at once for memory-level
// parallelism): lane l holds bands l + 32 k, k < NV, so the pixel's S
// contiguous floats load coalesced and the projections are warp reductions.
// Per pixel, with xc = x - m0 and proj = cit.xc - cit.mu:
//   first:  R = (m0.xc) / (m0.m0) + 1, mf = relu(proj / (R norm0))
//   loop:   mf = relu((proj - 1/(R (mf_prev + eps))) / (R norm))
//   final:  as loop, written scaled by 1e5, no statistics
// then g = cov_scale R mf, and the lanes accumulate u += xc g and the
// moments sum g, sum g^2 in registers. Masked, a pixel that does not count
// loads nothing, reads neither R nor mf_prev, and writes mf = 0 (and R = 1
// in the first pass): JAX's "mf times the weight" and where(w > 0, R, 1).
// Carry row layout (nb, 4, S): [mu | target | cit | norm (row 3, every
// entry)]. Partial record per (b, c): [u(S) | sum g | sum g^2].
// ---------------------------------------------------------------------------
template <int NV, int MODE, bool MASKED>
__global__ void __launch_bounds__(kThreads)
filter_round_kernel(const float* __restrict__ x, const unsigned char* __restrict__ valid,
                    const float* __restrict__ m0, const float* __restrict__ carry,
                    float* __restrict__ r, const float* __restrict__ mf_in,
                    float* __restrict__ mf_out, float* __restrict__ partial, int W, int S,
                    int step, int P, int chunk, int nchunks, float cov_scale) {
  constexpr int U = 4;
  __shared__ float red_u[kWarps][32 * NV];
  __shared__ float red_g[kWarps][2];

  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* cb = carry + (long long)b * 4 * S;

  float m0v[NV], citv[NV], uacc[NV];
  float shift_part = 0.f, m0n_part = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int s = lane + 32 * k;
    const bool on = s < S;
    m0v[k] = on ? m0[(long long)b * S + s] : 0.f;
    citv[k] = on ? cb[2 * S + s] : 0.f;
    uacc[k] = 0.f;
    shift_part += on ? citv[k] * cb[s] : 0.f;
    m0n_part += m0v[k] * m0v[k];
  }
  const float shift = warp_sum(shift_part);  // cit . mu
  const float m0n = warp_sum(m0n_part);      // m0 . m0
  const float norm = cb[3 * S];
  float gsum = 0.f, gsq = 0.f;

  const int p_beg = c * chunk;
  const int p_end = min(P, p_beg + chunk);
  const int per_warp = (p_end - p_beg + kWarps - 1) / kWarps;
  const int w_beg = min(p_end, p_beg + warp * per_warp);
  const int w_end = min(p_end, w_beg + per_warp);
  const long long row = (long long)b * P;

  for (int p = w_beg; p < w_end; p += U) {
    float xv[U][NV];
    float pr[U], q[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = false;
      long long off = 0;
      if (p + u < w_end) {
        const Pixel px = locate<MASKED>(valid, p + u, b, step, W, S);
        ok[u] = px.ok;
        off = px.off;
      }
      pr[u] = 0.f;
      q[u] = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int s = lane + 32 * k;
        xv[u][k] = (ok[u] && s < S) ? x[off + s] - m0v[k] : 0.f;
        pr[u] = fmaf(citv[k], xv[u][k], pr[u]);
        if (MODE == kFirst) q[u] = fmaf(m0v[k], xv[u][k], q[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pr[u] = warp_sum(pr[u]);
      if (MODE == kFirst) q[u] = warp_sum(q[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p + u >= w_end) break;
      const long long i = row + p + u;
      float ru = 1.f, mf = 0.f;
      if (ok[u]) {
        const float proj = pr[u] - shift;
        if (MODE == kFirst) {
          ru = q[u] / m0n + 1.f;
          mf = fmaxf(proj / (ru * norm), 0.f);
        } else {
          ru = r[i];
          const float reg = 1.f / (ru * (mf_in[i] + kEpsilon));
          mf = fmaxf((proj - reg) / (ru * norm), 0.f);
        }
      }
      if (MODE == kFirst && lane == 0) r[i] = ru;
      if (MODE == kFinal) {
        if (lane == 0) mf_out[i] = mf * kScaling;
      } else {
        if (lane == 0) mf_out[i] = mf;
        const float g = cov_scale * (ru * mf);  // 0 where the pixel does not count
        gsum += g;
        gsq = fmaf(g, g, gsq);
#pragma unroll
        for (int k = 0; k < NV; ++k) uacc[k] = fmaf(xv[u][k], g, uacc[k]);
      }
    }
  }
  if (MODE == kFinal) return;

#pragma unroll
  for (int k = 0; k < NV; ++k) red_u[warp][lane + 32 * k] = uacc[k];
  if (lane == 0) {
    red_g[warp][0] = gsum;
    red_g[warp][1] = gsq;
  }
  __syncthreads();
  float* rec = partial + ((long long)b * nchunks + c) * (S + 2);
  for (int s = threadIdx.x; s < S + 2; s += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w)
      acc += s < S ? red_u[w][s] : red_g[w][s - S];
    rec[s] = acc;
  }
}

// ---------------------------------------------------------------------------
// filter_glue: _glue_math for one block per CTA, with 1/n of that block
// (nin[b]: the valid count clamped to >= 1, or H*step unmasked). Values are
// f32 as in the TPU kernel; the partials are summed over chunks, and every
// dot product is accumulated, in f64 (the Woodbury solve amplifies rounding
// by the covariance's condition number, ~5e5 on EMIT-like scenes). Threads
// own band rows for the K0 matvecs; thread 0 forms the scalar dots serially
// in band order.
// ---------------------------------------------------------------------------
constexpr int kGlueThreads = 128;  // >= S

__device__ void k0_matvec(const float* __restrict__ k0, const float* v, float* out, int S) {
  const int t = threadIdx.x;
  if (t < S) {
    double acc = 0.0;
    for (int j = 0; j < S; ++j) acc = fma((double)k0[t * S + j], (double)v[j], acc);
    out[t] = (float)acc;
  }
}

__device__ float dot_serial(const float* a, const float* b, int S) {
  double acc = 0.0;
  for (int j = 0; j < S; ++j) acc = fma((double)a[j], (double)b[j], acc);
  return (float)acc;
}

struct GlueScalars {
  float gbar, beta, i00, i01, i10, i11, det, x0, x1, norm;
};

// out = A0^{-1} v by Woodbury against K0 = C0s^{-1} (the a0inv of _glue_math).
__device__ void a0inv(const float* __restrict__ k0, const float* v, float* out,
                      const float* wt, const float* wu, float* kv, GlueScalars& sc, int S) {
  k0_matvec(k0, v, kv, S);
  __syncthreads();
  if (threadIdx.x == 0) {
    const float y0 = dot_serial(wt, v, S);
    const float y1 = dot_serial(wu, v, S);
    sc.x0 = (sc.i11 * y0 - sc.i01 * y1) / sc.det;
    sc.x1 = (-sc.i10 * y0 + sc.i00 * y1) / sc.det;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < S) out[t] = kv[t] - wt[t] * sc.x0 - wu[t] * sc.x1;
  __syncthreads();
}

__global__ void __launch_bounds__(kGlueThreads)
filter_glue_kernel(const float* __restrict__ partial, const float* __restrict__ carry_in,
                   float* __restrict__ carry_out, const float* __restrict__ m0,
                   const float* __restrict__ tmpl, const float* __restrict__ k0_all,
                   const float* __restrict__ nin_all, int S, int nchunks, float alpha) {
  __shared__ float u[kGlueThreads], tgt[kGlueThreads], tnew[kGlueThreads];
  __shared__ float wt[kGlueThreads], wu[kGlueThreads], kv[kGlueThreads];
  __shared__ float z[kGlueThreads], v2[kGlueThreads], z2[kGlueThreads];
  __shared__ GlueScalars sc;

  const int b = blockIdx.x, t = threadIdx.x;
  const float nin = nin_all[b];
  const float* k0 = k0_all + (long long)b * S * S;
  const float* cin = carry_in + (long long)b * 4 * S;
  float* cnext = carry_out + (long long)b * 4 * S;
  const float* base = partial + (long long)b * nchunks * (S + 2);

  for (int s = t; s < S + 2; s += kGlueThreads) {
    double acc = 0.0;
    for (int c = 0; c < nchunks; ++c) acc += (double)base[(long long)c * (S + 2) + s];
    if (s < S) {
      u[s] = (float)acc * nin;  // u = s1 * nin
    } else if (s == S) {
      sc.gbar = (float)acc * nin;
    } else {
      sc.beta = (float)acc * nin;  // mom1 * nin; gbar^2 subtracted below
    }
  }
  if (t < S) tgt[t] = cin[S + t];
  __syncthreads();
  if (t == 0) sc.beta = sc.beta - sc.gbar * sc.gbar;
  __syncthreads();

  float mu_new = 0.f;
  if (t < S) {
    mu_new = -tgt[t] * sc.gbar;
    tnew[t] = tmpl[t] * (m0[(long long)b * S + t] + mu_new);
  }
  k0_matvec(k0, tgt, wt, S);
  k0_matvec(k0, u, wu, S);
  __syncthreads();
  if (t == 0) {
    const float g00 = dot_serial(tgt, wt, S);
    const float g01 = dot_serial(tgt, wu, S);
    const float g10 = dot_serial(u, wt, S);
    const float g11 = dot_serial(u, wu, S);
    const float sa = 1.f - alpha;
    sc.i00 = g00;
    sc.i01 = g01 - 1.f / sa;
    sc.i10 = g10 - 1.f / sa;
    sc.i11 = g11 - sc.beta / sa;
    sc.det = sc.i00 * sc.i11 - sc.i01 * sc.i10;
  }
  __syncthreads();

  a0inv(k0, tnew, z, wt, wu, kv, sc, S);
  if (alpha != 0.f) {
    if (t < S) {
      const float d = sc.beta * tgt[t] * tgt[t] - 2.f * tgt[t] * u[t];
      v2[t] = alpha * d * z[t];
    }
    __syncthreads();
    a0inv(k0, v2, z2, wt, wu, kv, sc, S);
    if (t < S) z[t] = z[t] - z2[t];
    __syncthreads();
  }
  if (t == 0) sc.norm = fmaxf(dot_serial(tnew, z, S), 1.f);
  __syncthreads();
  if (t < S) {
    cnext[t] = mu_new;
    cnext[S + t] = tnew[t];
    cnext[2 * S + t] = z[t];
    cnext[3 * S + t] = sc.norm;
  }
}

template <int TS>
cudaError_t launch_init_partial(const float* x, const unsigned char* valid, float* partial,
                                int W, int S, int step, int P, int chunk, int nchunks, int nb,
                                cudaStream_t st) {
  const dim3 grid(nchunks, nb);
  if (valid != nullptr)
    init_stats_partial_kernel<TS, true><<<grid, kThreads, 0, st>>>(
        x, valid, partial, W, S, step, P, chunk, nchunks);
  else
    init_stats_partial_kernel<TS, false><<<grid, kThreads, 0, st>>>(
        x, valid, partial, W, S, step, P, chunk, nchunks);
  return cudaGetLastError();
}

template <int NV, bool MASKED>
void launch_round_mode(int mode, dim3 grid, cudaStream_t st, const float* x,
                       const unsigned char* valid, const float* m0, const float* carry, float* r,
                       const float* mf_in, float* mf_out, float* partial, int W, int S, int step,
                       int P, int chunk, int nchunks, float cov_scale) {
  if (mode == kFirst)
    filter_round_kernel<NV, kFirst, MASKED><<<grid, kThreads, 0, st>>>(
        x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, cov_scale);
  else if (mode == kLoop)
    filter_round_kernel<NV, kLoop, MASKED><<<grid, kThreads, 0, st>>>(
        x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, cov_scale);
  else
    filter_round_kernel<NV, kFinal, MASKED><<<grid, kThreads, 0, st>>>(
        x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, cov_scale);
}

template <int NV>
cudaError_t launch_round(int mode, const float* x, const unsigned char* valid, const float* m0,
                         const float* carry, float* r, const float* mf_in, float* mf_out,
                         float* partial, int W, int S, int step, int P, int chunk, int nchunks,
                         int nb, float cov_scale, cudaStream_t st) {
  const dim3 grid(nchunks, nb);
  if (valid != nullptr)
    launch_round_mode<NV, true>(mode, grid, st, x, valid, m0, carry, r, mf_in, mf_out, partial,
                                W, S, step, P, chunk, nchunks, cov_scale);
  else
    launch_round_mode<NV, false>(mode, grid, st, x, valid, m0, carry, r, mf_in, mf_out, partial,
                                 W, S, step, P, chunk, nchunks, cov_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest band count the kernels take (four band slots per lane).
int starcop_max_bands() { return 128; }

const char* starcop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// valid == nullptr: every pixel of the (H, nb*step, S) cube counts
// (init_stats); else the (H, W) uint8 mask selects (init_stats_masked).
int starcop_init_stats(const float* x, const unsigned char* valid, float* partial, float* m0,
                       float* c0, int H, int W, int S, int nb, int step, int chunk, int nchunks,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = H * step;
  cudaError_t err;
  switch ((S + 15) / 16) {
    case 1: err = launch_init_partial<1>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 2: err = launch_init_partial<2>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 3: err = launch_init_partial<3>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 4: err = launch_init_partial<4>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 5: err = launch_init_partial<5>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 6: err = launch_init_partial<6>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 7: err = launch_init_partial<7>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    case 8: err = launch_init_partial<8>(x, valid, partial, W, S, step, P, chunk, nchunks, nb, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  init_stats_reduce_kernel<<<nb, kThreads, S * sizeof(double), st>>>(partial, m0, c0, S, nchunks);
  return (int)cudaGetLastError();
}

// valid == nullptr: filter_round; else filter_round_masked.
int starcop_filter_round(int mode, const float* x, const unsigned char* valid, const float* m0,
                         const float* carry, float* r, const float* mf_in, float* mf_out,
                         float* partial, int H, int W, int S, int nb, int step, int chunk,
                         int nchunks, float cov_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = H * step;
  if (mode < kFirst || mode > kFinal) return (int)cudaErrorInvalidValue;
  switch ((S + 31) / 32) {
    case 1: return (int)launch_round<1>(mode, x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, nb, cov_scale, st);
    case 2: return (int)launch_round<2>(mode, x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, nb, cov_scale, st);
    case 3: return (int)launch_round<3>(mode, x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, nb, cov_scale, st);
    case 4: return (int)launch_round<4>(mode, x, valid, m0, carry, r, mf_in, mf_out, partial, W, S, step, P, chunk, nchunks, nb, cov_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int starcop_filter_glue(const float* partial, const float* carry_in, float* carry_out,
                        const float* m0, const float* tmpl, const float* k0, const float* nin,
                        int S, int nb, int nchunks, float alpha, void* stream) {
  if (S > kGlueThreads) return (int)cudaErrorInvalidValue;
  filter_glue_kernel<<<nb, kGlueThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, carry_in, carry_out, m0, tmpl, k0, nin, S, nchunks, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
