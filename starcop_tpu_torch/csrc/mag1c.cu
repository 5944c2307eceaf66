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
// The bf16 stream (stream_dtype=bf16) works on the blocked (nb, R, P)
// layout: band row s of column block b is R*P contiguous values, R >= S a
// multiple of 8 (rows S..R-1 zero), pixel p = h*step + j.
//
//   blocked_transpose <- _blocked_transpose_kernel (:92) and
//                        _blocked_transpose_swh_kernel (:170) followed by
//                        the XLA centre-and-cast (:1706, :1796-1798): the
//                        (H, W, S) cube to the blocked layout, centred by m0,
//                        optionally masked, stored bf16.
//   init_stats        <- _init_stats_kernel (:1164) as well: the unmasked
//                        route takes m0 and C0 from the cube itself, so no
//                        f32 blocked copy is made.
//   init_stats_bsp    <- the XLA second moment of the masked bf16 stream
//                        (:1814-1824).
//   filter_round_bsp  <- _resident_kernel (:1048) with bf16 storage and f32
//                        math (unmasked), and _first_round_kernel (:594) /
//                        _loop_round_kernel (:664) with bf16_dots (masked).
//
// One bf16 block is 7.7 MB and the whole stream ~178 MB at EMIT size, far
// beyond an SM's 228 KB and the 50 MB L2, so the stream is read once per
// pass as K1 reads the cube: every filter_round_bsp launch is bound by the
// stream's HBM bytes, half of the f32 cube's.
//
// Interface: plain C functions taking raw pointers and the caller's stream;
// bindings.cpp registers them as torch ops. Each returns the cudaError_t of
// its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;       // pixels per shared-memory tile in init_stats (one warp)
constexpr int kMaxBands = 128;
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

// acc[i][k] += sum over the tile's first n_span rows of
// tile[pl][ty + 16 i] * tile[pl][tx + 16 k].
template <int TS>
__device__ __forceinline__ void scatter_tile(const float (*tile)[16 * TS + 1], int n_span,
                                             float (&acc)[TS][TS]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
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
}

// The partial record [n | mean(S) | scatter(S*S)] of (b, c).
template <int TS>
__device__ __forceinline__ void write_stats_record(float* rec, int n, const float* mean,
                                                   const float (&acc)[TS][TS], int S) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid == 0) rec[0] = (float)n;
  if (tid < S) rec[1 + tid] = mean[tid];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k < TS; ++k) {
      const int a = ty + 16 * i, bb = tx + 16 * k;
      if (a < S && bb < S) rec[1 + S + a * S + bb] = acc[i][k];
    }
}

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
    scatter_tile<TS>(tile, n_span, acc);
    n_run += n_tile;
    __syncthreads();
  }
  write_stats_record<TS>(partial + ((long long)b * nchunks + c) * (1 + S + S * S), n_run, mean,
                         acc, S);
}

// ---------------------------------------------------------------------------
// init_stats_bsp, pass 1: the raw second moment sum xs xs^T of the centred
// bf16 stream (nb, R, P), which is zero wherever a pixel does not count, in
// init_stats_partial_kernel's tiles (f32 products and sums, no re-centring,
// as :1814-1824). Row s of a tile is 32 contiguous pixels of band row s, so
// a warp's load is one coalesced span. The records carry zero means, so the
// shared reduce adds their scatters alone. One read of the stream.
// ---------------------------------------------------------------------------
template <int TS>
__global__ void __launch_bounds__(kThreads)
init_stats_bsp_partial_kernel(const __nv_bfloat16* __restrict__ xs, float* __restrict__ partial,
                              int R, int P, int chunk, int nchunks) {
  constexpr int SP = 16 * TS;
  __shared__ float tile[kSub][SP + 1];
  __shared__ float mean[SP];  // zero

  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p_beg = c * chunk;
  const int p_end = min(P, p_beg + chunk);
  const __nv_bfloat16* xb = xs + (long long)b * R * P;

  float acc[TS][TS];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k < TS; ++k) acc[i][k] = 0.f;

  for (int e = tid; e < kSub * (SP + 1); e += kThreads) (&tile[0][0])[e] = 0.f;
  if (tid < SP) mean[tid] = 0.f;
  __syncthreads();

  for (int p0 = p_beg; p0 < p_end; p0 += kSub) {
    const int n_span = min(kSub, p_end - p0);
    for (int e = tid; e < kSub * R; e += kThreads) {
      const int s = e / kSub, pl = e - s * kSub;
      if (pl < n_span) tile[pl][s] = __bfloat162float(xb[(long long)s * P + p0 + pl]);
    }
    __syncthreads();
    scatter_tile<TS>(tile, n_span, acc);
    __syncthreads();
  }
  write_stats_record<TS>(partial + ((long long)b * nchunks + c) * (1 + R + R * R),
                         p_end - p_beg, mean, acc, R);
}

// ---------------------------------------------------------------------------
// init_stats, pass 2: one CTA per block combines the chunk records in chunk
// order in f64 by the same pairwise rule:
//   m = sum_c n_c mean_c / n,
//   C = sum_c [M_c + n_c (mean_c - m)(mean_c - m)^T] / n,
// with n clamped to >= 1 (a block with no valid pixel gets m0 = 0, C0 = 0,
// as JAX's max(sum w, 1)). With n_given (init_stats_bsp, whose records carry
// zero means) n is the block's given valid count instead and m0 is not
// written.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
init_stats_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ n_given,
                         float* __restrict__ m0, float* __restrict__ c0, int S, int nchunks) {
  extern __shared__ double mean_all[];  // S
  const int b = blockIdx.x, tid = threadIdx.x;
  const int rec_len = 1 + S + S * S;
  const float* base = partial + (long long)b * nchunks * rec_len;

  double n = 0.0;
  for (int c = 0; c < nchunks; ++c) n += (double)base[(long long)c * rec_len];
  n = n_given != nullptr ? (double)n_given[b] : fmax(n, 1.0);
  for (int s = tid; s < S; s += kThreads) {
    double acc = 0.0;
    for (int c = 0; c < nchunks; ++c) {
      const float* rec = base + (long long)c * rec_len;
      acc += (double)rec[0] * (double)rec[1 + s];
    }
    mean_all[s] = acc / n;
    if (m0 != nullptr) m0[(long long)b * S + s] = (float)(acc / n);
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
// blocked_transpose: the (H, W, S) f32 cube -> the centred bf16 stream
// (nb, R, P), out[b, s, h*step + j] = bf16(x[h, b*step + j, s] - m0[b, s])
// (round to nearest even), rows S..R-1 zero. Optionally masked by the
// (H, W) uint8 valid mask (0 where the mask is unset or the column is >= W,
// selected, never multiplied). A CTA stages TP pixels x S
// bands in shared memory: it reads them pixel-major, as the cube lies (runs
// of step * S contiguous floats), and writes them band-major, TP contiguous
// pixels per band row. Bound by HBM bytes (one read, one write).
// ---------------------------------------------------------------------------
constexpr int kTransposePixels = 64;

__global__ void __launch_bounds__(kThreads)
blocked_transpose_kernel(const float* __restrict__ x, const float* __restrict__ m0,
                         const unsigned char* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                         int W, int S, int R, int step, int P) {
  constexpr int TP = kTransposePixels;
  extern __shared__ float staged[];  // [TP][S + 1]
  const int b = blockIdx.y, p0 = blockIdx.x * TP, tid = threadIdx.x;
  const int n_span = min(TP, P - p0);
  for (int e = tid; e < n_span * S; e += kThreads) {
    const int pl = e / S, s = e - pl * S;
    const int p = p0 + pl, h = p / step;
    const int col = b * step + (p - h * step);
    const long long hw = (long long)h * W + col;
    float v = 0.f;
    if (col < W && (valid == nullptr || valid[hw] != 0)) v = x[hw * S + s] - m0[(long long)b * S + s];
    staged[pl * (S + 1) + s] = v;
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (long long)b * R * P + p0;
  for (int e = tid; e < R * TP; e += kThreads) {
    const int s = e / TP, pl = e - s * TP;
    if (pl < n_span)
      ob[(long long)s * P + pl] = __float2bfloat16_rn(s < S ? staged[pl * (S + 1) + s] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// filter_round_bsp: one streaming pass of the filter over the centred bf16
// stream (nb, R, P), the counterpart of filter_round for the blocked layout.
//
// A CTA of TP threads owns a chunk of one block and walks it in tiles of TP
// pixels, thread t on pixel p0 + t. Per tile: each thread reads its pixel's S
// band values (one coalesced 2*TP-byte row per band), stages them in shared
// memory and forms proj = cit.xs - cit.mu (and q = m0.xs in FIRST); then mf,
// R and g = cov_scale R mf as filter_round does; then thread t < S adds its
// band's u[t] += sum over the tile of xs[t, p] g[p]. The per-chunk record is
// [u(S) | sum g | sum g^2] for filter_glue. Sums run in a fixed order, so a
// rerun is bitwise identical.
//
// BF16_DOTS (the masked route, _first_round_kernel / _loop_round_kernel with
// bf16_dots=True): cit, m0 and g are rounded to bf16 before their products
// with the stream (:633-636, :693-701, _lane_dot :555-574), as JAX's bf16 MXU
// dots take them; the products are then exact in f32 and accumulate in f32.
// cit.mu, m0.m0, sum g, sum g^2 and the glue stay f32. Without it (the
// unmasked resident route, _resident_kernel :1088-1095) bf16 is storage only
// and every product is f32.
//
// MASKED reads the (H, W) uint8 mask and the width W as filter_round_masked
// does: a pixel that does not count loads nothing and gets mf = 0, R = 1.
// ---------------------------------------------------------------------------
constexpr int kRoundBspThreads = 128;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE, bool MASKED, bool BF16_DOTS>
__global__ void __launch_bounds__(kRoundBspThreads)
filter_round_bsp_kernel(const __nv_bfloat16* __restrict__ xs,
                        const unsigned char* __restrict__ valid, const float* __restrict__ m0,
                        const float* __restrict__ carry, float* __restrict__ r,
                        const float* __restrict__ mf_in, float* __restrict__ mf_out,
                        float* __restrict__ partial, int W, int S, int R, int step, int P,
                        int chunk, int nchunks, float cov_scale) {
  constexpr int TP = kRoundBspThreads;
  constexpr int LD = TP + 2;  // staged row pitch: an odd number of words, no bank conflicts
  extern __shared__ __nv_bfloat16 xt[];  // [S][LD]
  __shared__ float cit_d[kMaxBands], m0_d[kMaxBands], g_d[TP];
  __shared__ float red[2][TP / 32];
  __shared__ float consts[2];  // cit . mu, m0 . m0

  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const float* cb = carry + (long long)b * 4 * S;
  const float* mb = m0 + (long long)b * S;
  for (int s = t; s < S; s += TP) {
    cit_d[s] = BF16_DOTS ? bf16_round(cb[2 * S + s]) : cb[2 * S + s];
    m0_d[s] = BF16_DOTS ? bf16_round(mb[s]) : mb[s];
  }
  if (t == 0) {
    float shift = 0.f, m0n = 0.f;
    for (int s = 0; s < S; ++s) {
      shift = fmaf(cb[2 * S + s], cb[s], shift);
      m0n = fmaf(mb[s], mb[s], m0n);
    }
    consts[0] = shift;
    consts[1] = m0n;
  }
  __syncthreads();
  const float shift = consts[0], m0n = consts[1], norm = cb[3 * S];

  float uacc = 0.f, gsum = 0.f, gsq = 0.f;
  const int p_beg = c * chunk;
  const int p_end = min(P, p_beg + chunk);
  const __nv_bfloat16* xb = xs + (long long)b * R * P;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int p0 = p_beg; p0 < p_end; p0 += TP) {
    const int p = p0 + t;
    const bool in = p < p_end;
    bool ok = in;
    if (MASKED && in) {
      const int h = p / step;
      const int col = b * step + (p - h * step);
      ok = col < W && valid[(long long)h * W + col] != 0;
    }
    float proj = 0.f, q = 0.f;
    for (int s = 0; s < S; ++s) {
      const __nv_bfloat16 v = ok ? xb[(long long)s * P + p] : zero;
      if (MODE != kFinal) xt[s * LD + t] = v;
      const float xv = __bfloat162float(v);
      proj = fmaf(cit_d[s], xv, proj);
      if (MODE == kFirst) q = fmaf(m0_d[s], xv, q);
    }
    float ru = 1.f, mf = 0.f;
    if (ok) {
      const long long i = (long long)b * P + p;
      if (MODE == kFirst) {
        ru = q / m0n + 1.f;
        mf = fmaxf((proj - shift) / (ru * norm), 0.f);
      } else {
        ru = r[i];
        const float reg = 1.f / (ru * (mf_in[i] + kEpsilon));
        mf = fmaxf((proj - shift - reg) / (ru * norm), 0.f);
      }
    }
    if (in) {
      const long long i = (long long)b * P + p;
      if (MODE == kFirst) r[i] = ru;
      mf_out[i] = MODE == kFinal ? mf * kScaling : mf;
    }
    if (MODE == kFinal) continue;
    const float g = cov_scale * (ru * mf);  // 0 where the pixel does not count
    gsum += g;
    gsq = fmaf(g, g, gsq);
    g_d[t] = BF16_DOTS ? bf16_round(g) : g;
    __syncthreads();
    if (t < S) {
      const __nv_bfloat16* row = xt + t * LD;
      for (int k = 0; k < TP; ++k) uacc = fmaf(__bfloat162float(row[k]), g_d[k], uacc);
    }
    __syncthreads();
  }
  if (MODE == kFinal) return;

  gsum = warp_sum(gsum);
  gsq = warp_sum(gsq);
  if (t % 32 == 0) {
    red[0][t / 32] = gsum;
    red[1][t / 32] = gsq;
  }
  __syncthreads();
  float* rec = partial + ((long long)b * nchunks + c) * (S + 2);
  if (t < S) rec[t] = uacc;
  if (t == 0) {
    float sum_g = 0.f, sum_g2 = 0.f;
    for (int w = 0; w < TP / 32; ++w) {
      sum_g += red[0][w];
      sum_g2 += red[1][w];
    }
    rec[S] = sum_g;
    rec[S + 1] = sum_g2;
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

template <int TS>
cudaError_t launch_init_bsp(const void* xs, float* partial, int R, int P, int chunk, int nchunks,
                            int nb, cudaStream_t st) {
  init_stats_bsp_partial_kernel<TS><<<dim3(nchunks, nb), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(xs), partial, R, P, chunk, nchunks);
  return cudaGetLastError();
}

template <bool MASKED, bool BF16_DOTS>
cudaError_t launch_round_bsp(int mode, const __nv_bfloat16* xs, const unsigned char* valid,
                             const float* m0, const float* carry, float* r, const float* mf_in,
                             float* mf_out, float* partial, int W, int S, int R, int step, int P,
                             int chunk, int nchunks, int nb, float cov_scale, cudaStream_t st) {
  const dim3 grid(nchunks, nb);
  const size_t smem = (size_t)S * (kRoundBspThreads + 2) * sizeof(__nv_bfloat16);
  if (mode == kFirst)
    filter_round_bsp_kernel<kFirst, MASKED, BF16_DOTS><<<grid, kRoundBspThreads, smem, st>>>(
        xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S, R, step, P, chunk, nchunks,
        cov_scale);
  else if (mode == kLoop)
    filter_round_bsp_kernel<kLoop, MASKED, BF16_DOTS><<<grid, kRoundBspThreads, smem, st>>>(
        xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S, R, step, P, chunk, nchunks,
        cov_scale);
  else
    filter_round_bsp_kernel<kFinal, MASKED, BF16_DOTS><<<grid, kRoundBspThreads, smem, st>>>(
        xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S, R, step, P, chunk, nchunks,
        cov_scale);
  return cudaGetLastError();
}

template <bool MASKED, typename... Args>
cudaError_t launch_round_bsp_dots(bool bf16_dots, Args... args) {
  return bf16_dots ? launch_round_bsp<MASKED, true>(args...)
                   : launch_round_bsp<MASKED, false>(args...);
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
  init_stats_reduce_kernel<<<nb, kThreads, S * sizeof(double), st>>>(partial, nullptr, m0, c0, S,
                                                                     nchunks);
  return (int)cudaGetLastError();
}

// The (H, W, S) f32 cube -> the bf16 stream (nb, R, P) centred by m0
// (nb, S); valid (H, W) masks when given.
int starcop_blocked_transpose(const float* x, const float* m0, const unsigned char* valid,
                              void* out, int H, int W, int S, int R, int nb, int step,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > kMaxBands || R < S) return (int)cudaErrorInvalidValue;
  const int P = H * step;
  const dim3 grid((P + kTransposePixels - 1) / kTransposePixels, nb);
  const size_t smem = (size_t)kTransposePixels * (S + 1) * sizeof(float);
  blocked_transpose_kernel<<<grid, kThreads, smem, st>>>(
      x, m0, valid, static_cast<__nv_bfloat16*>(out), W, S, R, step, P);
  return (int)cudaGetLastError();
}

// C0 (nb, R, R) = sum xs xs^T / n_given[b] of the centred bf16 stream
// (nb, R, P).
int starcop_init_stats_bsp(const void* xs, const float* n_given, float* partial, float* c0,
                           int nb, int R, int P, int chunk, int nchunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((R + 15) / 16) {
    case 1: err = launch_init_bsp<1>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 2: err = launch_init_bsp<2>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 3: err = launch_init_bsp<3>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 4: err = launch_init_bsp<4>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 5: err = launch_init_bsp<5>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 6: err = launch_init_bsp<6>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 7: err = launch_init_bsp<7>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    case 8: err = launch_init_bsp<8>(xs, partial, R, P, chunk, nchunks, nb, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  init_stats_reduce_kernel<<<nb, kThreads, R * sizeof(double), st>>>(partial, n_given, nullptr,
                                                                     c0, R, nchunks);
  return (int)cudaGetLastError();
}

// One pass over the bf16 stream (nb, R, P) with S <= R live bands; valid ==
// nullptr: every pixel counts (the unmasked resident route), else the (H, W)
// mask and the width W select. bf16_dots rounds cit, m0 and g to bf16.
int starcop_filter_round_bsp(int mode, const void* xs, const unsigned char* valid,
                             int bf16_dots, const float* m0, const float* carry, float* r,
                             const float* mf_in, float* mf_out, float* partial, int H, int W,
                             int S, int R, int nb, int step, int chunk, int nchunks,
                             float cov_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kFirst || mode > kFinal || S < 1 || S > kMaxBands || R < S)
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const __nv_bfloat16*>(xs);
  const int P = H * step;
  if (valid != nullptr)
    return (int)launch_round_bsp_dots<true>(bf16_dots != 0, mode, x, valid, m0, carry, r, mf_in,
                                            mf_out, partial, W, S, R, step, P, chunk, nchunks,
                                            nb, cov_scale, st);
  return (int)launch_round_bsp_dots<false>(bf16_dots != 0, mode, x, valid, m0, carry, r, mf_in,
                                           mf_out, partial, W, S, R, step, P, chunk, nchunks, nb,
                                           cov_scale, st);
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
