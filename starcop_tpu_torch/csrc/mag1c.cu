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
// The blocked (nb, R, P) stream: band row s of column block b is P
// contiguous values, R >= S rows (rows S..R-1 zero), pixel p = h*step + j;
// bf16 (stream_dtype=bf16) or f32 (acrwl1mf_fused's (B, S, P) input and the
// band-major cube's route, mag1c_fused.cu).
//
//   blocked_transpose <- _blocked_transpose_kernel (:92) and
//                        _blocked_transpose_swh_kernel (:170) followed by
//                        the XLA centre-and-cast (:1706, :1796-1798): the
//                        (H, W, S) cube to the blocked layout, centred by m0,
//                        optionally masked, stored bf16.
//   init_stats        <- _init_stats_kernel (:1164) as well: the unmasked
//                        bf16 route takes m0 and C0 from the cube itself, so
//                        no f32 blocked copy is made.
//   init_stats_stream <- _init_stats_kernel (:1164) on the raw f32 stream.
//   init_stats_bsp    <- the XLA second moment of the masked bf16 stream
//                        (:1814-1824).
//   filter_round_bsp  <- _resident_kernel (:1048), bf16 storage and f32
//                        math or the raw f32 stream centred in registers;
//                        _first_round_kernel (:594) / _loop_round_kernel
//                        (:664), masked, with bf16_dots on a bf16 stream.
//
// One bf16 block is 7.7 MB and the whole stream ~178 MB at EMIT size (f32:
// twice that), far beyond an SM's 228 KB and the 50 MB L2, so the stream is
// read once per pass as K1 reads the cube: every filter_round_bsp launch is
// bound by the stream's HBM bytes.
//
// Interface: plain C functions taking raw pointers and the caller's stream;
// bindings.cpp registers them as torch ops. Each returns the cudaError_t of
// its launches.

#include "mag1c_common.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// init_stats / init_stats_masked, pass 1: per (chunk, block) partial moments
// (the tiles and Chan fold of mag1c_common.cuh). n_tile is the tile's VALID
// count. Masked, invalid rows of the tile hold 0 and a tile with no valid
// pixel is skipped (no 0/0).
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
    fold_tile<TS>(tile, MASKED ? tile_ok : nullptr, n_span, n_tile, n_run, mean, delta, acc, S);
    __syncthreads();
  }
  write_stats_record<TS>(partial + ((long long)b * nchunks + c) * (1 + S + S * S), n_run, mean,
                         acc, S);
}

// ---------------------------------------------------------------------------
// init_stats_bsp / init_stats_stream, pass 1: the statistics of the blocked
// stream (nb, R, P) over its first S rows, in init_stats_partial_kernel's
// tiles. Row s of a tile is 32 contiguous pixels of band row s, so a warp's
// load is one coalesced span. One read of the stream.
//   bf16 (init_stats_bsp): the raw second moment sum xs xs^T of the centred
//     stream, which is zero wherever a pixel does not count (f32 products and
//     sums, no re-centring, as :1814-1824). The records carry zero means, so
//     the reduce adds their scatters alone.
//   float (init_stats_stream, _init_stats_kernel :1164): the mean and the
//     centred covariance of the raw f32 stream, every pixel valid, by the
//     Chan fold (a plain f32 covariance of a 69,120-pixel block drifts the
//     30-iteration filter away from its f64 twin; see PERF.md).
// ---------------------------------------------------------------------------
template <int TS, typename T>
__global__ void __launch_bounds__(kThreads)
init_stats_bsp_partial_kernel(const T* __restrict__ xs, float* __restrict__ partial, int S,
                              int R, int P, int chunk, int nchunks) {
  constexpr bool MEAN = sizeof(T) == 4;
  constexpr int SP = 16 * TS;
  __shared__ float tile[kSub][SP + 1];
  __shared__ float mean[SP], delta[SP];  // mean stays zero without MEAN

  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p_beg = c * chunk;
  const int p_end = min(P, p_beg + chunk);
  const T* xb = xs + (long long)b * R * P;

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
    for (int e = tid; e < kSub * S; e += kThreads) {
      const int s = e / kSub, pl = e - s * kSub;
      if (pl < n_span) tile[pl][s] = to_f32(xb[(long long)s * P + p0 + pl]);
    }
    __syncthreads();
    if constexpr (MEAN)
      fold_tile<TS>(tile, nullptr, n_span, n_span, n_run, mean, delta, acc, S);
    else
      scatter_tile<TS>(tile, n_span, acc);
    __syncthreads();
  }
  write_stats_record<TS>(partial + ((long long)b * nchunks + c) * (1 + S + S * S),
                         p_end - p_beg, mean, acc, S);
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
// filter_round_bsp: one streaming pass of the filter over the blocked stream
// (nb, R, P), the counterpart of filter_round for the blocked layout; the
// body is round_bsp_chunk (mag1c_common.cuh), the record goes to filter_glue.
//
//   bf16 storage: _resident_kernel (:1088-1095, f32 products) unmasked, and
//     _first_round_kernel / _loop_round_kernel with bf16_dots masked.
//   f32 storage (row 9 at f32, and rows 5-6 on an f32 stream): the raw
//     stream centred in registers (CENTER, JAX's centered=False), or a
//     centred one (acrwl1mf_fused's (B, P, S) layout), masked by a (B, P) row.
// ---------------------------------------------------------------------------
template <typename T, int MODE, bool MASKED, bool BF16_DOTS, bool CENTER>
__global__ void __launch_bounds__(kRoundBspThreads)
filter_round_bsp_kernel(const T* __restrict__ xs, const unsigned char* __restrict__ valid,
                        const float* __restrict__ m0, const float* __restrict__ carry,
                        float* __restrict__ r, const float* __restrict__ mf_in,
                        float* __restrict__ mf_out, float* __restrict__ partial, int W, int S,
                        int R, int step, int P, int chunk, int nchunks, float cov_scale) {
  round_bsp_chunk<T, MODE, MASKED, BF16_DOTS, CENTER>(xs, valid, m0, carry, r, mf_in, mf_out,
                                                      partial, W, S, R, step, P, chunk, nchunks,
                                                      cov_scale);
}

// ---------------------------------------------------------------------------
// filter_glue: glue_block (mag1c_common.cuh) for one block per CTA, with 1/n
// of that block (nin[b]: the valid count clamped to >= 1, or H*step unmasked).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kGlueThreads)
filter_glue_kernel(const float* __restrict__ partial, const float* __restrict__ carry_in,
                   float* __restrict__ carry_out, const float* __restrict__ m0,
                   const float* __restrict__ tmpl, const float* __restrict__ k0_all,
                   const float* __restrict__ nin_all, int S, int nchunks, float alpha) {
  __shared__ GlueSmem g;
  const int b = blockIdx.x;
  glue_block(partial + (long long)b * nchunks * (S + 2), nchunks, carry_in + (long long)b * 4 * S,
             carry_out + (long long)b * 4 * S, m0 + (long long)b * S, tmpl,
             k0_all + (long long)b * S * S, nin_all[b], S, alpha, g);
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

template <int TS, typename T>
cudaError_t launch_init_bsp(const void* xs, float* partial, int S, int R, int P, int chunk,
                            int nchunks, int nb, cudaStream_t st) {
  init_stats_bsp_partial_kernel<TS, T><<<dim3(nchunks, nb), kThreads, 0, st>>>(
      static_cast<const T*>(xs), partial, S, R, P, chunk, nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_init_bsp_ts(const void* xs, float* partial, int S, int R, int P, int chunk,
                               int nchunks, int nb, cudaStream_t st) {
  switch ((S + 15) / 16) {
    case 1: return launch_init_bsp<1, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 2: return launch_init_bsp<2, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 3: return launch_init_bsp<3, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 4: return launch_init_bsp<4, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 5: return launch_init_bsp<5, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 6: return launch_init_bsp<6, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 7: return launch_init_bsp<7, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    case 8: return launch_init_bsp<8, T>(xs, partial, S, R, P, chunk, nchunks, nb, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool MASKED, bool BF16_DOTS, bool CENTER>
cudaError_t launch_round_bsp(int mode, const void* xs_raw, const unsigned char* valid,
                             const float* m0, const float* carry, float* r, const float* mf_in,
                             float* mf_out, float* partial, int W, int S, int R, int step, int P,
                             int chunk, int nchunks, int nb, float cov_scale, cudaStream_t st) {
  const T* xs = static_cast<const T*>(xs_raw);
  const dim3 grid(nchunks, nb);
  const size_t smem = round_bsp_smem<T>(S);
  auto run = [&](auto kernel) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kRoundBspThreads, smem, st>>>(xs, valid, m0, carry, r, mf_in, mf_out, partial,
                                                 W, S, R, step, P, chunk, nchunks, cov_scale);
    return cudaGetLastError();
  };
  if (mode == kFirst) return run(filter_round_bsp_kernel<T, kFirst, MASKED, BF16_DOTS, CENTER>);
  if (mode == kLoop) return run(filter_round_bsp_kernel<T, kLoop, MASKED, BF16_DOTS, CENTER>);
  return run(filter_round_bsp_kernel<T, kFinal, MASKED, BF16_DOTS, CENTER>);
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
  const cudaError_t err = launch_init_bsp_ts<__nv_bfloat16>(xs, partial, R, R, P, chunk, nchunks,
                                                            nb, st);
  if (err != cudaSuccess) return (int)err;
  init_stats_reduce_kernel<<<nb, kThreads, R * sizeof(double), st>>>(partial, n_given, nullptr,
                                                                     c0, R, nchunks);
  return (int)cudaGetLastError();
}

// m0 (nb, S), C0 (nb, S, S) of the raw f32 stream (nb, R, P) over its first S
// rows, every pixel valid.
int starcop_init_stats_stream(const float* xs, float* partial, float* m0, float* c0, int nb,
                              int S, int R, int P, int chunk, int nchunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > R) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_init_bsp_ts<float>(xs, partial, S, R, P, chunk, nchunks, nb, st);
  if (err != cudaSuccess) return (int)err;
  init_stats_reduce_kernel<<<nb, kThreads, S * sizeof(double), st>>>(partial, nullptr, m0, c0, S,
                                                                     nchunks);
  return (int)cudaGetLastError();
}

// One pass over the blocked stream (nb, R, P) with S <= R live bands, stored
// f32 (f32 != 0) or bf16. valid == nullptr: every pixel counts, else the
// (H, W) mask and the width W select. bf16_dots (bf16 only) rounds cit, m0
// and g to bf16; center (f32 only) subtracts m0 from the raw stream.
int starcop_filter_round_bsp(int mode, const void* xs, int f32, const unsigned char* valid,
                             int bf16_dots, int center, const float* m0, const float* carry,
                             float* r, const float* mf_in, float* mf_out, float* partial, int H,
                             int W, int S, int R, int nb, int step, int chunk, int nchunks,
                             float cov_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kFirst || mode > kFinal || S < 1 || S > kMaxBands || R < S)
    return (int)cudaErrorInvalidValue;
  if ((f32 && bf16_dots) || (!f32 && center) || (valid != nullptr && center))
    return (int)cudaErrorInvalidValue;
  const int P = H * step;
#define STARCOP_ROUND_BSP(T, MASKED, DOTS, CENTER)                                              \
  return (int)launch_round_bsp<T, MASKED, DOTS, CENTER>(mode, xs, valid, m0, carry, r, mf_in,  \
                                                        mf_out, partial, W, S, R, step, P,      \
                                                        chunk, nchunks, nb, cov_scale, st)
  if (f32) {
    if (valid != nullptr) STARCOP_ROUND_BSP(float, true, false, false);
    if (center) STARCOP_ROUND_BSP(float, false, false, true);
    STARCOP_ROUND_BSP(float, false, false, false);
  }
  if (valid != nullptr) {
    if (bf16_dots) STARCOP_ROUND_BSP(__nv_bfloat16, true, true, false);
    STARCOP_ROUND_BSP(__nv_bfloat16, true, false, false);
  }
  if (bf16_dots) STARCOP_ROUND_BSP(__nv_bfloat16, false, true, false);
  STARCOP_ROUND_BSP(__nv_bfloat16, false, false, false);
#undef STARCOP_ROUND_BSP
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
