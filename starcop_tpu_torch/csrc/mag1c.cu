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
// arithmetic is a few FMAs per byte. To stream near that bound a round CTA
// keeps a ring of 2-4 tiles (whole rows of its block) in flight by cp.async,
// projects one pixel per thread and splits the u sum's bands over its warps;
// the chunk per CTA is chosen so that the grid's last wave is (nearly) full
// ("The streaming rounds" in mag1c_common.cuh, round_geometry in
// ops/mag1c_kernels.py).
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
// filter over the (H, W, S) cube (the shared design and per-pixel math are
// above round_bsp_chunk's machinery in mag1c_common.cuh).
//
// A tile is tile_rows image rows x tile_cols columns of block b: whole rows
// of the block, or a segment of one row where a row is wider than
// kRoundThreads pixels. Each tile row is tile_cols * S contiguous floats of
// the cube, staged pixel-major at pitch cube_row_pitch, so a tile row is one
// contiguous copy and no pixel needs p / step: thread t owns pixel (t /
// tile_cols, t % tile_cols) of every tile. VEC16: W * S and step * S are
// multiples of 4 and the cube starts on 16 bytes, so every tile row starts
// and ends on 16 bytes; else 4-byte copies. A pixel-major tile with an even
// S is read with 2-way bank conflicts at S = 50 (more where S is a multiple
// of 8): the reads stay far below the shared-memory rate the HBM stream
// needs. Masked, the columns of the ragged last block past W are neither
// copied nor read, and a pixel whose mask byte is 0 is selected out.
// Carry row layout (nb, 4, S): [mu | target | cit | norm (row 3, every
// entry)]. Partial record per (b, c): [u(S) | sum g | sum g^2].
// ---------------------------------------------------------------------------
template <int MODE, bool MASKED, bool VEC16>
__global__ void __launch_bounds__(kRoundThreads, 4)
filter_round_kernel(const float* __restrict__ x, const unsigned char* __restrict__ valid,
                    const float* __restrict__ m0, const float* __restrict__ carry,
                    float* __restrict__ r, const float* __restrict__ mf_in,
                    float* __restrict__ mf_out, float* __restrict__ partial, int H, int W, int S,
                    int step, RoundGeom geom, int nchunks, float cov_scale) {
  extern __shared__ __align__(16) unsigned char round_smem[];
  const int TR = geom.tile_rows, CW = geom.tile_cols, RP = cube_row_pitch(CW, S);
  const int tile_floats = TR * RP;
  const RoundSmem sm = carve_round_smem(round_smem, geom.stages, 4 * tile_floats);
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t % 32;
  const float* cb = carry + (long long)b * 4 * S;
  load_round_consts<false>(sm, cb, m0 + (long long)b * S, S);
  const float norm = cb[3 * S];

  const long long P = (long long)H * step;
  const int nseg = (step + CW - 1) / CW;
  const int tiles_block = (H + TR - 1) / TR * nseg;
  const int t_beg = c * geom.tiles_per_chunk;
  const int ntile = min(tiles_block, t_beg + geom.tiles_per_chunk) - t_beg;
  const int ncols_b = MASKED ? min(step, W - b * step) : step;  // columns below W
  const int tr = t / CW, tc = t - tr * CW;  // this thread's pixel in every tile
  const bool has_px = t < TR * CW;
  int uoff[kRoundThreads / 32];  // the u phase's pixels lane + 32 j in a tile
#pragma unroll
  for (int j = 0; j < kRoundThreads / 32; ++j) {
    const int pl = lane + 32 * j;
    uoff[j] = (pl / CW) * RP + (pl % CW) * S;
  }

  struct Tile {
    int h0, nrows, col0, ncols, nload;  // rows, columns in the block, columns read
  };
  auto tile_at = [&](int i) {
    const int tile = t_beg + i, grp = tile / nseg, seg = tile - grp * nseg;
    Tile tl;
    tl.h0 = grp * TR;
    tl.nrows = min(TR, H - tl.h0);
    tl.col0 = seg * CW;
    tl.ncols = min(CW, step - tl.col0);
    tl.nload = max(0, min(tl.ncols, ncols_b - tl.col0));
    return tl;
  };

  auto issue = [&](int i) {
    if (i < ntile) {
      const Tile tl = tile_at(i);
      const int slot = i % geom.stages, n = tl.nload * S;
      float* dst = reinterpret_cast<float*>(sm.tiles) + slot * tile_floats;
      for (int rr = 0; rr < tl.nrows; ++rr) {
        const float* src = x + ((long long)(tl.h0 + rr) * W + b * step + tl.col0) * S;
        float* d = dst + rr * RP;
        if constexpr (VEC16) {
          for (int e = t; 4 * e < n; e += kRoundThreads) cp_async16(d + 4 * e, src + 4 * e);
        } else {
          for (int e = t; e < n; e += kRoundThreads) cp_async4(d + e, src + e);
        }
      }
      if (has_px && tr < tl.nrows && tc < tl.ncols) {
        const int h = tl.h0 + tr;
        const unsigned char* mask = nullptr;
        if (MASKED && tc < tl.nload) mask = valid + (long long)h * W + b * step + tl.col0 + tc;
        issue_pixel<MODE, MASKED>(sm, slot, b * P + (long long)h * step + tl.col0 + tc, r,
                                  mf_in, mask);
      }
    }
    cp_async_commit();
  };

  float u[kBandSlots];
#pragma unroll
  for (int k = 0; k < kBandSlots; ++k) u[k] = 0.f;
  float gsum = 0.f, gsq = 0.f;

  for (int i = 0; i < geom.stages - 1; ++i) issue(i);
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait_pending(geom.stages - 2);
    __syncthreads();  // tile i staged by every thread; tile i - 1's stage free
    issue(i + geom.stages - 1);
    const Tile tl = tile_at(i);
    const int slot = i % geom.stages;
    const float* tile = reinterpret_cast<const float*>(sm.tiles) + slot * tile_floats;
    const bool in = has_px && tr < tl.nrows && tc < tl.ncols;
    bool ok = in && tc < tl.nload;
    if constexpr (MASKED) ok = ok && mask_set(sm, slot);
    float proj = 0.f, q = 0.f;
    if (ok) {
      const float* px = tile + tr * RP + tc * S;
      project<MODE == kFirst, true>(sm, S, [&](int s) { return px[s]; }, proj, q);
    }
    float ru, mf;
    pixel_update<MODE>(sm, slot * kRoundThreads + t, ok, proj, q, norm, ru, mf);
    if (in) {
      const long long i_px = b * P + (long long)(tl.h0 + tr) * step + tl.col0 + tc;
      if (MODE == kFirst) r[i_px] = ru;
      mf_out[i_px] = MODE == kFinal ? mf * kScaling : mf;
    }
    if (MODE == kFinal) continue;
    const float g = cov_scale * (ru * mf);  // 0 where the pixel does not count
    gsum += g;
    gsq = fmaf(g, g, gsq);
    sm.g[t] = g;
    sm.ok[t] = ok;
    __syncthreads();
    accumulate_u<true>(sm, S, [&](int s, int j) { return tile[uoff[j] + s]; }, u);
  }
  cp_async_wait_pending(0);
  if (MODE == kFinal) return;
  write_round_record(sm, partial + ((long long)b * nchunks + c) * (S + 2), u, gsum, gsq, S);
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
template <typename T, int MODE, bool MASKED, bool BF16_DOTS, bool CENTER, bool VEC16>
__global__ void __launch_bounds__(kRoundThreads, 4)
filter_round_bsp_kernel(const T* __restrict__ xs, const unsigned char* __restrict__ valid,
                        const float* __restrict__ m0, const float* __restrict__ carry,
                        float* __restrict__ r, const float* __restrict__ mf_in,
                        float* __restrict__ mf_out, float* __restrict__ partial, int W, int S,
                        int R, int step, int P, RoundGeom geom, int nchunks, float cov_scale) {
  round_bsp_chunk<T, MODE, MASKED, BF16_DOTS, CENTER, VEC16>(
      xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S, R, step, P, geom, nchunks,
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

template <bool MASKED, bool VEC16>
cudaError_t launch_round_mode(int mode, dim3 grid, const RoundGeom& g, cudaStream_t st,
                              const float* x, const unsigned char* valid, const float* m0,
                              const float* carry, float* r, const float* mf_in, float* mf_out,
                              float* partial, int H, int W, int S, int step, int nchunks,
                              float cov_scale) {
#define STARCOP_ROUND(MODE)                                                                     \
  return launch_round_kernel(filter_round_kernel<MODE, MASKED, VEC16>, grid, g, st, x, valid, m0, \
                             carry, r, mf_in, mf_out, partial, H, W, S, step, g, nchunks,       \
                             cov_scale)
  if (mode == kFirst) STARCOP_ROUND(kFirst);
  if (mode == kLoop) STARCOP_ROUND(kLoop);
  STARCOP_ROUND(kFinal);
#undef STARCOP_ROUND
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

template <typename T, bool MASKED, bool BF16_DOTS, bool CENTER, bool VEC16>
cudaError_t launch_round_bsp_vec(int mode, const T* xs, const unsigned char* valid,
                                 const float* m0, const float* carry, float* r,
                                 const float* mf_in, float* mf_out, float* partial, int W, int S,
                                 int R, int step, int P, const RoundGeom& g, int nchunks, int nb,
                                 float cov_scale, cudaStream_t st) {
  const dim3 grid(nchunks, nb);
#define STARCOP_ROUND_BSP(MODE)                                                                   \
  return launch_round_kernel(filter_round_bsp_kernel<T, MODE, MASKED, BF16_DOTS, CENTER, VEC16>, \
                             grid, g, st, xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S,  \
                             R, step, P, g, nchunks, cov_scale)
  if (mode == kFirst) STARCOP_ROUND_BSP(kFirst);
  if (mode == kLoop) STARCOP_ROUND_BSP(kLoop);
  STARCOP_ROUND_BSP(kFinal);
#undef STARCOP_ROUND_BSP
}

template <typename T, bool MASKED, bool BF16_DOTS, bool CENTER>
cudaError_t launch_round_bsp(int mode, const void* xs_raw, const unsigned char* valid,
                             const float* m0, const float* carry, float* r, const float* mf_in,
                             float* mf_out, float* partial, int W, int S, int R, int step, int P,
                             const RoundGeom& g, int nchunks, int nb, float cov_scale,
                             cudaStream_t st) {
  const T* xs = static_cast<const T*>(xs_raw);
  if (!stream_geom_ok<T>(g, xs, S, P, nchunks)) return cudaErrorInvalidValue;
  if (g.aligned)
    return launch_round_bsp_vec<T, MASKED, BF16_DOTS, CENTER, true>(
        mode, xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S, R, step, P, g, nchunks, nb,
        cov_scale, st);
  return launch_round_bsp_vec<T, MASKED, BF16_DOTS, CENTER, false>(
      mode, xs, valid, m0, carry, r, mf_in, mf_out, partial, W, S, R, step, P, g, nchunks, nb,
      cov_scale, st);
}

}  // namespace

extern "C" {

// Largest band count the kernels take (kMaxBands).
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
// and g to bf16; center (f32 only) subtracts m0 from the raw stream. geom:
// the six RoundGeom fields; partial has nchunks records per block.
int starcop_filter_round_bsp(int mode, const void* xs, int f32, const unsigned char* valid,
                             int bf16_dots, int center, const float* m0, const float* carry,
                             float* r, const float* mf_in, float* mf_out, float* partial, int H,
                             int W, int S, int R, int nb, int step, const int* geom, int nchunks,
                             float cov_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kFirst || mode > kFinal || S < 1 || S > kMaxBands || R < S)
    return (int)cudaErrorInvalidValue;
  if ((f32 && bf16_dots) || (!f32 && center) || (valid != nullptr && center))
    return (int)cudaErrorInvalidValue;
  const int P = H * step;
  const RoundGeom g = round_geom_from(geom);
#define STARCOP_ROUND_BSP(T, MASKED, DOTS, CENTER)                                              \
  return (int)launch_round_bsp<T, MASKED, DOTS, CENTER>(mode, xs, valid, m0, carry, r, mf_in,  \
                                                        mf_out, partial, W, S, R, step, P, g,   \
                                                        nchunks, nb, cov_scale, st)
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

// valid == nullptr: filter_round; else filter_round_masked. geom: the six
// RoundGeom fields; partial has nchunks records per block.
int starcop_filter_round(int mode, const float* x, const unsigned char* valid, const float* m0,
                         const float* carry, float* r, const float* mf_in, float* mf_out,
                         float* partial, int H, int W, int S, int nb, int step, const int* geom,
                         int nchunks, float cov_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RoundGeom g = round_geom_from(geom);
  if (mode < kFirst || mode > kFinal || S < 1 || S > kMaxBands) return (int)cudaErrorInvalidValue;
  // Tiles of whole block rows, or one segment of a row wider than a tile.
  const bool shape_ok = g.tile_cols <= step && (g.tile_rows == 1 || g.tile_cols == step);
  const int tiles_block = (H + g.tile_rows - 1) / g.tile_rows * ((step + g.tile_cols - 1) / g.tile_cols);
  if (!shape_ok || !round_geom_ok(g, tiles_block, nchunks, 4 * g.tile_rows * cube_row_pitch(g.tile_cols, S)))
    return (int)cudaErrorInvalidValue;
  if (g.aligned && ((long long)W * S % 4 != 0 || (long long)step * S % 4 != 0 ||
                    reinterpret_cast<size_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nchunks, nb);
  cudaError_t err;
  if (valid != nullptr)
    err = g.aligned ? launch_round_mode<true, true>(mode, grid, g, st, x, valid, m0, carry, r, mf_in, mf_out, partial, H, W, S, step, nchunks, cov_scale)
                    : launch_round_mode<true, false>(mode, grid, g, st, x, valid, m0, carry, r, mf_in, mf_out, partial, H, W, S, step, nchunks, cov_scale);
  else
    err = g.aligned ? launch_round_mode<false, true>(mode, grid, g, st, x, valid, m0, carry, r, mf_in, mf_out, partial, H, W, S, step, nchunks, cov_scale)
                    : launch_round_mode<false, false>(mode, grid, g, st, x, valid, m0, carry, r, mf_in, mf_out, partial, H, W, S, step, nchunks, cov_scale);
  return (int)err;
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
