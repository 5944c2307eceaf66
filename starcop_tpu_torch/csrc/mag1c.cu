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

// ---------------------------------------------------------------------------
// init_stats / init_stats_masked, pass 1: the partial record [n | mean | tri]
// (mag1c_common.cuh) of each (chunk, block) of the (H, W, S) cube, by Chan's
// pairwise fold one tile at a time. Masked, n is the VALID count.
//
// What bounds it: one read of the cube (4 H W S bytes) against the scatter's
// S (S + 1) / 2 FMAs per pixel; at S = 50 the two take about the same time on
// the H100 (~0.1 ms at 1280 x 1242), so the design keeps both the bytes in
// flight and the FMA pipes fed. On the card the on-chip work (sweep,
// scatter, barriers) sets its time (PERF.md §6):
//  * Tiles and chunks as the rounds': a tile is whole rows of block b (or a
//    segment of a row wider than kRoundThreads pixels), each tile row
//    tile_cols * S contiguous floats, so no pixel needs p / step; a CTA owns
//    tiles_per_chunk consecutive tiles, the chunk count chosen in Python
//    (ops/mag1c_kernels.py:stats_geometry) for full waves at
//    kStatsCtasPerSm CTAs per SM; the kernel checks the geometry.
//  * A ring of 2-4 tiles filled by cp.async (16-byte copies where every tile
//    row starts and ends on 16 bytes, else 4-byte ones), each pixel's mask
//    word in the same commit group. Columns past W are neither copied nor
//    read, and a pixel that does not count is selected out before its values
//    are read: the fill -9999 and NaN never reach a sum.
//  * Two barriers a tile, and the shared scatter ("Tile statistics" in
//    mag1c_common.cuh): the tile is centred on the running mean in the pass
//    that also sums it: thread t takes a unit of 2 bands (1 where S is odd)
//    of every (kThreads / units)-th pixel, restages it as x - mean at SPP =
//    8 ceil(S / 8) floats a pixel (0 where the pixel does not count; pad
//    bands stay 0) and keeps its sums; the barrier after it counts the
//    tile's valid pixels (__syncthreads_count). Then threads t < S form d and
//    the new mean while every thread scatters; the rank-1 term waits for the
//    next tile's first phase. A chunk's first tile with valid pixels is
//    centred on its own mean (one more pass and barrier), so no tile is
//    summed about 0. The 8 x 8 micro-tiles (S = 50: 28, 1,792 FMAs a pixel;
//    4 x 8 tiles waste fewer FMAs but read a third more shared memory per
//    FMA, and measured slower).
//  * f32 values and FMAs; the chunk records are combined in f64 by
//    init_stats_reduce_kernel (a plain f32 covariance drifts the 30-iteration
//    filter; PERF.md, "f32 conditioning"). No TF32, no tensor cores.
// ---------------------------------------------------------------------------
// Floats of one pixel of the centred tile.
__host__ __device__ inline int stats_pixel_pitch(int S) { return (S + 7) / 8 * 8; }

// The kernel's static shared memory.
struct StatsScratch {
  float psum[2 * kThreads];        // the sweep's sums, [pixel group][band unit][2]
  float delta[kMaxBands], mean[kMaxBands];
  int poff[kRoundThreads], pcol[kRoundThreads];  // pixel offsets and columns in a tile
};
static_assert(sizeof(StatsScratch) == 4096, "ops/mag1c_kernels.py:STATS_STATIC_SMEM");

// Dynamic shared memory of a statistics CTA: the ring (stages x [tile | mask
// words | mask positions]) and the centred tile, or the group sums at the
// chunk's end where those need more.
inline size_t stats_smem_bytes(int stages, int tile_bytes, int S) {
  const size_t ring = (size_t)stages * (tile_bytes + 5 * kRoundThreads) +
                      (size_t)4 * kRoundThreads * stats_pixel_pitch(S);
  const size_t groups = stats_group_bytes(S);
  return ring > groups ? ring : groups;
}

inline bool stats_geom_ok(const RoundGeom& g, int tiles_block, int nchunks, int tile_bytes,
                          int S) {
  return tiling_ok(g, tiles_block, nchunks) &&
         (size_t)g.smem == stats_smem_bytes(g.stages, tile_bytes, S) &&
         g.smem + sizeof(StatsScratch) <= (size_t)kMaxRoundSmem;
}

template <bool MASKED, bool VEC16>
__global__ void __launch_bounds__(kThreads, kStatsCtasPerSm)
init_stats_partial_kernel(const float* __restrict__ x, const unsigned char* __restrict__ valid,
                          float* __restrict__ partial, int H, int W, int S, int step,
                          RoundGeom geom, int nchunks) {
  extern __shared__ __align__(16) unsigned char stats_smem[];
  __shared__ StatsScratch sc;
  const int TR = geom.tile_rows, CW = geom.tile_cols, RP = cube_row_pitch(CW, S);
  const int tile_floats = TR * RP, TP = TR * CW;
  const int SPP = stats_pixel_pitch(S), nr = SPP / 8;
  auto spos = [&](int s) { return stats_spos(s, nr); };
  const int G = stats_groups(S);
  float* ring = reinterpret_cast<float*>(stats_smem);
  unsigned* mword = reinterpret_cast<unsigned*>(ring + geom.stages * tile_floats);
  unsigned char* mpos = reinterpret_cast<unsigned char*>(mword + geom.stages * kRoundThreads);
  float* ctile = reinterpret_cast<float*>(mpos + geom.stages * kRoundThreads);
  const float4* ctile4 = reinterpret_cast<const float4*>(ctile);
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;

  const int nseg = (step + CW - 1) / CW;
  const int tiles_block = (H + TR - 1) / TR * nseg;
  const int t_beg = c * geom.tiles_per_chunk;
  const int ntile = min(tiles_block, t_beg + geom.tiles_per_chunk) - t_beg;
  const int ncols_b = MASKED ? min(step, W - b * step) : step;  // columns below W
  const int tr = t / CW, tc = t - tr * CW;  // this thread's pixel in every tile (t < TP)

  const ScatterRole sr = scatter_role(S);
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  if (t < TP) {
    sc.poff[t] = tr * RP + tc * S;
    sc.pcol[t] = tc;
  }
  if (t < kMaxBands) sc.mean[t] = sc.delta[t] = 0.f;  // pad bands keep delta = 0
  for (int e = t; e < kRoundThreads * (SPP - S); e += kThreads)  // the sweeps leave pad bands 0
    ctile[e / (SPP - S) * SPP + spos(S + e % (SPP - S))] = 0.f;

  struct Tile {
    int h0, nrows, col0, nload;  // first row, rows, first column, columns read
  };
  auto tile_at = [&](int i) {
    const int tile = t_beg + i, grp = tile / nseg, seg = tile - grp * nseg;
    Tile tl;
    tl.h0 = grp * TR;
    tl.nrows = min(TR, H - tl.h0);
    tl.col0 = seg * CW;
    tl.nload = max(0, min(min(CW, step - tl.col0), ncols_b - tl.col0));
    return tl;
  };

  auto issue = [&](int i) {
    if (i < ntile) {
      const Tile tl = tile_at(i);
      const int slot = i % geom.stages, n = tl.nload * S;
      float* dst = ring + slot * tile_floats;
      for (int rr = 0; rr < tl.nrows; ++rr) {
        const float* src = x + ((long long)(tl.h0 + rr) * W + b * step + tl.col0) * S;
        float* d = dst + rr * RP;
        if constexpr (VEC16) {
          for (int e = t; 4 * e < n; e += kThreads) cp_async16(d + 4 * e, src + 4 * e);
        } else {
          for (int e = t; e < n; e += kThreads) cp_async4(d + e, src + e);
        }
      }
      if constexpr (MASKED) {
        if (t < TP) {
          // The aligned word that holds the byte lies in the mask's allocation.
          unsigned char pos = 4;  // 4: the pixel is outside the tile or past W
          if (tr < tl.nrows && tc < tl.nload) {
            const size_t a = reinterpret_cast<size_t>(
                valid + (long long)(tl.h0 + tr) * W + b * step + tl.col0 + tc);
            pos = (unsigned char)(a & 3);
            cp_async4(mword + slot * kRoundThreads + t,
                      reinterpret_cast<const void*>(a & ~(size_t)3));
          }
          mpos[slot * kRoundThreads + t] = pos;
        }
      }
    }
    cp_async_commit();
  };

  // Thread t over band unit u = t % NU (VW bands: 2 where S is even, else
  // 1) of the tile's pixels q, q + NQ, ... (q = t / NU < NQ): its sum of
  // (x - shift) over the pixels that count; with out, the centred values
  // (0 where a pixel does not count) restaged there. Returns whether this
  // thread's own pixel t counts (for the count barrier).
  const int VW = S % 2 == 0 ? 2 : 1, NU = S / VW, NQ = kThreads / NU;
  const int su = t % NU, sq = t / NU;
  auto pixel_counts = [&](int slot, int pl, int nload) {
    if constexpr (MASKED) {
      const unsigned pos = mpos[slot * kRoundThreads + pl];
      return pos < 4 && ((mword[slot * kRoundThreads + pl] >> (8 * pos)) & 0xffu) != 0;
    } else {
      return sc.pcol[pl] < nload;
    }
  };
  auto sweep = [&](const float* raw, int slot, int npx, int nload, float* out) {
    float p0 = 0.f, p1 = 0.f;
    if (sq < NQ) {
      if (VW == 2) {
        const float k0 = sc.mean[2 * su], k1 = sc.mean[2 * su + 1];
        for (int pl = sq; pl < npx; pl += NQ) {
          const bool counts = pixel_counts(slot, pl, nload);
          const float2 v = *reinterpret_cast<const float2*>(raw + sc.poff[pl] + 2 * su);
          const float v0 = counts ? v.x - k0 : 0.f, v1 = counts ? v.y - k1 : 0.f;
          if (out != nullptr)
            *reinterpret_cast<float2*>(out + pl * SPP + spos(2 * su)) = make_float2(v0, v1);
          p0 += v0;
          p1 += v1;
        }
      } else {
        const float k0 = sc.mean[su];
        for (int pl = sq; pl < npx; pl += NQ) {
          const bool counts = pixel_counts(slot, pl, nload);
          const float v0 = counts ? raw[sc.poff[pl] + su] - k0 : 0.f;
          if (out != nullptr) out[pl * SPP + spos(su)] = v0;
          p0 += v0;
        }
      }
    }
    sc.psum[2 * t] = p0;  // [q][u][VW] flat
    sc.psum[2 * t + 1] = p1;
    return t < npx && pixel_counts(slot, t, nload);
  };
  auto band_sum = [&](int s) {
    const int u = s / VW, e = s - u * VW;
    float v = 0.f;
    for (int q = 0; q < NQ; ++q) v += sc.psum[2 * (q * NU + u) + e];
    return v;
  };

  int n_run = 0;
  float coef = 0.f;  // the rank-1 term still to fold
  for (int i = 0; i < geom.stages - 1; ++i) issue(i);
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait_pending(geom.stages - 2);
    __syncthreads();  // tile i staged; tile i - 1's stage, ctile and psum free; d, mean set
    issue(i + geom.stages - 1);
    fold_rank1(coef, sc.delta, sr, acc);
    coef = 0.f;
    const Tile tl = tile_at(i);
    const int slot = i % geom.stages, npx = tl.nrows * CW;
    const float* raw = ring + slot * tile_floats;
    if (n_run == 0) {  // uniform: the first tile with valid pixels centres on its own mean
      const int n0 = __syncthreads_count(sweep(raw, slot, npx, tl.nload, nullptr));
      if (t < S) sc.mean[t] = n0 > 0 ? band_sum(t) / (float)n0 : 0.f;
      __syncthreads();
      if (n0 == 0) continue;
    }
    const int n_t = __syncthreads_count(sweep(raw, slot, npx, tl.nload, ctile));
    if (n_t == 0) continue;  // uniform across the CTA
    const float n_new = (float)(n_run + n_t);
    if (t < S) {
      const float d = band_sum(t) / (float)n_t;
      sc.delta[t] = d;
      sc.mean[t] += d * ((float)n_t / n_new);
    }
    coef = -(float)n_t * ((float)n_t / n_new);
    scatter_pixels(ctile4, SPP / 4, nr, npx, G, sr, acc);
    n_run += n_t;
  }
  cp_async_wait_pending(0);
  __syncthreads();  // the last d is set; the ring is free
  fold_rank1(coef, sc.delta, sr, acc);
  write_scatter_record(partial + ((long long)b * nchunks + c) * stats_record_len(S),
                       reinterpret_cast<float*>(stats_smem), n_run, sc.mean, sr, S, acc);
}

// ---------------------------------------------------------------------------
// init_stats_bsp / init_stats_stream, pass 1: stream_stats_chunk
// (mag1c_common.cuh) on the blocked stream (nb, R, P) over its first S rows.
//   bf16 (init_stats_bsp): kSecondMoment, the raw second moment of the
//     centred, masked stream (the XLA statistics :1814-1824).
//   float (init_stats_stream, _init_stats_kernel :1164): kMeanFold, the mean
//     and centred scatter of the raw f32 stream, every pixel valid.
// ---------------------------------------------------------------------------
template <typename T, bool VEC16>
__global__ void __launch_bounds__(kThreads, kStatsCtasPerSm)
stream_stats_partial_kernel(const T* __restrict__ xs, float* __restrict__ partial, int S, int R,
                            int P, RoundGeom geom, int nchunks) {
  stream_stats_chunk<T, sizeof(T) == 2 ? kSecondMoment : kMeanFold, VEC16>(
      xs, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, partial, false, S, R, P, geom,
      nchunks, 0.f);
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
// blocked_transpose / its masked form: the (H, W, S) f32 cube -> the centred
// bf16 stream (nb, R, P), out[b, s, h*step + j] = bf16_rn(x[h, b*step + j, s]
// - m0[b, s]) (an f32 subtract, then round to nearest even), rows S..R-1 +0.
// MASKED: +0 wherever the (H, W) uint8 mask is unset or the column is >= W,
// selected, never multiplied (the fill -9999 and NaN never reach the stream).
//
// What bounds it: one read of the cube and one write of the stream (4 + 2
// bytes per live value), no arithmetic to speak of. The design keeps the
// bytes in flight and every on-chip step cheap:
//  * Tiles of whole block rows (tile_rows x step pixels, or one segment of
//    tile_cols pixels of a row wider than a tile): a tile is one contiguous
//    p-range of the output, p0 .. p0 + npx, and each of its rows one run of
//    tile_cols * S contiguous floats of the cube, staged pixel-major at S
//    floats a pixel, so tile pixel q sits at q * S and no element needs a
//    divide. The rows per tile make the pixel span a multiple of 16 (whole
//    32-byte sectors of the output) where such a tile fits, else of 8 (16
//    bytes; step 54), P a multiple of 8; at least 128 pixels where they fit.
//  * A CTA owns tiles_per_chunk consecutive tiles of one block in a ring of
//    2-4 stages filled by cp.async (16-byte copies where every tile row
//    starts and ends on 16 bytes, else 4-byte ones; masked, each pixel's
//    mask word in the same commit group), so the next tiles' bytes are in
//    flight while the CTA converts and writes the current one. Columns past
//    W are neither copied nor read. Geometry: ops/mag1c_kernels.py:
//    transpose_geometry, checked here against the shapes.
//  * m0 of block b staged once per CTA in shared memory.
//  * Wide stores: a warp task is G groups of 8 consecutive pixels x BS =
//    32 / G bands; each lane converts its group of one band and stores 16
//    bytes (4-byte pairs or 2 bytes at a ragged or unaligned edge), the
//    task's G groups on 16 G bytes of the output, so a warp store fills
//    whole 32-byte sectors even in a tile that starts mid-sector (step 54).
//    Lane (gi, si) reads bank 8 gi S + si (mod 32): conflict-free with BS =
//    16 where S = 2 mod 4 (S = 50) and BS = 8 where S is odd, 2-way where
//    S = 0 mod 4. Pad rows are lanes that store zeros. Masked, the group's 8
//    keep bits come from one ballot of lanes si < 8 over their pixels' mask
//    words.
// ---------------------------------------------------------------------------
// Two values rounded to bf16 (nearest even), lo at the lower address.
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Dynamic shared memory of one ring stage: the tile (16-byte rounded), then
// each pixel's mask word and the byte's position in it (4: not copied).
__host__ __device__ inline int transpose_tile_bytes(int pixels, int S) {
  return (pixels * S + 3) / 4 * 16;
}
__host__ __device__ inline int transpose_stage_bytes(int pixels, int S) {
  return transpose_tile_bytes(pixels, S) + (5 * pixels + 15) / 16 * 16;
}

template <bool MASKED, bool VEC16>
__global__ void __launch_bounds__(kThreads, kStatsCtasPerSm)
blocked_transpose_kernel(const float* __restrict__ x, const float* __restrict__ m0,
                         const unsigned char* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                         int H, int W, int S, int R, int step, RoundGeom geom) {
  extern __shared__ __align__(16) unsigned char tr_smem[];
  __shared__ float m0s[kMaxBands];
  const int TR = geom.tile_rows, CW = geom.tile_cols, TP = TR * CW;
  const int stage_bytes = transpose_stage_bytes(TP, S), tile_bytes = transpose_tile_bytes(TP, S);
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long P = (long long)H * step;
  const int nseg = (step + CW - 1) / CW;
  const int tiles_block = (H + TR - 1) / TR * nseg;
  const int t_beg = c * geom.tiles_per_chunk;
  const int ntile = min(tiles_block, t_beg + geom.tiles_per_chunk) - t_beg;
  const int ncols_b = MASKED ? min(step, W - b * step) : step;  // columns below W
  for (int s = t; s < S; s += kThreads) m0s[s] = m0[(long long)b * S + s];

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
      unsigned char* st = tr_smem + (size_t)(i % geom.stages) * stage_bytes;
      const int n = tl.nload * S;
      for (int rr = 0; rr < tl.nrows; ++rr) {
        const float* src = x + ((long long)(tl.h0 + rr) * W + b * step + tl.col0) * S;
        float* d = reinterpret_cast<float*>(st) + rr * CW * S;
        if constexpr (VEC16) {
          for (int e = t; 4 * e < n; e += kThreads) cp_async16(d + 4 * e, src + 4 * e);
        } else {
          for (int e = t; e < n; e += kThreads) cp_async4(d + e, src + e);
        }
      }
      if constexpr (MASKED) {
        unsigned* mword = reinterpret_cast<unsigned*>(st + tile_bytes);
        unsigned char* mpos = reinterpret_cast<unsigned char*>(mword + TP);
        for (int q = t; q < TP; q += kThreads) {
          const int rr = q / CW, cq = q - rr * CW;
          unsigned char pos = 4;
          if (rr < tl.nrows && cq < tl.nload) {
            // The aligned word that holds the byte lies in the mask's allocation.
            const size_t a = reinterpret_cast<size_t>(
                valid + (long long)(tl.h0 + rr) * W + b * step + tl.col0 + cq);
            pos = (unsigned char)(a & 3);
            cp_async4(mword + q, reinterpret_cast<const void*>(a & ~(size_t)3));
          }
          mpos[q] = pos;
        }
      }
    }
    cp_async_commit();
  };

  const int BS = (S & 1) ? 8 : 16, G = 32 / BS;  // bands and 8-pixel groups of a warp task
  const int si = lane % BS, gi = lane / BS;
  const int nbb = (R + BS - 1) / BS;
  const bool out16 = reinterpret_cast<size_t>(out) % 16 == 0 && P % 8 == 0;

  for (int i = 0; i < geom.stages - 1; ++i) issue(i);
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait_pending(geom.stages - 2);
    __syncthreads();  // tile i staged by every thread; tile i - 1's stage free; m0s set
    issue(i + geom.stages - 1);
    const Tile tl = tile_at(i);
    const unsigned char* st = tr_smem + (size_t)(i % geom.stages) * stage_bytes;
    const float* tile = reinterpret_cast<const float*>(st);
    const unsigned* mword = reinterpret_cast<const unsigned*>(st + tile_bytes);
    const unsigned char* mpos = reinterpret_cast<const unsigned char*>(mword + TP);
    const int npx = tl.nrows * tl.ncols;
    const long long p0 = (long long)tl.h0 * step + tl.col0;
    const bool vec = out16 && p0 % 8 == 0;  // every full group's 8 values on 16 bytes
    // A task's G groups start on 16 G bytes of the output where vec: the
    // first task of the tile leaves its first (p0 / 8) % G lanes' groups out,
    // so no warp store splits a 32-byte sector that another task completes.
    const int gshift = vec ? (int)(p0 / 8 % G) : 0;
    const int ntask = nbb * ((npx + 8 * (G + gshift) - 1) / (8 * G));
    int sb = warp, gb = 0;  // task = gb * nbb + sb, advanced by kWarps
    while (sb >= nbb) sb -= nbb, ++gb;
    for (int task = warp; task < ntask; task += kWarps) {
      const int s = sb * BS + si, q = (gb * G + gi - gshift) * 8;
      sb += kWarps;
      while (sb >= nbb) sb -= nbb, ++gb;
      unsigned keep = 0xffu;
      if constexpr (MASKED) {
        bool k = false;
        if (si < 8 && q >= 0 && q + si < npx) {
          const unsigned pos = mpos[q + si];
          k = pos < 4 && ((mword[q + si] >> (8 * pos)) & 0xffu) != 0;
        }
        keep = (__ballot_sync(0xffffffffu, k) >> (gi * BS)) & 0xffu;
      }
      if (s >= R || q < 0 || q >= npx) continue;
      const int n = min(8, npx - q);
      float v[8];
      if (s < S) {
        const float m = m0s[s];
        const float* px = tile + q * S + s;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xv = e < n ? px[e * S] : 0.f;
          v[e] = (keep >> e) & 1u ? __fsub_rn(xv, m) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      __nv_bfloat16* dst = out + ((long long)b * R + s) * P + p0 + q;
      if (vec && n == 8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                                                    bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
      } else {  // a ragged or unaligned group: 4-byte pairs where aligned, else 2 bytes
        const bool pairs = reinterpret_cast<size_t>(dst) % 4 == 0;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          if (pairs && e + 1 < n) {
            *reinterpret_cast<unsigned*>(dst + e) = bf16x2_bits(v[e], v[e + 1]);
          } else {
            if (e < n) dst[e] = __float2bfloat16_rn(v[e]);
            if (e + 1 < n) dst[e + 1] = __float2bfloat16_rn(v[e + 1]);
          }
        }
      }
    }
  }
  cp_async_wait_pending(0);
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
// of that block (nin[b]: the valid count clamped to >= 1, or H*step unmasked),
// on glue_smem_bytes(S) of dynamic shared memory (GlueSmem, then K0).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kGlueThreads)
filter_glue_kernel(const float* __restrict__ partial, const float* __restrict__ carry_in,
                   float* __restrict__ carry_out, const float* __restrict__ m0,
                   const float* __restrict__ tmpl, const float* __restrict__ k0_all,
                   const float* __restrict__ nin_all, int S, int nchunks, float alpha) {
  extern __shared__ __align__(16) unsigned char glue_smem[];
  GlueSmem& g = *reinterpret_cast<GlueSmem*>(glue_smem);
  const int b = blockIdx.x;
  glue_block(partial + (long long)b * nchunks * (S + 2), nchunks, carry_in + (long long)b * 4 * S,
             carry_out + (long long)b * 4 * S, m0 + (long long)b * S, tmpl,
             k0_all + (long long)b * S * S, nin_all[b], S, alpha, g,
             reinterpret_cast<float*>(glue_smem + sizeof(GlueSmem)));
}

template <bool MASKED, bool VEC16>
cudaError_t launch_init_partial(const float* x, const unsigned char* valid, float* partial,
                                int H, int W, int S, int step, const RoundGeom& g, int nchunks,
                                int nb, cudaStream_t st) {
  return launch_round_kernel<kThreads>(init_stats_partial_kernel<MASKED, VEC16>, dim3(nchunks, nb),
                                       g, st, x, valid, partial, H, W, S, step, g, nchunks);
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

// Pass 1 of init_stats_bsp (bf16) or init_stats_stream (f32) with the
// geometry of stream_stats_geometry.
template <typename T>
cudaError_t launch_stream_stats(const void* xs_raw, float* partial, int S, int R, int P,
                                const RoundGeom& g, int nchunks, int nb, cudaStream_t st) {
  const T* xs = static_cast<const T*>(xs_raw);
  if (S < 1 || S > kMaxBands || S > R || !stream_stats_geom_ok<T>(g, xs, S, P, nchunks, false))
    return cudaErrorInvalidValue;
  const dim3 grid(nchunks, nb);
  if (g.aligned)
    return launch_round_kernel<kThreads>(stream_stats_partial_kernel<T, true>, grid, g, st, xs,
                                         partial, S, R, P, g, nchunks);
  return launch_round_kernel<kThreads>(stream_stats_partial_kernel<T, false>, grid, g, st, xs,
                                       partial, S, R, P, g, nchunks);
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
// geom: the six RoundGeom fields of stats_geometry; partial has nchunks
// records per block.
int starcop_init_stats(const float* x, const unsigned char* valid, float* partial, float* m0,
                       float* c0, int H, int W, int S, int nb, int step, const int* geom,
                       int nchunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RoundGeom g = round_geom_from(geom);
  if (S < 1 || S > kMaxBands) return (int)cudaErrorInvalidValue;
  // Tiles of whole block rows, or one segment of a row wider than a tile.
  const bool shape_ok = g.tile_cols <= step && (g.tile_rows == 1 || g.tile_cols == step);
  const int tiles_block = (H + g.tile_rows - 1) / g.tile_rows * ((step + g.tile_cols - 1) / g.tile_cols);
  if (!shape_ok || !stats_geom_ok(g, tiles_block, nchunks, 4 * g.tile_rows * cube_row_pitch(g.tile_cols, S), S))
    return (int)cudaErrorInvalidValue;
  if (g.aligned && ((long long)W * S % 4 != 0 || (long long)step * S % 4 != 0 ||
                    reinterpret_cast<size_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
#define STARCOP_INIT(MASKED, VEC16) \
  launch_init_partial<MASKED, VEC16>(x, valid, partial, H, W, S, step, g, nchunks, nb, st)
  cudaError_t err;
  if (valid != nullptr)
    err = g.aligned ? STARCOP_INIT(true, true) : STARCOP_INIT(true, false);
  else
    err = g.aligned ? STARCOP_INIT(false, true) : STARCOP_INIT(false, false);
#undef STARCOP_INIT
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partial, nullptr, m0, c0, S, nchunks, nb, st);
}

// The (H, W, S) f32 cube -> the bf16 stream (nb, R, P) centred by m0
// (nb, S); valid (H, W) masks when given. geom: the six RoundGeom fields of
// transpose_geometry (tiles of tile_rows whole block rows, or one segment of
// tile_cols columns of a row wider than a tile; the chunk count follows).
int starcop_blocked_transpose(const float* x, const float* m0, const unsigned char* valid,
                              void* out, int H, int W, int S, int R, int nb, int step,
                              const int* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RoundGeom g = round_geom_from(geom);
  if (S < 1 || S > kMaxBands || R < S || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const bool shape_ok = g.tile_rows >= 1 && g.tile_cols >= 1 && g.tile_cols <= step &&
                        (g.tile_rows == 1 || g.tile_cols == step) && g.stages >= 2 &&
                        g.stages <= kMaxStages && g.tiles_per_chunk >= 1;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  const long long tiles_block =
      (long long)(H + g.tile_rows - 1) / g.tile_rows * ((step + g.tile_cols - 1) / g.tile_cols);
  const long long nchunks = (tiles_block + g.tiles_per_chunk - 1) / g.tiles_per_chunk;
  const long long stage = transpose_stage_bytes(g.tile_rows * g.tile_cols, S);
  if (H < 1 || nchunks > 0x7fffffffLL || (long long)g.smem != g.stages * stage ||
      (long long)g.smem + 4LL * kMaxBands > kMaxRoundSmem)
    return (int)cudaErrorInvalidValue;
  if (g.aligned && ((long long)W * S % 4 != 0 || (long long)step * S % 4 != 0 ||
                    (long long)g.tile_cols * S % 4 != 0 || reinterpret_cast<size_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nchunks, nb);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
#define STARCOP_TRANSPOSE(MASKED, VEC16)                                                      \
  launch_round_kernel<kThreads>(blocked_transpose_kernel<MASKED, VEC16>, grid, g, st, x, m0, \
                                valid, o, H, W, S, R, step, g)
  cudaError_t err;
  if (valid != nullptr)
    err = g.aligned ? STARCOP_TRANSPOSE(true, true) : STARCOP_TRANSPOSE(true, false);
  else
    err = g.aligned ? STARCOP_TRANSPOSE(false, true) : STARCOP_TRANSPOSE(false, false);
#undef STARCOP_TRANSPOSE
  return (int)err;
}

// C0 (nb, S, S) = sum xs xs^T / n_given[b] over the first S rows of the
// centred bf16 stream (nb, R, P). geom: the six RoundGeom fields of
// stream_stats_geometry; partial has nchunks records per block.
int starcop_init_stats_bsp(const void* xs, const float* n_given, float* partial, float* c0,
                           int nb, int S, int R, int P, const int* geom, int nchunks,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_stream_stats<__nv_bfloat16>(xs, partial, S, R, P,
                                                             round_geom_from(geom), nchunks, nb,
                                                             st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partial, n_given, nullptr, c0, S, nchunks, nb, st);
}

// m0 (nb, S), C0 (nb, S, S) of the raw f32 stream (nb, R, P) over its first S
// rows, every pixel valid. geom, partial: as starcop_init_stats_bsp.
int starcop_init_stats_stream(const float* xs, float* partial, float* m0, float* c0, int nb,
                              int S, int R, int P, const int* geom, int nchunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_stream_stats<float>(xs, partial, S, R, P, round_geom_from(geom),
                                                     nchunks, nb, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partial, nullptr, m0, c0, S, nchunks, nb, st);
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
  if (S < 1 || S > kGlueThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = glue_smem_bytes(S);
  const cudaError_t err = allow_smem(filter_glue_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  filter_glue_kernel<<<nb, kGlueThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      partial, carry_in, carry_out, m0, tmpl, k0, nin, S, nchunks, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
