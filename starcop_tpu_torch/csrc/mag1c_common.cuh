// Device code shared by mag1c.cu and mag1c_fused.cu: constants, the
// statistics record and its f64 chunk combine, the tile statistics of the
// blocked-stream kernels (Chan fold), the streaming round over the blocked
// (nb, R, P) layout, and the Woodbury glue.
//
// Everything here lives in an anonymous namespace, so each translation unit
// that includes it gets its own copy of every kernel and device function.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;       // pixels per shared-memory tile in the S x S statistics (one warp)
constexpr int kMaxBands = 128;
constexpr float kEpsilon = 1e-9f;
constexpr float kScaling = 1e5f;

// kPass is fused_iter's first call: mf passes through from mf_in (row 4's
// ``first`` flag, mag1c_pallas.py:431), R is read, the statistics are taken.
enum RoundMode { kFirst = 0, kLoop = 1, kFinal = 2, kPass = 3 };

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same, bitwise identical sum.
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// Tile statistics. Every statistics kernel (init_stats[_masked],
// init_stats_bsp / init_stats_stream, fused_iter CHOLESKY) writes one partial
// record per (block b, chunk c) in one format,
//   [n | mean(S) | tri(S (S + 1) / 2)],
// tri holding the centred scatter's lower triangle row by row: entry (a, bb),
// bb <= a, at a (a + 1) / 2 + bb (tri_index). init_stats_reduce_kernel
// combines the records in f64 and mirrors the triangle into the full S x S.
//
// The kernels of init_stats_bsp, init_stats_stream and fused_iter CHOLESKY
// walk their chunk in tiles of kSub pixels x S bands; thread (ty, tx) of a
// 16 x 16 grid owns scatter entries (ty + 16 i, tx + 16 k) with k <= i < TS
// (the blocks on or below the diagonal), over SP = 16 * TS >= S bands
// (padding bands stay zero). init_stats[_masked] has its own tiles (mag1c.cu).
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int tri_index(int a, int bb) { return a * (a + 1) / 2 + bb; }
__host__ __device__ __forceinline__ int stats_record_len(int S) {
  return 1 + S + S * (S + 1) / 2;
}

// acc[i][k] += sum over the tile's first n_span rows of
// tile[pl][ty + 16 i] * tile[pl][tx + 16 k], for k <= i.
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
      for (int k = 0; k <= i; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
  }
}

// Chan et al.'s pairwise update of the running mean and centred scatter by
// one tile: the tile is centred on the mean of its n_tile valid rows, then
//   M += M_tile + (n_run n_tile / n) d d^T,  mean += d n_tile / n,
// with d = mean_tile - mean, so every sum accumulates centred values. With
// tile_ok, rows not marked hold 0 and stay 0 after centring. n_tile >= 1;
// the caller syncs before (the tile is staged) and after.
template <int TS>
__device__ __forceinline__ void fold_tile(float (*tile)[16 * TS + 1],
                                          const unsigned char* tile_ok, int n_span, int n_tile,
                                          int& n_run, float* mean, float* delta,
                                          float (&acc)[TS][TS], int S) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float n_new = (float)(n_run + n_tile);
  if (tid < S) {
    float m = 0.f;
    for (int pl = 0; pl < n_span; ++pl) m += tile[pl][tid];
    m /= (float)n_tile;
    for (int pl = 0; pl < n_span; ++pl) {
      if (tile_ok != nullptr)
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
    for (int k = 0; k <= i; ++k)
      acc[i][k] = fmaf(coef * delta[ty + 16 * i], delta[tx + 16 * k], acc[i][k]);
  scatter_tile<TS>(tile, n_span, acc);
  n_run += n_tile;
}

// The partial record [n | mean(S) | tri] of (b, c) from the 16 x 16 grid.
template <int TS>
__device__ __forceinline__ void write_stats_record(float* rec, int n, const float* mean,
                                                   const float (&acc)[TS][TS], int S) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid == 0) rec[0] = (float)n;
  if (tid < S) rec[1 + tid] = mean[tid];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      const int a = ty + 16 * i, bb = tx + 16 * k;
      if (a < S && bb <= a) rec[1 + S + tri_index(a, bb)] = acc[i][k];
    }
}

// ---------------------------------------------------------------------------
// Pass 2 of the tile statistics: the chunk records of block b = blockIdx.y
// combined in chunk order in f64 by the pairwise rule
//   m = sum_c n_c mean_c / n,
//   C = sum_c [M_c + n_c (mean_c - m)(mean_c - m)^T] / n,
// with n clamped to >= 1 (a block with no valid pixel gets m0 = 0, C0 = 0,
// as JAX's max(sum w, 1)). With n_given (init_stats_bsp on the centred
// stream, whose records carry zero means) n is the block's given valid count
// instead; m0 == nullptr writes no mean. CTA blockIdx.x owns kThreads
// entries of the triangle (every CTA of a block works out m, in the same
// order) and writes each to both halves of C0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
init_stats_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ n_given,
                         float* __restrict__ m0, float* __restrict__ c0, int S, int nchunks) {
  extern __shared__ double mean_all[];  // S
  const int b = blockIdx.y, tid = threadIdx.x;
  const int rec_len = stats_record_len(S);
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
    if (m0 != nullptr && blockIdx.x == 0) m0[(long long)b * S + s] = (float)(acc / n);
  }
  __syncthreads();
  const int e = blockIdx.x * kThreads + tid;
  if (e >= S * (S + 1) / 2) return;
  int a = (int)((sqrtf(8.f * (float)e + 1.f) - 1.f) * 0.5f);
  while (tri_index(a + 1, 0) <= e) ++a;
  while (tri_index(a, 0) > e) --a;
  const int bb = e - tri_index(a, 0);
  double acc = 0.0;
  for (int c = 0; c < nchunks; ++c) {
    const float* rec = base + (long long)c * rec_len;
    const double da = (double)rec[1 + a] - mean_all[a];
    const double db = (double)rec[1 + bb] - mean_all[bb];
    acc += (double)rec[1 + S + e] + (double)rec[0] * da * db;
  }
  const float v = (float)(acc / n);
  c0[((long long)b * S + a) * S + bb] = v;
  c0[((long long)b * S + bb) * S + a] = v;
}

// Launch init_stats_reduce_kernel over the nb blocks' records.
inline cudaError_t launch_stats_reduce(const float* partial, const float* n_given, float* m0,
                                       float* c0, int S, int nchunks, int nb, cudaStream_t st) {
  const dim3 grid((S * (S + 1) / 2 + kThreads - 1) / kThreads, nb);
  init_stats_reduce_kernel<<<grid, kThreads, S * sizeof(double), st>>>(partial, n_given, m0, c0,
                                                                       S, nchunks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The streaming rounds: shared machinery of filter_round (the (H, W, S) cube,
// mag1c.cu) and round_bsp_chunk (the blocked stream, below).
//
// What bounds them: each pass reads the cube or stream once from HBM (4 or 2
// bytes per pixel and band) and does ~2 FMAs per value, so a round is bound by
// HBM bytes. The design keeps the bytes in flight and every thread busy:
//
//  * Tiles and chunks. A CTA of kRoundThreads threads owns one chunk of a
//    column block: a whole number of tiles of at most kRoundThreads pixels,
//    one pixel per thread. The launch geometry (tile shape, tiles per chunk,
//    stages, the copy width, shared-memory bytes) comes from the Python
//    wrapper (ops/mag1c_kernels.py:round_geometry), which picks the chunk so
//    that the grid's last wave is (nearly) full; the kernel checks it.
//  * A ring of `stages` tiles in shared memory, filled by cp.async while the
//    CTA works on an earlier tile: the tile's values (16-byte copies where
//    every row starts and ends on 16 bytes, else 4-byte ones), its pixels' R
//    and mf_prev, and the 4-byte word that holds each pixel's mask byte
//    travel in one commit group, so no load waits on another.
//  * Two phases per tile, every thread busy in both: (1) thread t projects
//    its own pixel from the tile (proj = cit.xc - cit.mu, q = m0.xc in
//    FIRST), no shuffles; (2) warp w owns bands w, w + 4, ... and its lanes
//    own pixels lane + 32 j: u[s] += xc[p, s] g[p] in registers across the
//    whole chunk, reduced once per chunk by a fixed butterfly. A pixel that
//    does not count is selected out before any of its values is read from
//    the tile (they may hold the fill value or stale bytes), so it is never
//    multiplied in.
//
// Per pixel, with xc = x - m0 (or the centred stream):
//   FIRST: R = (m0.xc) / (m0.m0) + 1, mf = relu((cit.xc - cit.mu) / (R norm0))
//   LOOP:  mf = relu((cit.xc - cit.mu - 1/(R (mf_prev + eps))) / (R norm))
//   FINAL: as LOOP, written scaled by 1e5, no statistics
//   PASS:  mf = mf_prev, R read (fused_iter's first call)
// then g = cov_scale R mf. The per-chunk record is [u(S) | sum g | sum g^2].
// Every sum runs in a fixed order, so a rerun is bitwise identical.
// ---------------------------------------------------------------------------
constexpr int kRoundThreads = 128;
constexpr int kRoundWarps = kRoundThreads / 32;
constexpr int kBandSlots = kMaxBands / kRoundWarps;  // bands a warp owns in the u sum
constexpr int kMaxStages = 4;
constexpr int kMaxRoundSmem = 227 * 1024;
// Per stage beside the tile: R, mf_prev, the mask word (4 bytes each) and
// the mask byte's position in its word (4: the column lies past W).
constexpr int kPixStageBytes = 3 * 4 * kRoundThreads + kRoundThreads;
// Once per CTA: g, the pixel-counts flags, cit, m0 and 16 scalars.
constexpr int kRoundFixedBytes = 4 * (2 * kRoundThreads + 2 * kMaxBands + 16);
constexpr int kBf16RowPitch = kRoundThreads + 8;  // bf16 stream row: 272 bytes, 16-aligned

// The launch geometry, as ops/mag1c_kernels.py:round_geometry gives it.
struct RoundGeom {
  int tile_rows;        // image rows of a cube tile (1 on the stream)
  int tile_cols;        // columns of a cube tile (kRoundThreads on the stream)
  int tiles_per_chunk;  // tiles of one CTA
  int stages;           // tiles in the ring, 2..kMaxStages
  int aligned;          // 16-byte copies of the tile values (else 4-byte)
  int smem;             // dynamic shared-memory bytes
};

inline RoundGeom round_geom_from(const int* v) {
  return RoundGeom{v[0], v[1], v[2], v[3], v[4], v[5]};
}

inline size_t round_smem_bytes(int stages, int tile_bytes) {
  return (size_t)stages * (size_t)(tile_bytes + kPixStageBytes) + kRoundFixedBytes;
}

// Floats of one cube tile row: tile_cols pixels of S bands, padded to 16 bytes.
__host__ __device__ inline int cube_row_pitch(int tile_cols, int S) {
  return (tile_cols * S + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ constexpr int stream_row_pitch() {
  return sizeof(T) == 2 ? kBf16RowPitch : kRoundThreads;
}

// The tiling's own invariants against the shapes (the rounds' and the cube
// statistics'): tiles of at most kRoundThreads pixels, a ring of 2..kMaxStages,
// chunks that cover the block's tiles with none empty.
inline bool tiling_ok(const RoundGeom& g, int tiles_block, int nchunks) {
  return g.tile_rows >= 1 && g.tile_cols >= 1 && g.tile_rows * g.tile_cols <= kRoundThreads &&
         g.stages >= 2 && g.stages <= kMaxStages && g.tiles_per_chunk >= 1 && nchunks >= 1 &&
         (long long)nchunks * g.tiles_per_chunk >= tiles_block &&
         (long long)(nchunks - 1) * g.tiles_per_chunk < tiles_block;
}

// A round's geometry against the shapes; false refuses the launch.
inline bool round_geom_ok(const RoundGeom& g, int tiles_block, int nchunks, int tile_bytes) {
  return tiling_ok(g, tiles_block, nchunks) &&
         (size_t)g.smem == round_smem_bytes(g.stages, tile_bytes) && g.smem <= kMaxRoundSmem;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0 .. kMaxStages - 2) of this thread's groups
// are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// The dynamic shared memory of a round CTA.
struct RoundSmem {
  unsigned char* tiles;  // stages x tile_bytes
  float* r;              // stages x kRoundThreads
  float* mf;             // stages x kRoundThreads
  unsigned* mword;       // stages x kRoundThreads
  unsigned char* mpos;   // stages x kRoundThreads
  float* g;              // kRoundThreads
  int* ok;               // kRoundThreads
  float* cit;            // kMaxBands
  float* m0;             // kMaxBands
  float* misc;           // 16: cit.mu, m0.m0, per-warp sum g, sum g^2
};

__device__ __forceinline__ RoundSmem carve_round_smem(unsigned char* base, int stages,
                                                      int tile_bytes) {
  RoundSmem sm;
  sm.tiles = base;
  unsigned char* p = base + (size_t)stages * tile_bytes;
  sm.r = reinterpret_cast<float*>(p);
  sm.mf = sm.r + stages * kRoundThreads;
  sm.mword = reinterpret_cast<unsigned*>(sm.mf + stages * kRoundThreads);
  sm.mpos = reinterpret_cast<unsigned char*>(sm.mword + stages * kRoundThreads);
  sm.g = reinterpret_cast<float*>(sm.mpos + stages * kRoundThreads);
  sm.ok = reinterpret_cast<int*>(sm.g + kRoundThreads);
  sm.cit = reinterpret_cast<float*>(sm.ok + kRoundThreads);
  sm.m0 = sm.cit + kMaxBands;
  sm.misc = sm.m0 + kMaxBands;
  return sm;
}

// cit and m0 of block b into shared memory (rounded to bf16 with BF16_DOTS),
// cit.mu and m0.m0 (f32, unrounded, in band order) into misc[0], misc[1].
template <bool BF16_DOTS>
__device__ __forceinline__ void load_round_consts(const RoundSmem& sm, const float* cb,
                                                  const float* mb, int S) {
  const int t = threadIdx.x;
  for (int s = t; s < S; s += kRoundThreads) {
    sm.cit[s] = BF16_DOTS ? bf16_round(cb[2 * S + s]) : cb[2 * S + s];
    sm.m0[s] = BF16_DOTS ? bf16_round(mb[s]) : mb[s];
  }
  if (t == 0) {
    float shift = 0.f, m0n = 0.f;
    for (int s = 0; s < S; ++s) {
      shift = fmaf(cb[2 * S + s], cb[s], shift);
      m0n = fmaf(mb[s], mb[s], m0n);
    }
    sm.misc[0] = shift;
    sm.misc[1] = m0n;
  }
  __syncthreads();
}

// Thread t's copy of its pixel's per-pixel rows (R and mf_prev unless FIRST)
// and, masked, of the word holding its mask byte (`mask`, nullptr where the
// column lies past W) into stage `slot`.
template <int MODE, bool MASKED>
__device__ __forceinline__ void issue_pixel(const RoundSmem& sm, int slot, long long i,
                                            const float* r, const float* mf_in,
                                            const unsigned char* mask) {
  const int t = threadIdx.x, at = slot * kRoundThreads + t;
  if (MODE != kFirst) {
    cp_async4(sm.r + at, r + i);
    cp_async4(sm.mf + at, mf_in + i);
  }
  if constexpr (MASKED) {
    // The aligned word that holds the byte lies in the mask's allocation
    // (CUDA allocations start and end on 4-byte multiples).
    unsigned char pos = 4;
    if (mask != nullptr) {
      const size_t a = reinterpret_cast<size_t>(mask);
      pos = (unsigned char)(a & 3);
      cp_async4(sm.mword + at, reinterpret_cast<const void*>(a & ~(size_t)3));
    }
    sm.mpos[at] = pos;
  }
}

// Whether thread t's pixel counts under the mask of stage `slot`.
__device__ __forceinline__ bool mask_set(const RoundSmem& sm, int slot) {
  const int at = slot * kRoundThreads + threadIdx.x;
  const unsigned pos = sm.mpos[at];
  return pos < 4 && ((sm.mword[at] >> (8 * pos)) & 0xffu) != 0;
}

// mf and R of one pixel from its projections (see above); ok false: mf = 0,
// R = 1. at: the pixel's stage slot entry.
template <int MODE>
__device__ __forceinline__ void pixel_update(const RoundSmem& sm, int at, bool ok, float proj,
                                             float q, float norm, float& ru, float& mf) {
  ru = 1.f;
  mf = 0.f;
  if (!ok) return;
  const float shift = sm.misc[0], m0n = sm.misc[1];
  if (MODE == kFirst) {
    ru = q / m0n + 1.f;
    mf = fmaxf((proj - shift) / (ru * norm), 0.f);
  } else if (MODE == kPass) {
    ru = sm.r[at];
    mf = sm.mf[at];
  } else {
    ru = sm.r[at];
    const float reg = 1.f / (ru * (sm.mf[at] + kEpsilon));
    mf = fmaxf((proj - shift - reg) / (ru * norm), 0.f);
  }
}

// proj = sum_s cit[s] xc(s) and, with Q, q = sum_s m0[s] xc(s), each in band
// order, where xc(s) = load(s), less m0[s] with CENTER. cit and m0 are read
// four bands at a time (one broadcast load each).
template <bool Q, bool CENTER, typename Load>
__device__ __forceinline__ void project(const RoundSmem& sm, int S, Load load, float& proj,
                                        float& q) {
  const float4* cit4 = reinterpret_cast<const float4*>(sm.cit);
  const float4* m04 = reinterpret_cast<const float4*>(sm.m0);
  int s = 0;
  for (; s + 4 <= S; s += 4) {
    const float4 c = cit4[s / 4];
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    if (Q || CENTER) m = m04[s / 4];
    float x0 = load(s), x1 = load(s + 1), x2 = load(s + 2), x3 = load(s + 3);
    if (CENTER) {
      x0 -= m.x;
      x1 -= m.y;
      x2 -= m.z;
      x3 -= m.w;
    }
    proj = fmaf(c.x, x0, proj);
    proj = fmaf(c.y, x1, proj);
    proj = fmaf(c.z, x2, proj);
    proj = fmaf(c.w, x3, proj);
    if (Q) {
      q = fmaf(m.x, x0, q);
      q = fmaf(m.y, x1, q);
      q = fmaf(m.z, x2, q);
      q = fmaf(m.w, x3, q);
    }
  }
  for (; s < S; ++s) {
    float xv = load(s);
    if (CENTER) xv -= sm.m0[s];
    proj = fmaf(sm.cit[s], xv, proj);
    if (Q) q = fmaf(sm.m0[s], xv, q);
  }
}

// u[k] += xc(s, pixel lane + 32 j) g[pixel] over the tile's pixels that
// count, for the warp's bands s = warp + kRoundWarps k: each sum in pixel
// order. xc(s, j) = load(s, j), less m0[s] with CENTER.
template <bool CENTER, typename Load>
__device__ __forceinline__ void accumulate_u(const RoundSmem& sm, int S, Load load,
                                             float (&u)[kBandSlots]) {
  constexpr int J = kRoundThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float gp[J];
  bool okp[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    okp[j] = sm.ok[lane + 32 * j] != 0;
    gp[j] = sm.g[lane + 32 * j];
  }
#pragma unroll
  for (int k = 0; k < kBandSlots; ++k) {
    const int s = warp + kRoundWarps * k;
    if (s >= S) break;  // uniform across the warp
    const float m = CENTER ? sm.m0[s] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!okp[j]) continue;
      float xv = load(s, j);
      if (CENTER) xv -= m;
      u[k] = fmaf(xv, gp[j], u[k]);
    }
  }
}

// The chunk's record [u(S) | sum g | sum g^2]: each warp's band sums reduced
// over its lanes, the g moments over the warps in order.
__device__ __forceinline__ void write_round_record(const RoundSmem& sm, float* rec,
                                                   const float (&u)[kBandSlots], float gsum,
                                                   float gsq, int S) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kBandSlots; ++k) {
    const int s = warp + kRoundWarps * k;
    if (s >= S) break;  // uniform across the warp
    const float v = warp_sum(u[k]);
    if (lane == 0) rec[s] = v;
  }
  gsum = warp_sum(gsum);
  gsq = warp_sum(gsq);
  if (lane == 0) {
    sm.misc[2 + warp] = gsum;
    sm.misc[2 + kRoundWarps + warp] = gsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum_g = 0.f, sum_g2 = 0.f;
    for (int w = 0; w < kRoundWarps; ++w) {
      sum_g += sm.misc[2 + w];
      sum_g2 += sm.misc[2 + kRoundWarps + w];
    }
    rec[S] = sum_g;
    rec[S + 1] = sum_g2;
  }
}

// ---------------------------------------------------------------------------
// One streaming pass over the blocked stream (nb, R, P): the chunk of block
// b = blockIdx.y that CTA blockIdx.x owns (filter_round_bsp,
// filter_round_mono and fused_iter's WOODBURY mode). A tile is kRoundThreads
// contiguous pixels of every live band row, staged band-major (row s at
// s * pitch), so thread t reads pixel t of a row and the lanes of a warp
// read consecutive words: no bank conflicts in either phase. VEC16: P *
// sizeof(T) is a multiple of 16, so every tile row starts on 16 bytes and is
// copied in 16-byte pieces; else 4-byte copies (f32: one per value; bf16: the
// aligned words that cover the row, the row's first value at half-word
// `off` of its staged row).
//
// T is the storage type: bf16 (the centred stream) or float. CENTER (float
// only) subtracts m0 in registers: the raw f32 stream of JAX's
// centered=False (mag1c_pallas.py:1702-1704). BF16_DOTS (bf16 only): cit, m0
// and g are rounded to bf16 before their products with the stream, as JAX's
// bf16 MXU dots take them (:633-636, :693-701, _lane_dot :555-574); the
// products are then exact in f32. cit.mu, m0.m0, sum g, sum g^2 stay f32.
// MASKED reads a uint8 valid mask (H, W) and the width W: pixel p of block b
// counts if its column b*step + p % step is < W and its mask byte is set
// (one division per pixel and tile, when its copies are issued). A (B, P)
// row mask is the case H = 1, W = B * P, step = P.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ inline int stream_tile_bytes(int S) {
  return S * stream_row_pitch<T>() * (int)sizeof(T);
}

template <typename T, int MODE, bool MASKED, bool BF16_DOTS, bool CENTER, bool VEC16>
__device__ __forceinline__ void round_bsp_chunk(
    const T* __restrict__ xs, const unsigned char* __restrict__ valid,
    const float* __restrict__ m0, const float* __restrict__ carry, float* __restrict__ r,
    const float* __restrict__ mf_in, float* __restrict__ mf_out, float* __restrict__ partial,
    int W, int S, int R, int step, int P, const RoundGeom& geom, int nchunks, float cov_scale) {
  static_assert(!CENTER || sizeof(T) == 4, "only the f32 stream streams raw");
  static_assert(!BF16_DOTS || sizeof(T) == 2, "bf16 dots read a bf16 stream");
  constexpr int TP = kRoundThreads;
  constexpr int LD = stream_row_pitch<T>();
  extern __shared__ __align__(16) unsigned char round_smem[];
  const int tile_bytes = stream_tile_bytes<T>(S);
  const RoundSmem sm = carve_round_smem(round_smem, geom.stages, tile_bytes);
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t % 32;
  const float* cb = carry + (long long)b * 4 * S;
  load_round_consts<BF16_DOTS>(sm, cb, m0 + (long long)b * S, S);
  const float norm = cb[3 * S];

  const T* xb = xs + (long long)b * R * P;
  const int tiles_block = (P + TP - 1) / TP;
  const int t_beg = c * geom.tiles_per_chunk;
  const int ntile = min(tiles_block, t_beg + geom.tiles_per_chunk) - t_beg;

  // The staged value of band s, pixel pl of the tile at p0 in stage `tile`.
  auto value = [&](const T* tile, int s, int p0, int pl) -> float {
    int off = 0;
    if constexpr (!VEC16 && sizeof(T) == 2)
      off = (int)((reinterpret_cast<size_t>(xb + (long long)s * P + p0) >> 1) & 1);
    return to_f32(tile[s * LD + off + pl]);
  };

  auto issue = [&](int i) {
    if (i < ntile) {
      const int slot = i % geom.stages, p0 = (t_beg + i) * TP, n_t = min(TP, P - p0);
      unsigned char* dst = sm.tiles + (size_t)slot * tile_bytes;
      if constexpr (VEC16) {
        constexpr int kPieces = TP * (int)sizeof(T) / 16;  // per row
        const int nbytes = n_t * (int)sizeof(T);
        for (int e = t; e < S * kPieces; e += kRoundThreads) {
          const int s = e / kPieces, k = e % kPieces;
          if (16 * k < nbytes)
            cp_async16(dst + (size_t)s * LD * sizeof(T) + 16 * k,
                       reinterpret_cast<const unsigned char*>(xb + (long long)s * P + p0) + 16 * k);
        }
      } else if constexpr (sizeof(T) == 4) {
        for (int e = t; e < S * TP; e += kRoundThreads) {
          const int s = e / TP, pl = e % TP;
          if (pl < n_t)
            cp_async4(reinterpret_cast<T*>(dst) + s * LD + pl, xb + (long long)s * P + p0 + pl);
        }
      } else {
        constexpr int kWords = TP / 2 + 1;  // covering words of one bf16 row
        for (int e = t; e < S * kWords; e += kRoundThreads) {
          const int s = e / kWords, w = e % kWords;
          const size_t a = reinterpret_cast<size_t>(xb + (long long)s * P + p0);
          const int off = (int)((a >> 1) & 1);
          if (w < (off + n_t + 1) / 2)
            cp_async4(dst + (size_t)s * LD * sizeof(T) + 4 * w,
                      reinterpret_cast<const void*>((a & ~(size_t)3) + 4 * w));
        }
      }
      if (t < n_t) {
        const int p = p0 + t;
        const unsigned char* mask = nullptr;
        if constexpr (MASKED) {
          const int h = p / step;
          const int col = b * step + (p - h * step);
          if (col < W) mask = valid + (long long)h * W + col;
        }
        issue_pixel<MODE, MASKED>(sm, slot, (long long)b * P + p, r, mf_in, mask);
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
    const int slot = i % geom.stages, p0 = (t_beg + i) * TP, n_t = min(TP, P - p0);
    const T* tile = reinterpret_cast<const T*>(sm.tiles + (size_t)slot * tile_bytes);
    const bool in = t < n_t;
    bool ok = in;
    if constexpr (MASKED) ok = in && mask_set(sm, slot);
    float proj = 0.f, q = 0.f;
    if (ok)
      project<MODE == kFirst, CENTER>(
          sm, S, [&](int s) { return value(tile, s, p0, t); }, proj, q);
    float ru, mf;
    pixel_update<MODE>(sm, slot * kRoundThreads + t, ok, proj, q, norm, ru, mf);
    if (in) {
      const long long i_px = (long long)b * P + p0 + t;
      if (MODE == kFirst) r[i_px] = ru;
      mf_out[i_px] = MODE == kFinal ? mf * kScaling : mf;
    }
    if (MODE == kFinal) continue;
    const float g = cov_scale * (ru * mf);  // 0 where the pixel does not count
    gsum += g;
    gsq = fmaf(g, g, gsq);
    sm.g[t] = BF16_DOTS ? bf16_round(g) : g;
    sm.ok[t] = ok;
    __syncthreads();
    accumulate_u<CENTER>(
        sm, S, [&](int s, int j) { return value(tile, s, p0, lane + 32 * j); }, u);
  }
  cp_async_wait_pending(0);
  if (MODE == kFinal) return;
  write_round_record(sm, partial + ((long long)b * nchunks + c) * (S + 2), u, gsum, gsq, S);
}

// ---------------------------------------------------------------------------
// The Woodbury glue, _glue_math (mag1c_pallas.py:776), for one block: from
// the block's nchunks records [u | sum g | sum g^2] and 1/n (nin: the valid
// count clamped to >= 1, or P unmasked), the rank-2 update of the carry
// [mu | target | cit | norm]. Values are f32 as in the TPU kernel; the
// record sums and every product with K0 accumulate in f64 (the Woodbury
// solve amplifies rounding by the covariance's condition number, ~5e5 on
// EMIT-like scenes).
//
// What bounds it: nothing the card is short of. One CTA per block does ~10
// S^2 operations on ~4 S^2 bytes; its time is the latency of its dependent
// chains, so the design shortens every chain:
//  * K0 (S x S) is staged in shared memory by cp.async (16-byte copies where
//    S is a multiple of 4 and K0 starts on 16 bytes, else 4-byte ones) while
//    the records are summed, at a row pitch of 8 m + 4 floats, so that the
//    matvecs' float4 row reads are free of bank conflicts;
//  * the record sums in parts: thread t sums column t % (S + 2) over the
//    chunks q, q + Q, ... (part q = t / (S + 2), Q = kGlueThreads / (S + 2)),
//    its loads independent of one another, so they stay in flight together;
//    the parts are added in order (a fixed tree);
//  * a matvec K0 v splits each row over Q = kGlueThreads / S threads (row
//    t % S, part t / S), each a chain of ~S / Q f64 FMAs, the parts summed
//    in order; the first two (K0 target, K0 u) share one sweep of K0;
//  * each scalar dot is one warp's (lanes over bands, a fixed butterfly);
//    independent dots run on different warps (g00, g01, g10, g11; y0, y1).
// Every order is fixed, so a rerun is bitwise identical. Runs on a CTA of
// kGlueThreads >= S threads with glue_smem_bytes(S) of shared memory
// (filter_round_mono: its drained ring). The records are read through L2
// (__ldcg): in filter_round_mono other CTAs of the same launch wrote them.
// ---------------------------------------------------------------------------
constexpr int kGlueThreads = 128;  // >= S
constexpr int kGlueWarps = kGlueThreads / 32;

struct __align__(16) GlueSmem {
  float u[kGlueThreads], tgt[kGlueThreads], tnew[kGlueThreads];
  float wt[kGlueThreads], wu[kGlueThreads];
  float z[kGlueThreads], v2[kGlueThreads], z2[kGlueThreads];
  double part[2][kGlueThreads];  // record sums' parts; matvec parts at t = part * S + row
  double dot[8];                 // g00, g01, g10, g11 | y0, y1 | tnew.z
  float sc[16];                  // gbar, mom1 (both times nin)
};
static_assert(sizeof(GlueSmem) == 6272, "ops/mag1c_kernels.py:GLUE_FIXED_BYTES");

// Row pitch (floats) of the staged K0: S rounded up to 4, plus 4 where that
// is a multiple of 8.
__host__ __device__ inline int glue_k0_pitch(int S) {
  const int p = (S + 3) / 4 * 4;
  return p % 8 == 0 ? p + 4 : p;
}

// Shared memory of glue_block: GlueSmem, then the staged K0.
__host__ __device__ inline size_t glue_smem_bytes(int S) {
  return sizeof(GlueSmem) + sizeof(float) * (size_t)S * glue_k0_pitch(S);
}

struct GlueInv {
  float i00, i01, i10, i11, det;
};

__device__ __forceinline__ double warp_sum_f64(double v) {
  // Butterfly: every lane ends with the same, bitwise identical sum.
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// sum_j a[j] b[j] over j < S in f64 by the calling warp (every lane gets it).
__device__ __forceinline__ double warp_dot(const float* a, const float* b, int S) {
  double acc = 0.0;
  for (int j = threadIdx.x % 32; j < S; j += 32) acc = fma((double)a[j], (double)b[j], acc);
  return warp_sum_f64(acc);
}

// K0 of the block into k0s at glue_k0_pitch(S), the pad columns zero; one
// commit group.
__device__ __forceinline__ void stage_k0(float* k0s, const float* __restrict__ k0, int S) {
  const int t = threadIdx.x, pitch = glue_k0_pitch(S), padc = pitch - S;
  if (S % 4 == 0 && (reinterpret_cast<size_t>(k0) & 15) == 0) {
    const int q = S / 4;  // 16-byte pieces per row
    for (int e = t; e < S * q; e += kGlueThreads) {
      const int row = e / q, k = e - row * q;
      cp_async16(k0s + row * pitch + 4 * k, k0 + row * S + 4 * k);
    }
  } else {
    for (int e = t; e < S * S; e += kGlueThreads) {
      const int row = e / S;
      cp_async4(k0s + row * pitch + (e - row * S), k0 + e);
    }
  }
  if (padc > 0)
    for (int e = t; e < S * padc; e += kGlueThreads) {
      const int row = e / padc;
      k0s[row * pitch + S + (e - row * padc)] = 0.f;
    }
  cp_async_commit();
}

// part[n][t] = the f64 sum over part q = t / S of row t % S of K0 v_n (float4
// columns in order); the vectors are zero past S.
template <int NV>
__device__ __forceinline__ void k0_matvec_parts(const float* k0s, const float* const (&v)[NV],
                                                double (*part)[kGlueThreads], int S) {
  const int t = threadIdx.x, nparts = kGlueThreads / S;
  const int row = t % S, q = t / S;
  if (q >= nparts) return;
  const int n4 = (S + 3) / 4, per = (n4 + nparts - 1) / nparts;
  const int c_beg = q * per, c_end = min(n4, c_beg + per);
  const float4* r4 = reinterpret_cast<const float4*>(k0s + row * glue_k0_pitch(S));
  double acc[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) acc[n] = 0.0;
  for (int c = c_beg; c < c_end; ++c) {
    const float4 k = r4[c];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const float4 x = reinterpret_cast<const float4*>(v[n])[c];
      acc[n] = fma((double)k.x, (double)x.x, acc[n]);
      acc[n] = fma((double)k.y, (double)x.y, acc[n]);
      acc[n] = fma((double)k.z, (double)x.z, acc[n]);
      acc[n] = fma((double)k.w, (double)x.w, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) part[n][t] = acc[n];
}

// (K0 v)[row] from its parts, summed in part order.
__device__ __forceinline__ float combine_parts(const double* part, int row, int S) {
  double acc = part[row];
  for (int q = 1; q < kGlueThreads / S; ++q) acc += part[q * S + row];
  return (float)acc;
}

// out = A0^{-1} v by Woodbury against K0 = C0s^{-1} (the a0inv of _glue_math):
// the matvec's parts and the dots y0 = wt.v, y1 = wu.v (warps 0, 1) in one
// phase, then the update. v is complete and zero past S on entry.
__device__ __forceinline__ void a0inv(const float* k0s, const float* v, float* out, GlueSmem& g,
                                      const GlueInv& iv, int S) {
  const int t = threadIdx.x, warp = t / 32;
  const float* vs[1] = {v};
  k0_matvec_parts<1>(k0s, vs, g.part, S);
  if (warp < 2) {
    const double y = warp_dot(warp == 0 ? g.wt : g.wu, v, S);
    if (t % 32 == 0) g.dot[4 + warp] = y;
  }
  __syncthreads();
  const float y0 = (float)g.dot[4], y1 = (float)g.dot[5];
  const float x0 = (iv.i11 * y0 - iv.i01 * y1) / iv.det;
  const float x1 = (-iv.i10 * y0 + iv.i00 * y1) / iv.det;
  if (t < S) out[t] = combine_parts(g.part[0], t, S) - g.wt[t] * x0 - g.wu[t] * x1;
  __syncthreads();
}

// base: the block's records, (nchunks, S + 2); cin / cnext: its carry rows
// (4, S); m0b (S,); k0 (S, S) of the block; k0s: glue_k0_pitch(S) * S floats
// of shared memory beside g.
__device__ void glue_block(const float* base, int nchunks, const float* __restrict__ cin,
                           float* __restrict__ cnext, const float* __restrict__ m0b,
                           const float* __restrict__ tmpl, const float* __restrict__ k0,
                           float nin, int S, float alpha, GlueSmem& g, float* k0s) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  stage_k0(k0s, k0, S);
  float tmpl_t = 0.f, m0_t = 0.f;
  if (t < S) {
    tmpl_t = tmpl[t];
    m0_t = m0b[t];
    g.tgt[t] = cin[S + t];
  } else {  // the matvecs read whole float4s: zero past S
    g.u[t] = g.tgt[t] = g.tnew[t] = g.v2[t] = g.wt[t] = g.wu[t] = 0.f;
  }
  const int ncol = S + 2, nq = max(1, kGlueThreads / ncol);
  double* parts = &g.part[0][0];
  for (int e = t; e < nq * ncol; e += kGlueThreads) {  // overlaps K0's copies
    const int col = e % ncol;
    double acc = 0.0;
#pragma unroll 8
    for (int c = e / ncol; c < nchunks; c += nq) acc += (double)__ldcg(base + (long long)c * ncol + col);
    parts[e] = acc;
  }
  cp_async_wait_pending(0);
  __syncthreads();
  for (int col = t; col < ncol; col += kGlueThreads) {
    double acc = parts[col];
    for (int q = 1; q < nq; ++q) acc += parts[q * ncol + col];
    const float v = (float)acc * nin;  // u = s1 * nin; gbar; mom1 * nin
    if (col < S)
      g.u[col] = v;
    else
      g.sc[col - S] = v;
  }
  __syncthreads();
  const float gbar = g.sc[0], beta = g.sc[1] - gbar * gbar;

  float mu_new = 0.f;
  if (t < S) {
    mu_new = -g.tgt[t] * gbar;
    g.tnew[t] = tmpl_t * (m0_t + mu_new);
  }
  {
    const float* vs[2] = {g.tgt, g.u};  // K0 target and K0 u in one sweep
    k0_matvec_parts<2>(k0s, vs, g.part, S);
  }
  __syncthreads();
  if (t < S) {
    g.wt[t] = combine_parts(g.part[0], t, S);
    g.wu[t] = combine_parts(g.part[1], t, S);
  }
  __syncthreads();
  {  // g00 = target.wt, g01 = target.wu, g10 = u.wt, g11 = u.wu: one warp each
    const double d = warp_dot(warp < 2 ? g.tgt : g.u, warp % 2 == 0 ? g.wt : g.wu, S);
    if (lane == 0) g.dot[warp] = d;
  }
  __syncthreads();
  const float sa = 1.f - alpha;
  GlueInv iv;
  iv.i00 = (float)g.dot[0];
  iv.i01 = (float)g.dot[1] - 1.f / sa;
  iv.i10 = (float)g.dot[2] - 1.f / sa;
  iv.i11 = (float)g.dot[3] - beta / sa;
  iv.det = iv.i00 * iv.i11 - iv.i01 * iv.i10;

  a0inv(k0s, g.tnew, g.z, g, iv, S);
  if (alpha != 0.f) {
    if (t < S) {
      const float d = beta * g.tgt[t] * g.tgt[t] - 2.f * g.tgt[t] * g.u[t];
      g.v2[t] = alpha * d * g.z[t];
    }
    __syncthreads();
    a0inv(k0s, g.v2, g.z2, g, iv, S);
    if (t < S) g.z[t] = g.z[t] - g.z2[t];
    __syncthreads();
  }
  if (warp == 0) {
    const double d = warp_dot(g.tnew, g.z, S);
    if (lane == 0) g.dot[6] = d;
  }
  __syncthreads();
  const float norm = fmaxf((float)g.dot[6], 1.f);
  if (t < S) {
    cnext[t] = mu_new;
    cnext[S + t] = g.tnew[t];
    cnext[2 * S + t] = g.z[t];
    cnext[3 * S + t] = norm;
  }
}

// Raise a kernel's dynamic shared-memory limit when it asks for more than the
// default 48 KB (the rounds' tile rings).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
bool stream_geom_ok(const RoundGeom& g, const void* xs, int S, int P, int nchunks) {
  if (g.tile_rows != 1 || g.tile_cols != kRoundThreads) return false;
  if (g.aligned && ((size_t)P * sizeof(T) % 16 != 0 || reinterpret_cast<size_t>(xs) % 16 != 0))
    return false;
  return round_geom_ok(g, (P + kRoundThreads - 1) / kRoundThreads, nchunks,
                       stream_tile_bytes<T>(S));
}

// Launch a round kernel on its (nchunks, nb) grid with the geometry's ring.
template <typename K, typename... Args>
cudaError_t launch_round_kernel(K kernel, dim3 grid, const RoundGeom& g, cudaStream_t st,
                                Args... args) {
  const cudaError_t err = allow_smem(kernel, (size_t)g.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRoundThreads, g.smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace
