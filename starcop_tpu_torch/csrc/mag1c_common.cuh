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
// Tile statistics. Every statistics kernel (init_stats[_masked] on the cube,
// mag1c.cu; init_stats_bsp / init_stats_stream and fused_iter CHOLESKY on the
// blocked stream, stream_stats_chunk below) writes one partial record per
// (block b, chunk c) in one format,
//   [n | mean(S) | tri(S (S + 1) / 2)],
// tri holding the centred scatter's lower triangle row by row: entry (a, bb),
// bb <= a, at a (a + 1) / 2 + bb (tri_index). init_stats_reduce_kernel
// combines the records in f64 and mirrors the triangle into the full S x S.
//
// All five share one scatter. A CTA of kThreads threads (kStatsCtasPerSm
// per SM) restages each tile centred, pixel-major: band s of pixel pl at
// pl * pitch + spos(s), where the first and the last four bands of each
// 8-band group lie in the pixel's two halves (nr = ceil(S / 8) float4 each),
// so a quarter-warp's float4 reads of 8 groups hit 8 distinct bank groups.
// The lower triangle is covered by T = nr (nr + 1) / 2 register micro-tiles
// of 8 x 8; G = kThreads / T groups of threads split the tile's pixels
// (thread t: micro-tile t % T, pixels t / T, + G, ...), 64 FMAs per pixel
// for four float4 reads, and the group sums are added in group order at the
// chunk's end. Chan's update of the running (n, mean, M) by a tile of n_t
// pixels with mean m_t, d = m_t - mean, n' = n + n_t, is
//   M += sum (x - mean)(x - mean)^T - (n_t^2 / n') d d^T,
// so the tile is centred on the running mean, known before it arrives, in
// the same pass that sums it; the rank-1 term waits for the next tile.
// ---------------------------------------------------------------------------
constexpr int kStatsCtasPerSm = 2;

__host__ __device__ __forceinline__ int tri_index(int a, int bb) { return a * (a + 1) / 2 + bb; }
__host__ __device__ __forceinline__ int stats_record_len(int S) {
  return 1 + S + S * (S + 1) / 2;
}

// Micro-tiles of the triangle at S bands, and the thread groups over pixels.
__host__ __device__ inline int stats_microtiles(int S) {
  const int nr = (S + 7) / 8;
  return nr * (nr + 1) / 2;
}
__host__ __device__ inline int stats_groups(int S) { return kThreads / stats_microtiles(S); }
// Bytes of the group sums added at a chunk's end (they reuse the ring).
__host__ __device__ inline size_t stats_group_bytes(int S) {
  return (size_t)256 * stats_microtiles(S) * (stats_groups(S) - 1);
}

// Position of band s in a restaged pixel of ceil(S / 8) 8-band groups: the
// group's first four bands in the first half, its last four in the second.
__device__ __forceinline__ int stats_spos(int s, int nr) {
  return (s % 8 / 4) * (4 * nr) + 4 * (s / 8) + s % 4;
}

// This thread's part of the scatter: micro-tile j = t % T, the (row, column)
// groups (mi, mk) of 8 bands it covers, over the pixels of group g = t / T
// (g >= G: idle in the scatter; group 0 writes the record).
struct ScatterRole {
  int g, j, mi, mk;
};

__device__ __forceinline__ ScatterRole scatter_role(int S) {
  const int T = stats_microtiles(S);
  ScatterRole sr;
  sr.g = threadIdx.x / T;
  sr.j = threadIdx.x % T;
  sr.mi = 0;
  while (tri_index(sr.mi + 1, 0) <= sr.j) ++sr.mi;
  sr.mk = sr.j - tri_index(sr.mi, 0);
  return sr;
}

// acc += the scatter of the restaged pixels 0 .. npx - 1 (float4 pitch
// pitch4, halves nr float4 apart) of this thread's group.
__device__ __forceinline__ void scatter_pixels(const float4* ctile4, int pitch4, int nr, int npx,
                                               int G, const ScatterRole& sr, float (&acc)[64]) {
  if (sr.g >= G) return;
#pragma unroll 2
  for (int pl = sr.g; pl < npx; pl += G) {
    const float4* px = ctile4 + pl * pitch4;
    const float4 a0 = px[sr.mi], a1 = px[nr + sr.mi], v0 = px[sr.mk], v1 = px[nr + sr.mk];
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[8 * r + q] = fmaf(av[r], bv[q], acc[8 * r + q]);
  }
}

// The rank-1 term coef d d^T of the last folded tile (group 0 only); delta
// is zero past S.
__device__ __forceinline__ void fold_rank1(float coef, const float* delta, const ScatterRole& sr,
                                           float (&acc)[64]) {
  if (coef == 0.f || sr.g != 0) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float dr = coef * delta[8 * sr.mi + r];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[8 * r + q] = fmaf(dr, delta[8 * sr.mk + q], acc[8 * r + q]);
  }
}

// The chunk's record [n | mean | tri] at rec: the groups' sums added into
// group 0 in group order through `sums` (stats_group_bytes(S) of shared
// memory no longer in use), then group 0 writes the triangle. Every thread
// calls it (it holds a barrier).
__device__ __forceinline__ void write_scatter_record(float* rec, float* sums, int n_run,
                                                     const float* mean, const ScatterRole& sr,
                                                     int S, float (&acc)[64]) {
  const int T = stats_microtiles(S), G = stats_groups(S), t = threadIdx.x;
  if (G > 1) {  // [(g - 1) * 64 + e][j]
    if (sr.g > 0 && sr.g < G)
#pragma unroll
      for (int e = 0; e < 64; ++e) sums[((sr.g - 1) * 64 + e) * T + sr.j] = acc[e];
    __syncthreads();
    if (sr.g == 0)
      for (int gg = 1; gg < G; ++gg)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += sums[((gg - 1) * 64 + e) * T + sr.j];
  }
  if (t == 0) rec[0] = (float)n_run;
  if (t < S) rec[1 + t] = mean[t];
  if (sr.g == 0)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int a = 8 * sr.mi + r, bb = 8 * sr.mk + q;
        if (a < S && bb <= a) rec[1 + S + tri_index(a, bb)] = acc[8 * r + q];
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

// The half-word at which the staged copy of the stream row that starts at
// src begins: 1 where a bf16 row starts mid-word and is copied in the words
// that cover it, else 0.
template <typename T, bool VEC16>
__device__ __forceinline__ int stream_row_off(const T* src) {
  if constexpr (!VEC16 && sizeof(T) == 2) return (int)((reinterpret_cast<size_t>(src) >> 1) & 1);
  return 0;
}

// The NT threads' copies of one stream tile, pixels p0 .. p0 + n_t - 1 of the
// first S band rows of block xb, into dst (row s at s * stream_row_pitch<T>()
// elements): 16-byte pieces with VEC16, else 4-byte copies (f32: one per
// value; bf16: the aligned words that cover the row). The caller commits.
template <typename T, bool VEC16, int NT>
__device__ __forceinline__ void issue_stream_tile(unsigned char* dst, const T* xb, int S, int P,
                                                  int p0, int n_t) {
  constexpr int TP = kRoundThreads;
  constexpr int LD = stream_row_pitch<T>();
  const int t = threadIdx.x;
  if constexpr (VEC16) {
    constexpr int kPieces = TP * (int)sizeof(T) / 16;  // per row
    const int nbytes = n_t * (int)sizeof(T);
    for (int e = t; e < S * kPieces; e += NT) {
      const int s = e / kPieces, k = e % kPieces;
      if (16 * k < nbytes)
        cp_async16(dst + (size_t)s * LD * sizeof(T) + 16 * k,
                   reinterpret_cast<const unsigned char*>(xb + (long long)s * P + p0) + 16 * k);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int e = t; e < S * TP; e += NT) {
      const int s = e / TP, pl = e % TP;
      if (pl < n_t)
        cp_async4(reinterpret_cast<T*>(dst) + s * LD + pl, xb + (long long)s * P + p0 + pl);
    }
  } else {
    constexpr int kWords = TP / 2 + 1;  // covering words of one bf16 row
    for (int e = t; e < S * kWords; e += NT) {
      const int s = e / kWords, w = e % kWords;
      const size_t a = reinterpret_cast<size_t>(xb + (long long)s * P + p0);
      const int off = (int)((a >> 1) & 1);
      if (w < (off + n_t + 1) / 2)
        cp_async4(dst + (size_t)s * LD * sizeof(T) + 4 * w,
                  reinterpret_cast<const void*>((a & ~(size_t)3) + 4 * w));
    }
  }
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
    return to_f32(tile[s * LD + stream_row_off<T, VEC16>(xb + (long long)s * P + p0) + pl]);
  };

  auto issue = [&](int i) {
    if (i < ntile) {
      const int slot = i % geom.stages, p0 = (t_beg + i) * TP, n_t = min(TP, P - p0);
      issue_stream_tile<T, VEC16, kRoundThreads>(sm.tiles + (size_t)slot * tile_bytes, xb, S, P,
                                                 p0, n_t);
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
// The statistics of the blocked stream (nb, R, P) over its first S rows: the
// chunk of block b = blockIdx.y that CTA blockIdx.x owns, written as one
// record [n | mean | tri] ("Tile statistics" above), in three kinds:
//   kSecondMoment (init_stats_bsp; the XLA second moment of the masked bf16
//     stream, mag1c_pallas.py:1814-1824): sum xs xs^T of the centred stream,
//     which is zero wherever a pixel does not count; not re-centred, so the
//     record's mean stays 0 and the reduce divides by the given valid count.
//   kMeanFold (init_stats_stream; _init_stats_kernel :1164 on the raw f32
//     stream): the mean and the centred scatter by the running-mean Chan
//     fold, every pixel valid.
//   kCholesky (fused_iter CHOLESKY; _fused_iter_kernel :458-474): per pixel
//     the mf update, then the Chan fold of modx = x - m0c - g target,
//     g = cov_scale R mf, over the pixels whose valid byte is set.
//
// What bounds it: one read of the live rows (4 or 2 bytes per pixel and
// band) against the triangle's S (S + 1) / 2 FMAs per pixel. At S = 50 the
// two take about the same time on the H100 and the on-chip work (sweep,
// scatter, barriers) sets it, as in init_stats, whose design this follows:
//  * Tiles and the ring as round_bsp_chunk's: a tile is kRoundThreads
//    contiguous pixels of each live band row, staged band-major by cp.async
//    (issue_stream_tile) in a ring of 2-4 stages; rows S..R-1 are never
//    copied. kCholesky's R and mf_prev rows (4-byte copies) and the aligned
//    words that cover the tile's valid bytes ride in the tile's commit group.
//    A chunk is tiles_per_chunk consecutive tiles, sized for full waves at
//    kStatsCtasPerSm CTAs per SM (ops/mag1c_kernels.py:
//    stream_stats_geometry); the kernel checks the geometry.
//  * kCholesky's pixel stage: thread t < kRoundThreads takes pixel t of the
//    tile (the lanes of a warp read consecutive words of each staged row):
//    proj = cit.(x - m0c) - cit.mu, mf_new (mf_prev on the first call), g;
//    mf is stored coalesced and g staged for the sweep. A pixel whose valid
//    byte is 0 reads no value, gets mf = 0 and does not count. One barrier.
//  * The sweep: warp w owns the band quads w, w + kWarps, ..., its lane l the
//    pixels l + 32 j (again consecutive words of a staged row). It restages
//    each quad centred on the running mean as one float4 per pixel (0 where
//    the pixel does not count; bands past S 0) at stream_stats_pitch(S) =
//    8 ceil(S / 8) + 4 floats a pixel, an odd number of float4, so the 8
//    lanes of each quarter-warp store to 8 distinct bank groups. The quad's
//    sums over the tile come from one transposing butterfly (6 shuffles for
//    4 bands, a fixed order); __syncthreads_count counts the valid pixels.
//  * Then threads t < S form d and the new mean while every thread runs the
//    shared scatter; the rank-1 term waits for the next tile. A chunk's
//    first tile with valid pixels is centred on its own mean.
// f32 values and FMAs, no TF32 and no tensor cores; the records are
// combined in f64 by init_stats_reduce_kernel. Every sum runs in a fixed
// order, so a rerun is bitwise identical.
// ---------------------------------------------------------------------------
enum StreamStatsKind { kSecondMoment = 0, kMeanFold = 1, kCholesky = 2 };

// kCholesky's per-pixel rows in each stage, after the tile: R and mf_prev
// (kRoundThreads floats each), then the words that cover the valid bytes.
constexpr int kStatsPixBytes = 2 * 4 * kRoundThreads + kRoundThreads + 16;

// The static shared memory of a stream statistics CTA.
struct StreamStatsScratch {
  float bsum[kMaxBands];                     // the sweep's band sums of a tile
  float delta[kMaxBands], mean[kMaxBands];   // zero past S
  float m0c[kMaxBands], tgt[kMaxBands], cit[kMaxBands];  // kCholesky, zero past S
  float g[kRoundThreads];                    // kCholesky: cov_scale R mf of the tile
  float misc[4];                             // kCholesky: cit.mu, norm
};
static_assert(sizeof(StreamStatsScratch) == 3600, "ops/mag1c_kernels.py:STREAM_STATS_STATIC_SMEM");

// Floats of one restaged pixel: ceil(S / 8) 8-band groups and one float4
// more, an odd number of float4.
__host__ __device__ inline int stream_stats_pitch(int S) { return (S + 7) / 8 * 8 + 4; }

// Dynamic shared memory of a stream statistics CTA: the ring (stages x
// [tile | kCholesky's pixel rows]) and the centred tile, or the group sums
// at the chunk's end where those need more.
inline size_t stream_stats_smem_bytes(int stages, int tile_bytes, int S, bool pixel_rows) {
  const size_t ring = (size_t)stages * (tile_bytes + (pixel_rows ? kStatsPixBytes : 0)) +
                      (size_t)4 * kRoundThreads * stream_stats_pitch(S);
  const size_t groups = stats_group_bytes(S);
  return ring > groups ? ring : groups;
}

template <typename T, int KIND, bool VEC16>
__device__ __forceinline__ void stream_stats_chunk(
    const T* __restrict__ xs, const unsigned char* __restrict__ valid,
    const float* __restrict__ m0c, const float* __restrict__ carry, const float* __restrict__ r,
    const float* __restrict__ mf_in, float* __restrict__ mf_out, float* __restrict__ partial,
    bool first, int S, int R, int P, const RoundGeom& geom, int nchunks, float cov_scale) {
  constexpr bool MEAN = KIND != kSecondMoment, CHOL = KIND == kCholesky;
  constexpr int TP = kRoundThreads, LD = stream_row_pitch<T>(), J = TP / 32;
  extern __shared__ __align__(16) unsigned char stats_smem[];
  __shared__ StreamStatsScratch sc;
  const int tile_bytes = stream_tile_bytes<T>(S);
  const int stage_bytes = tile_bytes + (CHOL ? kStatsPixBytes : 0);
  const int nr = (S + 7) / 8, nq = (S + 3) / 4, pitch = stream_stats_pitch(S);
  float* ctile = reinterpret_cast<float*>(stats_smem + (size_t)geom.stages * stage_bytes);
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const T* xb = xs + (long long)b * R * P;
  const long long row0 = (long long)b * P;  // block b in the (nb, P) pixel rows
  const int tiles_block = (P + TP - 1) / TP;
  const int t_beg = c * geom.tiles_per_chunk;
  const int ntile = min(tiles_block, t_beg + geom.tiles_per_chunk) - t_beg;
  const int G = stats_groups(S);
  const ScatterRole sr = scatter_role(S);
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  if (t < kMaxBands) {
    sc.mean[t] = sc.delta[t] = 0.f;
    if constexpr (CHOL) {
      const float* cb = carry + (long long)b * 4 * S;
      const bool on = t < S;
      sc.m0c[t] = on && m0c != nullptr ? m0c[(long long)b * S + t] : 0.f;
      sc.tgt[t] = on ? cb[S + t] : 0.f;
      sc.cit[t] = on ? cb[2 * S + t] : 0.f;
      if (t == 0) {
        float citmu = 0.f;  // in band order
        for (int s = 0; s < S; ++s) citmu = fmaf(cb[2 * S + s], cb[s], citmu);
        sc.misc[0] = citmu;
        sc.misc[1] = cb[3 * S];
      }
    }
  }
  // The quads past ceil(S / 4) of every restaged pixel stay 0 (the sweeps
  // never write them; the odd float4 at the pixel's end is never read).
  const int npad = 2 * nr - nq;
  for (int e = t; e < TP * npad; e += kThreads)
    *reinterpret_cast<float4*>(ctile + (e / npad) * pitch + stats_spos(4 * (nq + e % npad), nr)) =
        make_float4(0.f, 0.f, 0.f, 0.f);

  // kCholesky's pixel rows of stage `slot`: R at [0, TP), mf_prev at
  // [TP, 2 TP), the valid bytes' words from 2 TP on.
  auto pix_rows = [&](int slot) {
    return reinterpret_cast<float*>(stats_smem + (size_t)slot * stage_bytes + tile_bytes);
  };

  auto issue = [&](int i) {
    if (i < ntile) {
      const int slot = i % geom.stages, p0 = (t_beg + i) * TP, n_t = min(TP, P - p0);
      issue_stream_tile<T, VEC16, kThreads>(stats_smem + (size_t)slot * stage_bytes, xb, S, P,
                                            p0, n_t);
      if constexpr (CHOL) {
        float* pr = pix_rows(slot);
        if (t < n_t) {
          cp_async4(pr + t, r + row0 + p0 + t);
          cp_async4(pr + TP + t, mf_in + row0 + p0 + t);
        }
        if (valid != nullptr) {
          // The aligned words that hold the bytes lie in the row's allocation.
          const size_t a = reinterpret_cast<size_t>(valid + row0 + p0);
          if (t < ((int)(a & 3) + n_t + 3) / 4)
            cp_async4(pr + 2 * TP + t, reinterpret_cast<const void*>((a & ~(size_t)3) + 4 * t));
        }
      }
    }
    cp_async_commit();
  };

  // Whether pixel pl of the tile at p0 (n_t pixels, stage `slot`) counts.
  auto counts = [&](int slot, int p0, int n_t, int pl) -> bool {
    if (pl >= n_t) return false;
    if constexpr (CHOL) {
      if (valid != nullptr) {
        const int off = (int)(reinterpret_cast<size_t>(valid + row0 + p0) & 3);
        return reinterpret_cast<const unsigned char*>(pix_rows(slot) + 2 * TP)[off + pl] != 0;
      }
    }
    return true;
  };

  // kCholesky's pixel stage (above): mf of pixel t into mf_out, g into sc.g.
  auto pixel_stage = [&](const T* tile, int slot, int p0, int n_t) {
    if (t >= TP) return;
    const float* pr = pix_rows(slot);
    float mf = 0.f, g = 0.f;
    if (counts(slot, p0, n_t, t)) {
      const float ru = pr[t], mf_prev = pr[TP + t];
      if (first) {
        mf = mf_prev;
      } else {
        float proj = 0.f;
        const T* src = xb + p0;  // row s of the tile's source
        for (int s = 0; s < S; ++s, src += P) {
          const float xv = to_f32(tile[s * LD + stream_row_off<T, VEC16>(src) + t]);
          proj = fmaf(sc.cit[s], xv - sc.m0c[s], proj);
        }
        const float reg = 1.f / (ru * (mf_prev + kEpsilon));
        mf = fmaxf((proj - sc.misc[0] - reg) / (ru * sc.misc[1]), 0.f);
      }
      g = cov_scale * (ru * mf);
    }
    if (t < n_t) mf_out[row0 + p0 + t] = mf;
    sc.g[t] = g;
  };

  // The sweep (above): with `write`, the tile's quads restaged centred in
  // ctile; their sums into sc.bsum (MEAN). Returns whether this thread's
  // own pixel t counts.
  auto sweep = [&](const T* tile, int slot, int p0, int n_t, bool write) {
    unsigned cnt = 0;  // bit j: pixel lane + 32 j counts
#pragma unroll
    for (int j = 0; j < J; ++j) cnt |= (unsigned)counts(slot, p0, n_t, lane + 32 * j) << j;
    for (int k = warp; k < nq; k += kWarps) {
      float sh[4], m0v[4], tg[4], sum[4];
      int off[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = 4 * k + q;
        sh[q] = sc.mean[s];  // 0 past S, and without MEAN
        m0v[q] = CHOL ? sc.m0c[s] : 0.f;
        tg[q] = CHOL ? sc.tgt[s] : 0.f;
        off[q] = stream_row_off<T, VEC16>(xb + (long long)min(s, S - 1) * P + p0);
        sum[q] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int pl = lane + 32 * j;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = 4 * k + q;
          v[q] = 0.f;
          if (((cnt >> j) & 1u) && s < S) {
            float xv = to_f32(tile[s * LD + off[q] + pl]);
            if constexpr (CHOL) xv = fmaf(-tg[q], sc.g[pl], xv - m0v[q]);
            v[q] = xv - sh[q];
          }
          sum[q] += v[q];
        }
        if (write)
          *reinterpret_cast<float4*>(ctile + pl * pitch + stats_spos(4 * k, nr)) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
      if constexpr (MEAN) {
        // Lane l ends with the sum over all 32 lanes of band 4 k + (l >> 3) % 4.
        const bool hi16 = lane & 16, hi8 = lane & 8;
        float a0 = hi16 ? sum[2] : sum[0], a1 = hi16 ? sum[3] : sum[1];
        a0 += __shfl_xor_sync(0xffffffffu, hi16 ? sum[0] : sum[2], 16);
        a1 += __shfl_xor_sync(0xffffffffu, hi16 ? sum[1] : sum[3], 16);
        float v = hi8 ? a1 : a0;
        v += __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if ((lane & 7) == 0) sc.bsum[4 * k + (lane >> 3)] = v;
      }
    }
    return t < TP && counts(slot, p0, n_t, t);
  };

  int n_run = 0;
  float coef = 0.f;  // the rank-1 term still to fold
  for (int i = 0; i < geom.stages - 1; ++i) issue(i);
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait_pending(geom.stages - 2);
    __syncthreads();  // tile i staged; tile i - 1's stage, ctile, g and bsum free; d, mean set
    issue(i + geom.stages - 1);
    fold_rank1(coef, sc.delta, sr, acc);
    coef = 0.f;
    const int slot = i % geom.stages, p0 = (t_beg + i) * TP, n_t = min(TP, P - p0);
    const T* tile = reinterpret_cast<const T*>(stats_smem + (size_t)slot * stage_bytes);
    if constexpr (CHOL) {
      pixel_stage(tile, slot, p0, n_t);
      __syncthreads();  // g of every pixel
    }
    int n_c = n_t;
    if constexpr (MEAN) {
      if (n_run == 0) {  // uniform: the first tile with valid pixels centres on its own mean
        const int n0 = __syncthreads_count(sweep(tile, slot, p0, n_t, false));
        if (t < S) sc.mean[t] = n0 > 0 ? sc.bsum[t] / (float)n0 : 0.f;
        __syncthreads();
        if (n0 == 0) continue;
      }
      n_c = __syncthreads_count(sweep(tile, slot, p0, n_t, true));
      if (n_c == 0) continue;  // uniform across the CTA
      const float n_new = (float)(n_run + n_c);
      if (t < S) {
        const float d = sc.bsum[t] / (float)n_c;
        sc.delta[t] = d;
        sc.mean[t] += d * ((float)n_c / n_new);
      }
      coef = -(float)n_c * ((float)n_c / n_new);
    } else {
      sweep(tile, slot, p0, n_t, true);
      __syncthreads();  // the restaged tile
    }
    scatter_pixels(reinterpret_cast<const float4*>(ctile), pitch / 4, nr, n_t, G, sr, acc);
    n_run += n_c;
  }
  cp_async_wait_pending(0);
  __syncthreads();  // the last d is set; the ring is free
  fold_rank1(coef, sc.delta, sr, acc);
  write_scatter_record(partial + ((long long)b * nchunks + c) * stats_record_len(S),
                       reinterpret_cast<float*>(stats_smem), n_run, sc.mean, sr, S, acc);
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

// A stream tile geometry's own fields against the stream: tiles of one row
// of kRoundThreads pixels, 16-byte copies only where every row starts on 16
// bytes.
template <typename T>
bool stream_tiles_ok(const RoundGeom& g, const void* xs, int P) {
  if (g.tile_rows != 1 || g.tile_cols != kRoundThreads) return false;
  return !g.aligned ||
         ((size_t)P * sizeof(T) % 16 == 0 && reinterpret_cast<size_t>(xs) % 16 == 0);
}

template <typename T>
bool stream_geom_ok(const RoundGeom& g, const void* xs, int S, int P, int nchunks) {
  return stream_tiles_ok<T>(g, xs, P) &&
         round_geom_ok(g, (P + kRoundThreads - 1) / kRoundThreads, nchunks,
                       stream_tile_bytes<T>(S));
}

// A stream statistics geometry (ops/mag1c_kernels.py:stream_stats_geometry)
// against the shapes; false refuses the launch.
template <typename T>
bool stream_stats_geom_ok(const RoundGeom& g, const void* xs, int S, int P, int nchunks,
                          bool pixel_rows) {
  return stream_tiles_ok<T>(g, xs, P) &&
         tiling_ok(g, (P + kRoundThreads - 1) / kRoundThreads, nchunks) &&
         (size_t)g.smem ==
             stream_stats_smem_bytes(g.stages, stream_tile_bytes<T>(S), S, pixel_rows) &&
         g.smem + sizeof(StreamStatsScratch) <= (size_t)kMaxRoundSmem;
}

// Launch a round kernel (NT = kRoundThreads) or a statistics kernel (NT =
// kThreads) on its (nchunks, nb) grid with the geometry's ring.
template <int NT = kRoundThreads, typename K, typename... Args>
cudaError_t launch_round_kernel(K kernel, dim3 grid, const RoundGeom& g, cudaStream_t st,
                                Args... args) {
  const cudaError_t err = allow_smem(kernel, (size_t)g.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, g.smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace
