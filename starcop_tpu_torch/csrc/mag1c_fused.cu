// Hand-written Hopper (sm_90a) kernels of the matched filter's remaining
// routes: the band-major cube and acrwl1mf_fused's mono, woodbury and
// cholesky glues (starcop_tpu/ops/mag1c_pallas.py).
//
//   blocked_transpose_shw <- _blocked_transpose_shw_kernel (:295, row 3): the
//                            (S, H, nb*step) band-major cube to the f32
//                            blocked stream (nb, R, H*step).
//   fused_iter            <- _fused_iter_kernel (:386, row 4): one streaming
//                            pass per iteration, the glue between passes
//                            (filter_glue or torch). WOODBURY: mf and the records
//                            [u | sum g | sum g^2] (round_bsp_chunk); CHOLESKY:
//                            mf and the mean and centred covariance of modx
//                            (stream_stats_chunk).
//   filter_round_mono     <- _mono_first_kernel (:880, row 7) in FIRST,
//                            _mono_loop_kernel (:927, row 8) in LOOP / FINAL:
//                            one launch per iteration does the round AND the
//                            Woodbury glue.
//
// All three read the blocked stream (nb, R, P): band row s of block b is P
// contiguous values, R >= S rows, pixel p = h*step + j. The stream is f32 or
// bf16 and far larger than an SM or the 50 MB L2 (a 1280 x 54 x 50 f32 block
// is 13.8 MB), so each pass reads it once from HBM: every kernel here is
// bound by HBM bytes, fused_iter CHOLESKY's S x S scatter aside.
//
// Numerics: f32 values and FMAs, no TF32 and no tensor cores; cross-chunk
// reductions in f64 in a fixed order, so a rerun is bitwise identical.
//
// Interface: plain C functions taking raw pointers and the caller's stream;
// bindings.cpp registers them as torch ops. Each returns the cudaError_t of
// its launches.

#include "mag1c_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// blocked_transpose_shw: out[b, s, h*step + j] = x[s, h, b*step + j], rows
// S..R-1 zero; a bitwise copy. Each output band row of a block is H runs of
// step contiguous floats of one input band row. Thread q of a row writes
// element q (coalesced) and reads x[s, q / step, b*step + q % step]: a warp
// covers one or a few runs, each a contiguous span, so its loads coalesce
// into a few segments. kShwPerThread elements per thread, one row stride
// apart, keep several loads in flight. Bound by HBM bytes (one read, one
// write).
// ---------------------------------------------------------------------------
constexpr int kShwPerThread = 4;

__global__ void __launch_bounds__(kThreads)
blocked_transpose_shw_kernel(const float* __restrict__ x, float* __restrict__ out, int S, int R,
                             int H, int W, int step, int P) {
  const int s = blockIdx.y, b = blockIdx.z;
  float* orow = out + ((long long)b * R + s) * P;
  const int q0 = blockIdx.x * (kThreads * kShwPerThread) + threadIdx.x;
  if (s >= S) {
#pragma unroll
    for (int u = 0; u < kShwPerThread; ++u) {
      const int q = q0 + u * kThreads;
      if (q < P) orow[q] = 0.f;
    }
    return;
  }
  const float* xrow = x + (long long)s * H * W + (long long)b * step;
  float v[kShwPerThread];
#pragma unroll
  for (int u = 0; u < kShwPerThread; ++u) {
    const int q = q0 + u * kThreads;
    if (q < P) {
      const int h = q / step;
      v[u] = __ldg(xrow + (long long)h * W + (q - h * step));
    }
  }
#pragma unroll
  for (int u = 0; u < kShwPerThread; ++u) {
    const int q = q0 + u * kThreads;
    if (q < P) orow[q] = v[u];
  }
}

// ---------------------------------------------------------------------------
// fused_iter, WOODBURY: round_bsp_chunk in PASS (first) or LOOP mode, with
// the optional (B, P) valid row as the mask (H = 1, W = B*P, step = P). bf16
// is storage only (x_ref.astype(f32), :412): no bf16 dots.
// ---------------------------------------------------------------------------
template <typename T, int MODE, bool MASKED, bool CENTER, bool VEC16>
__global__ void __launch_bounds__(kRoundThreads, 4)
fused_iter_woodbury_kernel(const T* __restrict__ xs, const unsigned char* __restrict__ valid,
                           const float* __restrict__ m0, const float* __restrict__ carry,
                           const float* __restrict__ r, const float* __restrict__ mf_in,
                           float* __restrict__ mf_out, float* __restrict__ partial, int S, int R,
                           int P, RoundGeom geom, int nchunks, float cov_scale) {
  // r is only read in PASS and LOOP.
  round_bsp_chunk<T, MODE, MASKED, false, CENTER, VEC16>(
      xs, valid, m0, carry, const_cast<float*>(r), mf_in, mf_out, partial, gridDim.y * P, S, R, P,
      P, geom, nchunks, cov_scale);
}

// ---------------------------------------------------------------------------
// fused_iter, CHOLESKY, pass 1: stream_stats_chunk (mag1c_common.cuh,
// kCholesky) per (chunk, block): the mf update of every pixel and the chunk
// record of modx = x - m0c - cov_scale target R mf_new (:458-474) over the
// valid pixels. Pass 2 is init_stats_reduce_kernel: the block's mean of modx
// and its centred covariance, combined in f64, i.e. JAX's s1 / n and
// s2 / n - mu mu^T (:1966-1967) without the f32 cancellation. The stream T
// is f32 or bf16 (storage only, as WOODBURY); valid (nb, P) and m0c (which
// centres a raw f32 stream) are nullable.
// ---------------------------------------------------------------------------
template <typename T, bool VEC16>
__global__ void __launch_bounds__(kThreads, kStatsCtasPerSm)
fused_iter_cholesky_partial_kernel(int first, const T* __restrict__ xs,
                                   const unsigned char* __restrict__ valid,
                                   const float* __restrict__ m0c, const float* __restrict__ carry,
                                   const float* __restrict__ r, const float* __restrict__ mf_in,
                                   float* __restrict__ mf_out, float* __restrict__ partial, int S,
                                   int R, int P, RoundGeom geom, int nchunks, float cov_scale) {
  stream_stats_chunk<T, kCholesky, VEC16>(xs, valid, m0c, carry, r, mf_in, mf_out, partial,
                                          first != 0, S, R, P, geom, nchunks, cov_scale);
}

// ---------------------------------------------------------------------------
// filter_round_mono: round_bsp_chunk (FIRST, LOOP or FINAL) and then, unless
// FINAL, the Woodbury glue of its block in the same launch. The TPU kernel
// holds one block per grid step and streams it through a two-slot DMA ring;
// a 13.8 MB f32 block fits no SM, so here many CTAs share a block and the
// last one to finish runs the glue: each CTA writes its chunk record, fences
// (__threadfence) and adds one to its block's counter; the CTA that sees
// nchunks - 1 fences again, sums the block's records in a fixed order (so a
// rerun is bitwise identical) and runs glue_block, the math of filter_glue,
// into carry_out, then puts the counter back to 0, so the next launch finds
// it so. The caller zeroes the counters once per filter, in stream order,
// before its first launch. Unmasked: a pixel the
// caller's (B, P) weights exclude is 0 in the stream, so it gets R = 1 and
// mf = 0 (the regulariser pins it, as the TPU kernels do without a weight).
// ---------------------------------------------------------------------------
template <typename T, int MODE, bool BF16_DOTS, bool CENTER, bool VEC16>
__global__ void __launch_bounds__(kRoundThreads, 4)
filter_round_mono_kernel(const T* __restrict__ xs, const float* __restrict__ m0,
                         const float* __restrict__ carry_in, float* __restrict__ r,
                         const float* __restrict__ mf_in, float* __restrict__ mf_out,
                         float* __restrict__ partial, float* __restrict__ carry_out,
                         unsigned int* __restrict__ counter, const float* __restrict__ k0_all,
                         const float* __restrict__ tmpl, const float* __restrict__ nin_all, int S,
                         int R, int P, RoundGeom geom, int nchunks, float cov_scale, float alpha) {
  static_assert(kRoundThreads == kGlueThreads, "the last CTA runs the glue");
  round_bsp_chunk<T, MODE, false, BF16_DOTS, CENTER, VEC16>(xs, nullptr, m0, carry_in, r, mf_in,
                                                            mf_out, partial, 0, S, R, P, P, geom,
                                                            nchunks, cov_scale);
  if constexpr (MODE != kFinal) {
    // The glue's scratch and K0 reuse the round's ring (drained, no longer
    // read; the launch checks that it holds glue_smem_bytes(S)): no static
    // GlueSmem, so the ring keeps its CTAs per SM.
    extern __shared__ __align__(16) unsigned char round_smem[];
    GlueSmem& g = *reinterpret_cast<GlueSmem*>(round_smem);
    __shared__ bool last;
    const int b = blockIdx.y;
    __threadfence();  // this CTA's record before its count
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter + b, 1u) == (unsigned int)(nchunks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();  // every count seen: the records are visible
    glue_block(partial + (long long)b * nchunks * (S + 2), nchunks,
               carry_in + (long long)b * 4 * S, carry_out + (long long)b * 4 * S,
               m0 + (long long)b * S, tmpl, k0_all + (long long)b * S * S, nin_all[b], S, alpha,
               g, reinterpret_cast<float*>(round_smem + sizeof(GlueSmem)));
    if (threadIdx.x == 0) counter[b] = 0u;
  }
}

template <typename T, bool MASKED, bool CENTER, bool VEC16>
cudaError_t launch_woodbury_vec(int first, const T* xs, const unsigned char* valid,
                                const float* m0, const float* carry, const float* r,
                                const float* mf_in, float* mf_out, float* partial, int S, int R,
                                int P, const RoundGeom& g, int nchunks, int nb, float cov_scale,
                                cudaStream_t st) {
  const dim3 grid(nchunks, nb);
  if (first)
    return launch_round_kernel(fused_iter_woodbury_kernel<T, kPass, MASKED, CENTER, VEC16>, grid,
                               g, st, xs, valid, m0, carry, r, mf_in, mf_out, partial, S, R, P,
                               g, nchunks, cov_scale);
  return launch_round_kernel(fused_iter_woodbury_kernel<T, kLoop, MASKED, CENTER, VEC16>, grid, g,
                             st, xs, valid, m0, carry, r, mf_in, mf_out, partial, S, R, P, g,
                             nchunks, cov_scale);
}

template <typename T, bool MASKED, bool CENTER>
cudaError_t launch_woodbury_mode(int first, const void* xs_raw, const unsigned char* valid,
                                 const float* m0, const float* carry, const float* r,
                                 const float* mf_in, float* mf_out, float* partial, int S, int R,
                                 int P, const RoundGeom& g, int nchunks, int nb, float cov_scale,
                                 cudaStream_t st) {
  const T* xs = static_cast<const T*>(xs_raw);
  if (!stream_geom_ok<T>(g, xs, S, P, nchunks)) return cudaErrorInvalidValue;
  if (g.aligned)
    return launch_woodbury_vec<T, MASKED, CENTER, true>(first, xs, valid, m0, carry, r, mf_in,
                                                        mf_out, partial, S, R, P, g, nchunks, nb,
                                                        cov_scale, st);
  return launch_woodbury_vec<T, MASKED, CENTER, false>(first, xs, valid, m0, carry, r, mf_in,
                                                       mf_out, partial, S, R, P, g, nchunks, nb,
                                                       cov_scale, st);
}

template <typename T>
cudaError_t launch_cholesky(int first, const void* xs_raw, const unsigned char* valid,
                            const float* m0c, const float* carry, const float* r,
                            const float* mf_in, float* mf_out, float* partial, int S, int R,
                            int P, const RoundGeom& g, int nchunks, int nb, float cov_scale,
                            cudaStream_t st) {
  const T* xs = static_cast<const T*>(xs_raw);
  if (!stream_stats_geom_ok<T>(g, xs, S, P, nchunks, true)) return cudaErrorInvalidValue;
  const dim3 grid(nchunks, nb);
  if (g.aligned)
    return launch_round_kernel<kThreads>(fused_iter_cholesky_partial_kernel<T, true>, grid, g, st,
                                         first, xs, valid, m0c, carry, r, mf_in, mf_out, partial,
                                         S, R, P, g, nchunks, cov_scale);
  return launch_round_kernel<kThreads>(fused_iter_cholesky_partial_kernel<T, false>, grid, g, st,
                                       first, xs, valid, m0c, carry, r, mf_in, mf_out, partial, S,
                                       R, P, g, nchunks, cov_scale);
}

template <typename T, bool BF16_DOTS, bool CENTER, bool VEC16>
cudaError_t launch_mono_vec(int mode, const T* xs, const float* m0, const float* carry_in,
                            float* r, const float* mf_in, float* mf_out, float* partial,
                            float* carry_out, unsigned int* counter, const float* k0,
                            const float* tmpl, const float* nin, int S, int R, int P,
                            const RoundGeom& g, int nchunks, int nb, float cov_scale, float alpha,
                            cudaStream_t st) {
  const dim3 grid(nchunks, nb);
#define STARCOP_MONO(MODE)                                                                      \
  return launch_round_kernel(filter_round_mono_kernel<T, MODE, BF16_DOTS, CENTER, VEC16>, grid, \
                             g, st, xs, m0, carry_in, r, mf_in, mf_out, partial, carry_out,     \
                             counter, k0, tmpl, nin, S, R, P, g, nchunks, cov_scale, alpha)
  if (mode == kFirst) STARCOP_MONO(kFirst);
  if (mode == kLoop) STARCOP_MONO(kLoop);
  STARCOP_MONO(kFinal);
#undef STARCOP_MONO
}

template <typename T, bool BF16_DOTS, bool CENTER>
cudaError_t launch_mono_mode(int mode, const void* xs_raw, const float* m0,
                             const float* carry_in, float* r, const float* mf_in, float* mf_out,
                             float* partial, float* carry_out, unsigned int* counter,
                             const float* k0, const float* tmpl, const float* nin, int S, int R,
                             int P, const RoundGeom& g, int nchunks, int nb, float cov_scale,
                             float alpha, cudaStream_t st) {
  const T* xs = static_cast<const T*>(xs_raw);
  if (!stream_geom_ok<T>(g, xs, S, P, nchunks) || (size_t)g.smem < glue_smem_bytes(S))
    return cudaErrorInvalidValue;
  if (g.aligned)
    return launch_mono_vec<T, BF16_DOTS, CENTER, true>(mode, xs, m0, carry_in, r, mf_in, mf_out,
                                                       partial, carry_out, counter, k0, tmpl, nin,
                                                       S, R, P, g, nchunks, nb, cov_scale, alpha,
                                                       st);
  return launch_mono_vec<T, BF16_DOTS, CENTER, false>(mode, xs, m0, carry_in, r, mf_in, mf_out,
                                                      partial, carry_out, counter, k0, tmpl, nin,
                                                      S, R, P, g, nchunks, nb, cov_scale, alpha,
                                                      st);
}

// fused_iter's operands: the stream (nb, R, P) with S <= R live bands,
// stored f32 (f32 != 0) or bf16; valid (nb, P) uint8 or nullptr; center
// (f32 only, unmasked) subtracts m0 from the raw stream.
bool fused_iter_args_ok(int f32, const unsigned char* valid, int center, int S, int R) {
  return S >= 1 && S <= kMaxBands && R >= S && (f32 || !center) && (valid == nullptr || !center);
}

}  // namespace

extern "C" {

// The (S, H, nb*step) f32 cube -> the f32 blocked stream (nb, R, H*step).
int starcop_blocked_transpose_shw(const float* x, float* out, int S, int R, int H, int W, int nb,
                                  int step, void* stream) {
  if (S < 1 || R < S || R > 65535 || nb > 65535 || W != nb * step)
    return (int)cudaErrorInvalidValue;
  const int P = H * step;
  const dim3 grid((P + kThreads * kShwPerThread - 1) / (kThreads * kShwPerThread), R, nb);
  blocked_transpose_shw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, S, R, H, W, step, P);
  return (int)cudaGetLastError();
}

// One fused_iter WOODBURY pass: partial is (nb, nchunks, S + 2), one launch
// with the round geometry geom (the six RoundGeom fields).
int starcop_fused_iter_woodbury(int first, const void* xs, int f32, const unsigned char* valid,
                                int center, const float* m0, const float* carry, const float* r,
                                const float* mf_in, float* mf_out, float* partial, int nb, int S,
                                int R, int P, const int* geom, int nchunks, float cov_scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fused_iter_args_ok(f32, valid, center, S, R)) return (int)cudaErrorInvalidValue;
  const RoundGeom g = round_geom_from(geom);
#define STARCOP_WOODBURY(T, MASKED, CENTER)                                                  \
  return (int)launch_woodbury_mode<T, MASKED, CENTER>(first, xs, valid, m0, carry, r, mf_in, \
                                                      mf_out, partial, S, R, P, g, nchunks,  \
                                                      nb, cov_scale, st)
  if (f32) {
    if (valid != nullptr) STARCOP_WOODBURY(float, true, false);
    if (center) STARCOP_WOODBURY(float, false, true);
    STARCOP_WOODBURY(float, false, false);
  }
  if (valid != nullptr) STARCOP_WOODBURY(__nv_bfloat16, true, false);
  STARCOP_WOODBURY(__nv_bfloat16, false, false);
#undef STARCOP_WOODBURY
}

// One fused_iter CHOLESKY pass: partial is (nb, nchunks, stats_record_len(S))
// with the geometry geom of stream_stats_geometry (the six RoundGeom fields),
// then mean (nb, S), cov (nb, S, S) come from a second launch.
int starcop_fused_iter_cholesky(int first, const void* xs, int f32, const unsigned char* valid,
                                int center, const float* m0, const float* carry, const float* r,
                                const float* mf_in, float* mf_out, float* partial, float* mean,
                                float* cov, int nb, int S, int R, int P, const int* geom,
                                int nchunks, float cov_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fused_iter_args_ok(f32, valid, center, S, R)) return (int)cudaErrorInvalidValue;
  const RoundGeom g = round_geom_from(geom);
  const float* m0c = center ? m0 : nullptr;
  const cudaError_t err =
      f32 ? launch_cholesky<float>(first, xs, valid, m0c, carry, r, mf_in, mf_out, partial, S, R,
                                   P, g, nchunks, nb, cov_scale, st)
          : launch_cholesky<__nv_bfloat16>(first, xs, valid, m0c, carry, r, mf_in, mf_out,
                                           partial, S, R, P, g, nchunks, nb, cov_scale, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partial, nullptr, mean, cov, S, nchunks, nb, st);
}

// One mono round over the stream (nb, R, P): FIRST / LOOP write carry_out,
// FINAL writes mf * 1e5 only. f32: center subtracts m0 from a raw stream;
// bf16: the centred stream with bf16 dots. counter (nb,) must be 0. geom:
// the six RoundGeom fields.
int starcop_filter_round_mono(int mode, const void* xs, int f32, int center, const float* m0,
                              const float* carry_in, float* r, const float* mf_in, float* mf_out,
                              float* partial, float* carry_out, unsigned int* counter,
                              const float* k0, const float* tmpl, const float* nin, int nb,
                              int S, int R, int P, const int* geom, int nchunks, float cov_scale,
                              float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RoundGeom g = round_geom_from(geom);
  if (mode < kFirst || mode > kFinal || S < 1 || S > kGlueThreads || R < S || (!f32 && center))
    return (int)cudaErrorInvalidValue;
  if (f32 && center)
    return (int)launch_mono_mode<float, false, true>(mode, xs, m0, carry_in, r, mf_in, mf_out,
                                                     partial, carry_out, counter, k0, tmpl, nin,
                                                     S, R, P, g, nchunks, nb, cov_scale,
                                                     alpha, st);
  if (f32)
    return (int)launch_mono_mode<float, false, false>(mode, xs, m0, carry_in, r, mf_in, mf_out,
                                                      partial, carry_out, counter, k0, tmpl, nin,
                                                      S, R, P, g, nchunks, nb, cov_scale,
                                                      alpha, st);
  return (int)launch_mono_mode<__nv_bfloat16, true, false>(mode, xs, m0, carry_in, r, mf_in,
                                                           mf_out, partial, carry_out, counter,
                                                           k0, tmpl, nin, S, R, P, g,
                                                           nchunks, nb, cov_scale, alpha, st);
}

}  // extern "C"
