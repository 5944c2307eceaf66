// woodbury_base: the matched filter's Woodbury base, once per filter, in one
// launch (one CTA per column block).
//
// It replaces no Pallas kernel: the JAX package computes the base between
// its kernels in XLA (starcop_tpu/ops/mag1c_pallas.py:_woodbury_base, :826,
// with the Schur-recursion inverse of starcop_tpu/ops/mag1c.py:181). The
// port's plain twin, ops/mag1c_kernels.py:_woodbury_base, runs that
// recursion eagerly: some 840 small kernels a filter, each waiting on the
// one before, while the card waits on the host. Here, per block b:
//
//   C0s   = C0 with its off-diagonal scaled by 1 - alpha (_shrink_diag)
//   C0s   = U^T U       Cholesky in f64, in shared memory
//   V     = U^-1        back substitution in f64
//   K0    = V V^T       = C0s^-1, each entry once (so exactly symmetric), f32
//   tgt0  = template * m0                           in f32, as the twin
//   cit0  = K0 tgt0 + K0 (tgt0 - C0s K0 tgt0)       f64 sums (_k0_solve_refined)
//   norm0 = tgt0 . cit0                             f64 sum
//
// the twin's arithmetic at a higher internal precision, no step left out. A
// block whose factor does not exist (a pivot not positive and finite: C0 = 0
// for a block with no valid pixel) gets NaN in k0, cit0 and norm0, as the
// twin does, and its tgt0; nothing faults and the host checks nothing.
//
// Bound: latency. A block reads C0 and writes K0, 2 nb S^2 4 bytes in all
// (0.46 MB at nb = 23, S = 50: 0.14 us at 3.35 TB/s), and does ~S^3 / 2 f64
// FMAs; what takes the time is the chain of S dependent pivot steps and the
// S-long substitutions. Each pivot step is kept short: the factor is
// right-looking and unscaled (W_ij -= W_ki W_kj / W_kk for k < i <= j, the
// upper triangle row-major), so a step is one pass of all 256 threads over
// the trailing triangle and one __syncthreads, with no column scaling
// between (U_kj = W_kj / sqrt(W_kk) is folded into the substitution). A
// warp updates one row: its lanes read row k and write row i contiguously
// and read W_ki as one broadcast. The substitution needs no barrier at all:
// thread j solves column j of V into row j of the lower triangle, which no
// other thread reads, so the S steps of a column run back to back; the
// pitch of a row is odd, so the lanes' rows fall in distinct banks.
//
// Interface: a plain C function taking raw pointers and the caller's
// stream; bindings.cpp registers it as a torch op. It returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBaseThreads = 256;
constexpr int kBaseWarps = kBaseThreads / 32;
constexpr int kBaseMaxBands = 128;

__device__ __forceinline__ double warp_sum64(double v) {
  // Butterfly: every lane ends with the same, bitwise identical sum.
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Odd row pitches: lanes that walk distinct rows at one column fall in
// distinct banks (a double spans two).
__host__ __device__ __forceinline__ int base_pitch(int S) { return S | 1; }

__host__ __device__ __forceinline__ size_t base_smem_bytes(int S) {
  const size_t p = (size_t)base_pitch(S);
  // W / V (f64), 5 f64 vectors, K0 (f32), cit0 (f32).
  return (size_t)S * p * 8 + 5 * (size_t)S * 8 + (size_t)S * p * 4 + (size_t)S * 4;
}

// C0s's off-diagonal entry, (1 - alpha) c as the twin's c + alpha (0 - c).
__device__ __forceinline__ double shrunk(float c, bool diag, double alpha) {
  const double v = (double)c;
  return diag ? v : v - alpha * v;
}

__global__ void __launch_bounds__(kBaseThreads)
woodbury_base_kernel(const float* __restrict__ c0_all, const float* __restrict__ m0_all,
                     const float* __restrict__ tmpl, float* __restrict__ k0_all,
                     float* __restrict__ tgt0_all, float* __restrict__ cit0_all,
                     float* __restrict__ norm0_all, int S, float alpha_f) {
  extern __shared__ __align__(16) unsigned char base_smem[];
  __shared__ int bad;
  const int P = base_pitch(S);
  double* w = reinterpret_cast<double*>(base_smem);  // upper: the factor W; lower: V
  double* rw = w + (size_t)S * P;                      // 1 / W_ii
  double* dinv = rw + S;                               // 1 / sqrt(W_ii) = V_ii
  double* tgt = dinv + S;
  double* y = tgt + S;                                 // K0 tgt0
  double* res = y + S;                                 // tgt0 - C0s y
  float* ks = reinterpret_cast<float*>(res + S);       // K0, both triangles
  float* citf = ks + (size_t)S * P;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c0 = c0_all + (size_t)b * S * S;
  const double alpha = (double)alpha_f;
  if (tid == 0) bad = 0;

  // The lower triangle of C0s into the upper one of w: w[i][j] = C0s[j][i].
  for (int e = tid; e < S * S; e += kBaseThreads) {
    const int r = e / S, c = e - r * S;
    if (r >= c) w[c * P + r] = shrunk(c0[e], r == c, alpha);
  }
  __syncthreads();

  // Right-looking, unscaled: after step k - 1 row k is final.
  for (int k = 0; k + 1 < S; ++k) {
    const double* wk = w + k * P;
    const double inv = 1.0 / wk[k];
    for (int i = k + 1 + warp; i < S; i += kBaseWarps) {
      const double f = wk[i] * inv;
      double* wi = w + i * P;
      for (int j = i + lane; j < S; j += 32) wi[j] = fma(-f, wk[j], wi[j]);
    }
    __syncthreads();
  }

  for (int i = tid; i < S; i += kBaseThreads) {
    const double piv = w[i * P + i];
    if (!(piv > 0.0 && piv < INFINITY)) bad = 1;
    rw[i] = 1.0 / piv;
    dinv[i] = 1.0 / sqrt(piv);
  }
  __syncthreads();

  // V = U^-1, U_ik = W_ik / sqrt(W_ii): column j of V, V_ij for i < j, into
  // w[j][i]; V_jj = dinv[j]. The threads share i, so W_ik is a broadcast.
  if (tid < S) {
    const int j = tid;
    const double* wj = w + j * P;
    for (int i = S - 2; i >= 0; --i) {
      if (j <= i) continue;
      const double* wi = w + i * P;
      double s0 = wi[j] * dinv[j], s1 = 0.0;
      int k = i + 1;
      for (; k + 1 < j; k += 2) {
        s0 = fma(wi[k], wj[k], s0);
        s1 = fma(wi[k + 1], wj[k + 1], s1);
      }
      if (k < j) s0 = fma(wi[k], wj[k], s0);
      w[j * P + i] = -rw[i] * (s0 + s1);
    }
  }
  __syncthreads();

  // K0_ij = sum_{k >= i} V_ik V_jk for j <= i: a warp a row i, its lanes
  // over j, so every lane of a warp runs the same k loop.
  for (int i = warp; i < S; i += kBaseWarps) {
    for (int j = lane; j <= i; j += 32) {
      double s = dinv[i] * (j == i ? dinv[i] : w[i * P + j]);
      for (int k = i + 1; k < S; ++k) s = fma(w[k * P + i], w[k * P + j], s);
      const float kf = (float)s;
      ks[i * P + j] = kf;
      ks[j * P + i] = kf;
    }
  }
  for (int i = tid; i < S; i += kBaseThreads) {
    const float t = tmpl[i] * m0_all[(size_t)b * S + i];
    tgt0_all[(size_t)b * S + i] = t;
    tgt[i] = (double)t;
  }
  __syncthreads();

  float* k0 = k0_all + (size_t)b * S * S;
  for (int e = tid; e < S * S; e += kBaseThreads) {
    const int r = e / S, c = e - r * S;
    k0[e] = bad ? NAN : ks[r * P + c];
  }
  // y = K0 tgt0, a warp a row.
  for (int i = warp; i < S; i += kBaseWarps) {
    double s = 0.0;
    for (int j = lane; j < S; j += 32) s = fma((double)ks[i * P + j], tgt[j], s);
    s = warp_sum64(s);
    if (lane == 0) y[i] = s;
  }
  __syncthreads();
  // res = tgt0 - C0s y, C0s read again from C0 (w no longer holds it).
  for (int i = warp; i < S; i += kBaseWarps) {
    double s = 0.0;
    for (int j = lane; j < S; j += 32) s = fma(shrunk(c0[i * S + j], i == j, alpha), y[j], s);
    s = warp_sum64(s);
    if (lane == 0) res[i] = tgt[i] - s;
  }
  __syncthreads();
  // cit0 = y + K0 res.
  float* cit0 = cit0_all + (size_t)b * S;
  for (int i = warp; i < S; i += kBaseWarps) {
    double s = 0.0;
    for (int j = lane; j < S; j += 32) s = fma((double)ks[i * P + j], res[j], s);
    s = warp_sum64(s);
    if (lane == 0) {
      const float c = (float)(y[i] + s);
      citf[i] = c;
      cit0[i] = bad ? NAN : c;
    }
  }
  __syncthreads();
  if (warp == 0) {
    double s = 0.0;
    for (int i = lane; i < S; i += 32) s = fma(tgt[i], (double)citf[i], s);
    s = warp_sum64(s);
    if (lane == 0) norm0_all[b] = bad ? NAN : (float)s;
  }
}

}  // namespace

extern "C" {

// c0 (nb, S, S), m0 (nb, S), tmpl (S,) -> k0 (nb, S, S), tgt0 and cit0
// (nb, S), norm0 (nb,); all f32, contiguous. 1 <= S <= 128; nb = 0 launches
// nothing.
int starcop_woodbury_base(const float* c0, const float* m0, const float* tmpl, float* k0,
                          float* tgt0, float* cit0, float* norm0, int S, int nb, float alpha,
                          void* stream) {
  if (S < 1 || S > kBaseMaxBands || nb < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const size_t smem = base_smem_bytes(S);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        woodbury_base_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  woodbury_base_kernel<<<nb, kBaseThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      c0, m0, tmpl, k0, tgt0, cit0, norm0, S, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
