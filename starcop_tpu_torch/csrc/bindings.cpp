// torch op registrations for the matched-filter kernels in mag1c.cu and
// mag1c_fused.cu.
//
// The kernels have a plain C interface; this file checks every tensor
// (device, dtype, contiguity, shape) and passes raw pointers plus the
// caller's CUDA stream (an integer from torch.cuda.current_stream()). Outputs
// and scratch are allocated by the Python wrappers
// (starcop_tpu_torch/ops/mag1c_kernels.py). A refused launch raises.

#include <torch/library.h>

#include <initializer_list>
#include <tuple>
#include <utility>

extern "C" {
int starcop_max_bands();
const char* starcop_error_string(int err);
int starcop_init_stats(const float* x, const unsigned char* valid, float* partial, float* m0,
                       float* c0, int H, int W, int S, int nb, int step, const int* geom,
                       int nchunks, void* stream);
int starcop_filter_round(int mode, const float* x, const unsigned char* valid, const float* m0,
                         const float* carry, float* r, const float* mf_in, float* mf_out,
                         float* partial, int H, int W, int S, int nb, int step, const int* geom,
                         int nchunks, float cov_scale, void* stream);
int starcop_filter_glue(const float* partial, const float* carry_in, float* carry_out,
                        const float* m0, const float* tmpl, const float* k0, const float* nin,
                        int S, int nb, int nchunks, float alpha, void* stream);
int starcop_blocked_transpose(const float* x, const float* m0, const unsigned char* valid,
                              void* out, int H, int W, int S, int R, int nb, int step,
                              const int* geom, void* stream);
int starcop_init_stats_bsp(const void* xs, const float* n_given, float* partial, float* c0,
                           int nb, int S, int R, int P, const int* geom, int nchunks,
                           void* stream);
int starcop_init_stats_stream(const float* xs, float* partial, float* m0, float* c0, int nb,
                              int S, int R, int P, const int* geom, int nchunks, void* stream);
int starcop_filter_round_bsp(int mode, const void* xs, int f32, const unsigned char* valid,
                             int bf16_dots, int center, const float* m0, const float* carry,
                             float* r, const float* mf_in, float* mf_out, float* partial, int H,
                             int W, int S, int R, int nb, int step, const int* geom, int nchunks,
                             float cov_scale, void* stream);
int starcop_blocked_transpose_shw(const float* x, float* out, int S, int R, int H, int W, int nb,
                                  int step, void* stream);
int starcop_fused_iter_woodbury(int first, const void* xs, int f32, const unsigned char* valid,
                                int center, const float* m0, const float* carry, const float* r,
                                const float* mf_in, float* mf_out, float* partial, int nb, int S,
                                int R, int P, const int* geom, int nchunks, float cov_scale,
                                void* stream);
int starcop_fused_iter_cholesky(int first, const void* xs, int f32, const unsigned char* valid,
                                int center, const float* m0, const float* carry, const float* r,
                                const float* mf_in, float* mf_out, float* partial, float* mean,
                                float* cov, int nb, int S, int R, int P, const int* geom,
                                int nchunks, float cov_scale, void* stream);
int starcop_filter_round_mono(int mode, const void* xs, int f32, int center, const float* m0,
                              const float* carry_in, float* r, const float* mf_in, float* mf_out,
                              float* partial, float* carry_out, unsigned int* counter,
                              const float* k0, const float* tmpl, const float* nin, int nb,
                              int S, int R, int P, const int* geom, int nchunks, float cov_scale,
                              float alpha, void* stream);
}

namespace {

void check(const at::Tensor& t, const at::Tensor& like, const char* name,
           c10::IntArrayRef shape, at::ScalarType dtype = at::kFloat) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == like.device(), name, " must be on ", like.device());
  TORCH_CHECK(t.scalar_type() == dtype, name, " must be ", dtype);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.sizes() == shape, name, " has shape ", t.sizes(), ", expected ", shape);
}

void check_launch(int err, const char* op) {
  TORCH_CHECK(err == 0, op, " launch failed: ", starcop_error_string(err));
}

struct Cube {
  int64_t h, w, s;
};

// Unmasked, the width must be exactly nb*step; masked (``valid`` given),
// the last block may be ragged: (nb - 1)*step < W <= nb*step.
Cube check_cube(const at::Tensor& x, int64_t nb, int64_t step, const at::Tensor* valid) {
  TORCH_CHECK(x.dim() == 3, "x must be an (H, W, S) cube");
  const Cube c{x.size(0), x.size(1), x.size(2)};
  check(x, x, "x", {c.h, c.w, c.s});
  if (valid == nullptr) {
    TORCH_CHECK(c.w == nb * step, "scene width ", c.w, " must equal nb*step = ", nb * step);
  } else {
    TORCH_CHECK(nb >= 1 && (nb - 1) * step < c.w && c.w <= nb * step, "scene width ", c.w,
                " does not give nb = ", nb, " blocks of ", step, " columns");
    check(*valid, x, "valid", {c.h, c.w}, at::kByte);
  }
  TORCH_CHECK(c.s >= 1 && c.s <= starcop_max_bands(), "band count ", c.s,
              " outside [1, ", starcop_max_bands(), "]");
  return c;
}

// The launch geometry of a round, of the statistics (cube or stream) or of
// blocked_transpose (ops/mag1c_kernels.py:RoundGeometry.op_args): tile
// rows, tile columns, tiles per chunk, stages, 16-byte copies, shared
// memory bytes. The kernels check it against the shapes.
struct Geom {
  int v[6];
};

Geom round_geom(c10::IntArrayRef geom) {
  TORCH_CHECK(geom.size() == 6, "geom must hold 6 ints, got ", geom.size());
  Geom g;
  for (int i = 0; i < 6; ++i) {
    TORCH_CHECK(geom[i] >= 0 && geom[i] <= (1 << 30), "geom[", i, "] out of range");
    g.v[i] = static_cast<int>(geom[i]);
  }
  return g;
}

const unsigned char* mask_ptr(const at::Tensor* valid) {
  return valid == nullptr ? nullptr : valid->data_ptr<uint8_t>();
}

// Floats of one statistics record [n | mean(S) | lower triangle of S x S].
int64_t stats_record_len(int64_t s) { return 1 + s + s * (s + 1) / 2; }

void run_init_stats(const at::Tensor& x, const at::Tensor* valid, const at::Tensor& partial,
                    const at::Tensor& m0, const at::Tensor& c0, int64_t nb, int64_t step,
                    c10::IntArrayRef geom, int64_t stream, const char* op) {
  const Cube c = check_cube(x, nb, step, valid);
  const int64_t nchunks = partial.size(1);
  const Geom g = round_geom(geom);
  check(partial, x, "partial", {nb, nchunks, stats_record_len(c.s)});
  check(m0, x, "m0", {nb, c.s});
  check(c0, x, "c0", {nb, c.s, c.s});
  check_launch(starcop_init_stats(x.data_ptr<float>(), mask_ptr(valid), partial.data_ptr<float>(),
                                  m0.data_ptr<float>(), c0.data_ptr<float>(), c.h, c.w, c.s, nb,
                                  step, g.v, nchunks, reinterpret_cast<void*>(stream)),
               op);
}

void init_stats(const at::Tensor& x, const at::Tensor& partial, const at::Tensor& m0,
                const at::Tensor& c0, int64_t nb, int64_t step, c10::IntArrayRef geom,
                int64_t stream) {
  run_init_stats(x, nullptr, partial, m0, c0, nb, step, geom, stream, "init_stats");
}

void init_stats_masked(const at::Tensor& x, const at::Tensor& valid, const at::Tensor& partial,
                       const at::Tensor& m0, const at::Tensor& c0, int64_t nb, int64_t step,
                       c10::IntArrayRef geom, int64_t stream) {
  run_init_stats(x, &valid, partial, m0, c0, nb, step, geom, stream, "init_stats_masked");
}

void run_filter_round(int64_t mode, const at::Tensor& x, const at::Tensor* valid,
                      const at::Tensor& m0, const at::Tensor& carry, const at::Tensor& r,
                      const at::Tensor& mf_in, const at::Tensor& mf_out,
                      const at::Tensor& partial, int64_t nb, int64_t step,
                      c10::IntArrayRef geom, double cov_scale, int64_t stream, const char* op) {
  const Cube c = check_cube(x, nb, step, valid);
  const int64_t p = c.h * step;
  const int64_t nchunks = partial.size(1);
  const Geom g = round_geom(geom);
  check(m0, x, "m0", {nb, c.s});
  check(carry, x, "carry", {nb, 4, c.s});
  check(r, x, "r", {nb, p});
  check(mf_in, x, "mf_in", {nb, p});
  check(mf_out, x, "mf_out", {nb, p});
  check(partial, x, "partial", {nb, nchunks, c.s + 2});
  check_launch(
      starcop_filter_round(static_cast<int>(mode), x.data_ptr<float>(), mask_ptr(valid),
                           m0.data_ptr<float>(), carry.data_ptr<float>(), r.data_ptr<float>(),
                           mf_in.data_ptr<float>(), mf_out.data_ptr<float>(),
                           partial.data_ptr<float>(), c.h, c.w, c.s, nb, step, g.v, nchunks,
                           static_cast<float>(cov_scale), reinterpret_cast<void*>(stream)),
      op);
}

void filter_round(int64_t mode, const at::Tensor& x, const at::Tensor& m0,
                  const at::Tensor& carry, const at::Tensor& r, const at::Tensor& mf_in,
                  const at::Tensor& mf_out, const at::Tensor& partial, int64_t nb,
                  int64_t step, c10::IntArrayRef geom, double cov_scale, int64_t stream) {
  run_filter_round(mode, x, nullptr, m0, carry, r, mf_in, mf_out, partial, nb, step, geom,
                   cov_scale, stream, "filter_round");
}

void filter_round_masked(int64_t mode, const at::Tensor& x, const at::Tensor& valid,
                         const at::Tensor& m0, const at::Tensor& carry, const at::Tensor& r,
                         const at::Tensor& mf_in, const at::Tensor& mf_out,
                         const at::Tensor& partial, int64_t nb, int64_t step,
                         c10::IntArrayRef geom, double cov_scale, int64_t stream) {
  run_filter_round(mode, x, &valid, m0, carry, r, mf_in, mf_out, partial, nb, step, geom,
                   cov_scale, stream, "filter_round_masked");
}

void filter_glue(const at::Tensor& partial, const at::Tensor& carry_in,
                 const at::Tensor& carry_out, const at::Tensor& m0, const at::Tensor& tmpl,
                 const at::Tensor& k0, const at::Tensor& nin, double alpha, int64_t stream) {
  TORCH_CHECK(m0.dim() == 2, "m0 must be (nb, S)");
  const int64_t nb = m0.size(0), s = m0.size(1);
  TORCH_CHECK(partial.dim() == 3, "partial must be (nb, nchunks, S + 2)");
  check(partial, m0, "partial", {nb, partial.size(1), s + 2});
  check(carry_in, m0, "carry_in", {nb, 4, s});
  check(carry_out, m0, "carry_out", {nb, 4, s});
  check(m0, m0, "m0", {nb, s});
  check(tmpl, m0, "tmpl", {s});
  check(k0, m0, "k0", {nb, s, s});
  check(nin, m0, "nin", {nb});
  check_launch(starcop_filter_glue(partial.data_ptr<float>(), carry_in.data_ptr<float>(),
                                   carry_out.data_ptr<float>(), m0.data_ptr<float>(),
                                   tmpl.data_ptr<float>(), k0.data_ptr<float>(),
                                   nin.data_ptr<float>(), s, nb, partial.size(1),
                                   static_cast<float>(alpha), reinterpret_cast<void*>(stream)),
               "filter_glue");
}

// The blocked stream (nb, R, P), R >= S band rows, stored ``dtype``.
void check_stream(const at::Tensor& xs, const at::Tensor& like, int64_t nb, int64_t rows,
                  int64_t p, at::ScalarType dtype = at::kBFloat16) {
  check(xs, like, "xs", {nb, rows, p}, dtype);
  TORCH_CHECK(rows >= 1 && rows <= starcop_max_bands(), "stream rows ", rows,
              " outside [1, ", starcop_max_bands(), "]");
}

// The stream's storage: true for f32, false for bf16; anything else raises.
bool stream_is_f32(const at::Tensor& xs) {
  TORCH_CHECK(xs.dim() == 3, "xs must be (nb, R, P)");
  const auto dt = xs.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kBFloat16, "xs must be float32 or bfloat16");
  return dt == at::kFloat;
}

// The per-pixel rows of a stream filter pass, each (nb, P) f32.
void check_rows(const at::Tensor& like, int64_t nb, int64_t p,
                std::initializer_list<std::pair<const at::Tensor*, const char*>> rows) {
  for (const auto& [t, name] : rows) check(*t, like, name, {nb, p});
}

void blocked_transpose(const at::Tensor& x, const at::Tensor& m0,
                       const std::optional<at::Tensor>& valid, const at::Tensor& out,
                       int64_t nb, int64_t step, c10::IntArrayRef geom, int64_t stream) {
  const Cube c = check_cube(x, nb, step, valid ? &*valid : nullptr);
  const Geom g = round_geom(geom);
  TORCH_CHECK(out.dim() == 3, "out must be (nb, R, H*step)");
  const int64_t rows = out.size(1);
  TORCH_CHECK(rows >= c.s, "out has ", rows, " band rows for ", c.s, " bands");
  check_stream(out, x, nb, rows, c.h * step);
  check(m0, x, "m0", {nb, c.s});
  check_launch(starcop_blocked_transpose(x.data_ptr<float>(), m0.data_ptr<float>(),
                                         valid ? valid->data_ptr<uint8_t>() : nullptr,
                                         out.data_ptr(), c.h, c.w, c.s, rows, nb, step, g.v,
                                         reinterpret_cast<void*>(stream)),
               "blocked_transpose");
}

void init_stats_bsp(const at::Tensor& xs, const at::Tensor& n, const at::Tensor& partial,
                    const at::Tensor& c0, c10::IntArrayRef geom, int64_t stream) {
  TORCH_CHECK(xs.dim() == 3 && c0.dim() == 3, "xs must be (nb, R, P) and c0 (nb, S, S)");
  const int64_t nb = xs.size(0), rows = xs.size(1), p = xs.size(2), s = c0.size(1);
  check_stream(xs, xs, nb, rows, p);
  TORCH_CHECK(s >= 1 && s <= rows, "c0 has ", s, " bands for a stream of ", rows, " rows");
  const Geom g = round_geom(geom);
  const int64_t nchunks = partial.size(1);
  check(partial, xs, "partial", {nb, nchunks, stats_record_len(s)});
  check(c0, xs, "c0", {nb, s, s});
  check(n, xs, "n", {nb});
  check_launch(starcop_init_stats_bsp(xs.data_ptr(), n.data_ptr<float>(),
                                      partial.data_ptr<float>(), c0.data_ptr<float>(), nb, s,
                                      rows, p, g.v, nchunks, reinterpret_cast<void*>(stream)),
               "init_stats_bsp");
}

void filter_round_bsp(int64_t mode, const at::Tensor& xs, const std::optional<at::Tensor>& valid,
                      bool bf16_dots, bool center, const at::Tensor& m0, const at::Tensor& carry,
                      const at::Tensor& r, const at::Tensor& mf_in, const at::Tensor& mf_out,
                      const at::Tensor& partial, int64_t step, c10::IntArrayRef geom,
                      double cov_scale, int64_t stream) {
  const bool f32 = stream_is_f32(xs);
  const Geom g = round_geom(geom);
  TORCH_CHECK(m0.dim() == 2, "m0 must be (nb, S)");
  const int64_t nb = xs.size(0), rows = xs.size(1), p = xs.size(2), s = m0.size(1);
  check_stream(xs, xs, nb, rows, p, xs.scalar_type());
  TORCH_CHECK(s >= 1 && s <= rows, "m0 has ", s, " bands for a stream of ", rows, " rows");
  TORCH_CHECK(!(f32 && bf16_dots), "bf16 dots read a bf16 stream");
  TORCH_CHECK(!center || (f32 && !valid), "only an unmasked f32 stream is centred in the kernel");
  TORCH_CHECK(step >= 1 && p % step == 0, "P = ", p, " is not H * step for step ", step);
  const int64_t h = p / step;
  int64_t w = nb * step;
  if (valid) {
    TORCH_CHECK(valid->dim() == 2 && valid->size(0) == h, "valid must be (H, W) with H = ", h);
    w = valid->size(1);
    TORCH_CHECK((nb - 1) * step < w && w <= nb * step, "valid width ", w, " does not give nb = ",
                nb, " blocks of ", step, " columns");
    check(*valid, xs, "valid", {h, w}, at::kByte);
  }
  const int64_t nchunks = partial.size(1);
  check(m0, xs, "m0", {nb, s});
  check(carry, xs, "carry", {nb, 4, s});
  check_rows(xs, nb, p, {{&r, "r"}, {&mf_in, "mf_in"}, {&mf_out, "mf_out"}});
  check(partial, xs, "partial", {nb, nchunks, s + 2});
  check_launch(starcop_filter_round_bsp(
                   static_cast<int>(mode), xs.data_ptr(), f32,
                   valid ? valid->data_ptr<uint8_t>() : nullptr, bf16_dots, center,
                   m0.data_ptr<float>(), carry.data_ptr<float>(), r.data_ptr<float>(),
                   mf_in.data_ptr<float>(), mf_out.data_ptr<float>(), partial.data_ptr<float>(),
                   h, w, s, rows, nb, step, g.v, nchunks, static_cast<float>(cov_scale),
                   reinterpret_cast<void*>(stream)),
               "filter_round_bsp");
}

void init_stats_stream(const at::Tensor& xs, const at::Tensor& partial, const at::Tensor& m0,
                       const at::Tensor& c0, c10::IntArrayRef geom, int64_t stream) {
  TORCH_CHECK(xs.dim() == 3 && m0.dim() == 2, "xs must be (nb, R, P) and m0 (nb, S)");
  const int64_t nb = xs.size(0), rows = xs.size(1), p = xs.size(2), s = m0.size(1);
  check_stream(xs, xs, nb, rows, p, at::kFloat);
  TORCH_CHECK(s >= 1 && s <= rows, "m0 has ", s, " bands for a stream of ", rows, " rows");
  const Geom g = round_geom(geom);
  const int64_t nchunks = partial.size(1);
  check(partial, xs, "partial", {nb, nchunks, stats_record_len(s)});
  check(m0, xs, "m0", {nb, s});
  check(c0, xs, "c0", {nb, s, s});
  check_launch(starcop_init_stats_stream(xs.data_ptr<float>(), partial.data_ptr<float>(),
                                         m0.data_ptr<float>(), c0.data_ptr<float>(), nb, s, rows,
                                         p, g.v, nchunks, reinterpret_cast<void*>(stream)),
               "init_stats_stream");
}

void blocked_transpose_shw(const at::Tensor& x, const at::Tensor& out, int64_t nb, int64_t step,
                           int64_t stream) {
  TORCH_CHECK(x.dim() == 3, "x must be an (S, H, W) cube");
  const int64_t s = x.size(0), h = x.size(1), w = x.size(2);
  check(x, x, "x", {s, h, w});
  TORCH_CHECK(w == nb * step, "scene width ", w, " must equal nb*step = ", nb * step);
  TORCH_CHECK(out.dim() == 3, "out must be (nb, R, H*step)");
  const int64_t rows = out.size(1);
  TORCH_CHECK(rows >= s, "out has ", rows, " band rows for ", s, " bands");
  check_stream(out, x, nb, rows, h * step, at::kFloat);
  check_launch(starcop_blocked_transpose_shw(x.data_ptr<float>(), out.data_ptr<float>(), s, rows,
                                             h, w, nb, step, reinterpret_cast<void*>(stream)),
               "blocked_transpose_shw");
}

// The shared checks of the two fused_iter ops; returns (nb, S, R, P, f32).
std::tuple<int64_t, int64_t, int64_t, int64_t, bool> check_fused_iter(
    const at::Tensor& xs, const std::optional<at::Tensor>& valid, bool center,
    const at::Tensor& m0, const at::Tensor& carry, const at::Tensor& r, const at::Tensor& mf_in,
    const at::Tensor& mf_out) {
  const bool f32 = stream_is_f32(xs);
  TORCH_CHECK(m0.dim() == 2, "m0 must be (nb, S)");
  const int64_t nb = xs.size(0), rows = xs.size(1), p = xs.size(2), s = m0.size(1);
  check_stream(xs, xs, nb, rows, p, xs.scalar_type());
  TORCH_CHECK(s >= 1 && s <= rows, "m0 has ", s, " bands for a stream of ", rows, " rows");
  TORCH_CHECK(!center || (f32 && !valid), "only an unmasked f32 stream is centred in the kernel");
  if (valid) check(*valid, xs, "valid", {nb, p}, at::kByte);
  check(m0, xs, "m0", {nb, s});
  check(carry, xs, "carry", {nb, 4, s});
  check_rows(xs, nb, p, {{&r, "r"}, {&mf_in, "mf_in"}, {&mf_out, "mf_out"}});
  return {nb, s, rows, p, f32};
}

void fused_iter_woodbury(bool first, const at::Tensor& xs, const std::optional<at::Tensor>& valid,
                         bool center, const at::Tensor& m0, const at::Tensor& carry,
                         const at::Tensor& r, const at::Tensor& mf_in, const at::Tensor& mf_out,
                         const at::Tensor& partial, c10::IntArrayRef geom, double cov_scale,
                         int64_t stream) {
  const auto [nb, s, rows, p, f32] = check_fused_iter(xs, valid, center, m0, carry, r, mf_in,
                                                      mf_out);
  const Geom g = round_geom(geom);
  const int64_t nchunks = partial.size(1);
  check(partial, xs, "partial", {nb, nchunks, s + 2});
  check_launch(starcop_fused_iter_woodbury(first, xs.data_ptr(), f32,
                                           valid ? valid->data_ptr<uint8_t>() : nullptr, center,
                                           m0.data_ptr<float>(), carry.data_ptr<float>(),
                                           r.data_ptr<float>(), mf_in.data_ptr<float>(),
                                           mf_out.data_ptr<float>(), partial.data_ptr<float>(),
                                           nb, s, rows, p, g.v, nchunks,
                                           static_cast<float>(cov_scale),
                                           reinterpret_cast<void*>(stream)),
               "fused_iter_woodbury");
}

void fused_iter_cholesky(bool first, const at::Tensor& xs, const std::optional<at::Tensor>& valid,
                         bool center, const at::Tensor& m0, const at::Tensor& carry,
                         const at::Tensor& r, const at::Tensor& mf_in, const at::Tensor& mf_out,
                         const at::Tensor& partial, const at::Tensor& mean, const at::Tensor& cov,
                         c10::IntArrayRef geom, double cov_scale, int64_t stream) {
  const auto [nb, s, rows, p, f32] = check_fused_iter(xs, valid, center, m0, carry, r, mf_in,
                                                      mf_out);
  const Geom g = round_geom(geom);
  const int64_t nchunks = partial.size(1);
  check(partial, xs, "partial", {nb, nchunks, stats_record_len(s)});
  check(mean, xs, "mean", {nb, s});
  check(cov, xs, "cov", {nb, s, s});
  check_launch(starcop_fused_iter_cholesky(first, xs.data_ptr(), f32,
                                           valid ? valid->data_ptr<uint8_t>() : nullptr, center,
                                           m0.data_ptr<float>(), carry.data_ptr<float>(),
                                           r.data_ptr<float>(), mf_in.data_ptr<float>(),
                                           mf_out.data_ptr<float>(), partial.data_ptr<float>(),
                                           mean.data_ptr<float>(), cov.data_ptr<float>(), nb, s,
                                           rows, p, g.v, nchunks,
                                           static_cast<float>(cov_scale),
                                           reinterpret_cast<void*>(stream)),
               "fused_iter_cholesky");
}

void filter_round_mono(int64_t mode, const at::Tensor& xs, bool center, const at::Tensor& m0,
                       const at::Tensor& carry_in, const at::Tensor& r, const at::Tensor& mf_in,
                       const at::Tensor& mf_out, const at::Tensor& partial,
                       const at::Tensor& carry_out, const at::Tensor& counter,
                       const at::Tensor& k0, const at::Tensor& tmpl, const at::Tensor& nin,
                       c10::IntArrayRef geom, double cov_scale, double alpha, int64_t stream) {
  const bool f32 = stream_is_f32(xs);
  const Geom g = round_geom(geom);
  TORCH_CHECK(m0.dim() == 2, "m0 must be (nb, S)");
  const int64_t nb = xs.size(0), rows = xs.size(1), p = xs.size(2), s = m0.size(1);
  check_stream(xs, xs, nb, rows, p, xs.scalar_type());
  TORCH_CHECK(s >= 1 && s <= rows, "m0 has ", s, " bands for a stream of ", rows, " rows");
  TORCH_CHECK(!center || f32, "only an f32 stream is centred in the kernel");
  const int64_t nchunks = partial.size(1);
  check(m0, xs, "m0", {nb, s});
  check(carry_in, xs, "carry_in", {nb, 4, s});
  check(carry_out, xs, "carry_out", {nb, 4, s});
  check_rows(xs, nb, p, {{&r, "r"}, {&mf_in, "mf_in"}, {&mf_out, "mf_out"}});
  check(partial, xs, "partial", {nb, nchunks, s + 2});
  check(counter, xs, "counter", {nb}, at::kInt);
  check(k0, xs, "k0", {nb, s, s});
  check(tmpl, xs, "tmpl", {s});
  check(nin, xs, "nin", {nb});
  check_launch(starcop_filter_round_mono(
                   static_cast<int>(mode), xs.data_ptr(), f32, center, m0.data_ptr<float>(),
                   carry_in.data_ptr<float>(), r.data_ptr<float>(), mf_in.data_ptr<float>(),
                   mf_out.data_ptr<float>(), partial.data_ptr<float>(),
                   carry_out.data_ptr<float>(),
                   reinterpret_cast<unsigned int*>(counter.data_ptr<int32_t>()),
                   k0.data_ptr<float>(), tmpl.data_ptr<float>(), nin.data_ptr<float>(), nb, s,
                   rows, p, g.v, nchunks, static_cast<float>(cov_scale),
                   static_cast<float>(alpha), reinterpret_cast<void*>(stream)),
               "filter_round_mono");
}

}  // namespace

TORCH_LIBRARY(starcop_mag1c, m) {
  m.def("init_stats(Tensor x, Tensor(a!) partial, Tensor(b!) m0, Tensor(c!) c0, int nb, "
        "int step, int[] geom, int stream) -> ()",
        &init_stats);
  m.def("init_stats_masked(Tensor x, Tensor valid, Tensor(a!) partial, Tensor(b!) m0, "
        "Tensor(c!) c0, int nb, int step, int[] geom, int stream) -> ()",
        &init_stats_masked);
  m.def("filter_round(int mode, Tensor x, Tensor m0, Tensor carry, Tensor(a!) r, "
        "Tensor mf_in, Tensor(b!) mf_out, Tensor(c!) partial, int nb, int step, int[] geom, "
        "float cov_scale, int stream) -> ()",
        &filter_round);
  m.def("filter_round_masked(int mode, Tensor x, Tensor valid, Tensor m0, Tensor carry, "
        "Tensor(a!) r, Tensor mf_in, Tensor(b!) mf_out, Tensor(c!) partial, int nb, int step, "
        "int[] geom, float cov_scale, int stream) -> ()",
        &filter_round_masked);
  m.def("filter_glue(Tensor partial, Tensor carry_in, Tensor(a!) carry_out, Tensor m0, "
        "Tensor tmpl, Tensor k0, Tensor nin, float alpha, int stream) -> ()",
        &filter_glue);
  m.def("blocked_transpose(Tensor x, Tensor m0, Tensor? valid, Tensor(a!) out, int nb, "
        "int step, int[] geom, int stream) -> ()",
        &blocked_transpose);
  m.def("init_stats_bsp(Tensor xs, Tensor n, Tensor(a!) partial, Tensor(b!) c0, int[] geom, "
        "int stream) -> ()",
        &init_stats_bsp);
  m.def("filter_round_bsp(int mode, Tensor xs, Tensor? valid, bool bf16_dots, bool center, "
        "Tensor m0, Tensor carry, Tensor(a!) r, Tensor mf_in, Tensor(b!) mf_out, "
        "Tensor(c!) partial, int step, int[] geom, float cov_scale, int stream) -> ()",
        &filter_round_bsp);
  m.def("init_stats_stream(Tensor xs, Tensor(a!) partial, Tensor(b!) m0, Tensor(c!) c0, "
        "int[] geom, int stream) -> ()",
        &init_stats_stream);
  m.def("blocked_transpose_shw(Tensor x, Tensor(a!) out, int nb, int step, int stream) -> ()",
        &blocked_transpose_shw);
  m.def("fused_iter_woodbury(bool first, Tensor xs, Tensor? valid, bool center, Tensor m0, "
        "Tensor carry, Tensor r, Tensor mf_in, Tensor(a!) mf_out, Tensor(b!) partial, "
        "int[] geom, float cov_scale, int stream) -> ()",
        &fused_iter_woodbury);
  m.def("fused_iter_cholesky(bool first, Tensor xs, Tensor? valid, bool center, Tensor m0, "
        "Tensor carry, Tensor r, Tensor mf_in, Tensor(a!) mf_out, Tensor(b!) partial, "
        "Tensor(c!) mean, Tensor(d!) cov, int[] geom, float cov_scale, int stream) -> ()",
        &fused_iter_cholesky);
  m.def("filter_round_mono(int mode, Tensor xs, bool center, Tensor m0, Tensor carry_in, "
        "Tensor(a!) r, Tensor mf_in, Tensor(b!) mf_out, Tensor(c!) partial, "
        "Tensor(d!) carry_out, Tensor(e!) counter, Tensor k0, Tensor tmpl, Tensor nin, "
        "int[] geom, float cov_scale, float alpha, int stream) -> ()",
        &filter_round_mono);
}
