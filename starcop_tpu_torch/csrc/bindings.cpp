// torch op registrations for the matched-filter kernels in mag1c.cu.
//
// The kernels have a plain C interface; this file checks every tensor
// (device, dtype, contiguity, shape) and passes raw pointers plus the
// caller's CUDA stream (an integer from torch.cuda.current_stream()). Outputs
// and scratch are allocated by the Python wrappers
// (starcop_tpu_torch/ops/mag1c_kernels.py). A refused launch raises.

#include <torch/library.h>

extern "C" {
int starcop_max_bands();
const char* starcop_error_string(int err);
int starcop_init_stats(const float* x, float* partial, float* m0, float* c0, int H, int W,
                       int S, int nb, int step, int chunk, int nchunks, void* stream);
int starcop_filter_round(int mode, const float* x, const float* m0, const float* carry,
                         float* r, const float* mf_in, float* mf_out, float* partial, int H,
                         int W, int S, int nb, int step, int chunk, int nchunks,
                         float cov_scale, void* stream);
int starcop_filter_glue(const float* partial, const float* carry_in, float* carry_out,
                        const float* m0, const float* tmpl, const float* k0, int S, int nb,
                        int nchunks, float nin, float alpha, void* stream);
}

namespace {

void check(const at::Tensor& t, const at::Tensor& like, const char* name,
           c10::IntArrayRef shape) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == like.device(), name, " must be on ", like.device());
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.sizes() == shape, name, " has shape ", t.sizes(), ", expected ", shape);
}

void check_launch(int err, const char* op) {
  TORCH_CHECK(err == 0, op, " launch failed: ", starcop_error_string(err));
}

struct Cube {
  int64_t h, w, s;
};

Cube check_cube(const at::Tensor& x, int64_t nb, int64_t step) {
  TORCH_CHECK(x.dim() == 3, "x must be an (H, W, S) cube");
  const Cube c{x.size(0), x.size(1), x.size(2)};
  check(x, x, "x", {c.h, c.w, c.s});
  TORCH_CHECK(c.w == nb * step, "scene width ", c.w, " must equal nb*step = ", nb * step);
  TORCH_CHECK(c.s >= 1 && c.s <= starcop_max_bands(), "band count ", c.s,
              " outside [1, ", starcop_max_bands(), "]");
  return c;
}

void init_stats(const at::Tensor& x, const at::Tensor& partial, const at::Tensor& m0,
                const at::Tensor& c0, int64_t nb, int64_t step, int64_t chunk,
                int64_t stream) {
  const Cube c = check_cube(x, nb, step);
  const int64_t nchunks = partial.size(1);
  TORCH_CHECK(nchunks * chunk >= c.h * step, "chunks do not cover the block");
  check(partial, x, "partial", {nb, nchunks, 1 + c.s + c.s * c.s});
  check(m0, x, "m0", {nb, c.s});
  check(c0, x, "c0", {nb, c.s, c.s});
  check_launch(starcop_init_stats(x.data_ptr<float>(), partial.data_ptr<float>(),
                                  m0.data_ptr<float>(), c0.data_ptr<float>(), c.h, c.w, c.s,
                                  nb, step, chunk, nchunks, reinterpret_cast<void*>(stream)),
               "init_stats");
}

void filter_round(int64_t mode, const at::Tensor& x, const at::Tensor& m0,
                  const at::Tensor& carry, const at::Tensor& r, const at::Tensor& mf_in,
                  const at::Tensor& mf_out, const at::Tensor& partial, int64_t nb,
                  int64_t step, int64_t chunk, double cov_scale, int64_t stream) {
  const Cube c = check_cube(x, nb, step);
  const int64_t p = c.h * step;
  const int64_t nchunks = partial.size(1);
  TORCH_CHECK(nchunks * chunk >= p, "chunks do not cover the block");
  check(m0, x, "m0", {nb, c.s});
  check(carry, x, "carry", {nb, 4, c.s});
  check(r, x, "r", {nb, p});
  check(mf_in, x, "mf_in", {nb, p});
  check(mf_out, x, "mf_out", {nb, p});
  check(partial, x, "partial", {nb, nchunks, c.s + 2});
  check_launch(
      starcop_filter_round(static_cast<int>(mode), x.data_ptr<float>(), m0.data_ptr<float>(),
                           carry.data_ptr<float>(), r.data_ptr<float>(),
                           mf_in.data_ptr<float>(), mf_out.data_ptr<float>(),
                           partial.data_ptr<float>(), c.h, c.w, c.s, nb, step, chunk, nchunks,
                           static_cast<float>(cov_scale), reinterpret_cast<void*>(stream)),
      "filter_round");
}

void filter_glue(const at::Tensor& partial, const at::Tensor& carry_in,
                 const at::Tensor& carry_out, const at::Tensor& m0, const at::Tensor& tmpl,
                 const at::Tensor& k0, double nin, double alpha, int64_t stream) {
  TORCH_CHECK(m0.dim() == 2, "m0 must be (nb, S)");
  const int64_t nb = m0.size(0), s = m0.size(1);
  TORCH_CHECK(partial.dim() == 3, "partial must be (nb, nchunks, S + 2)");
  check(partial, m0, "partial", {nb, partial.size(1), s + 2});
  check(carry_in, m0, "carry_in", {nb, 4, s});
  check(carry_out, m0, "carry_out", {nb, 4, s});
  check(m0, m0, "m0", {nb, s});
  check(tmpl, m0, "tmpl", {s});
  check(k0, m0, "k0", {nb, s, s});
  check_launch(starcop_filter_glue(partial.data_ptr<float>(), carry_in.data_ptr<float>(),
                                   carry_out.data_ptr<float>(), m0.data_ptr<float>(),
                                   tmpl.data_ptr<float>(), k0.data_ptr<float>(), s, nb,
                                   partial.size(1), static_cast<float>(nin),
                                   static_cast<float>(alpha), reinterpret_cast<void*>(stream)),
               "filter_glue");
}

}  // namespace

TORCH_LIBRARY(starcop_mag1c, m) {
  m.def("init_stats(Tensor x, Tensor(a!) partial, Tensor(b!) m0, Tensor(c!) c0, int nb, "
        "int step, int chunk, int stream) -> ()",
        &init_stats);
  m.def("filter_round(int mode, Tensor x, Tensor m0, Tensor carry, Tensor(a!) r, "
        "Tensor mf_in, Tensor(b!) mf_out, Tensor(c!) partial, int nb, int step, int chunk, "
        "float cov_scale, int stream) -> ()",
        &filter_round);
  m.def("filter_glue(Tensor partial, Tensor carry_in, Tensor(a!) carry_out, Tensor m0, "
        "Tensor tmpl, Tensor k0, float nin, float alpha, int stream) -> ()",
        &filter_glue);
}
