// K1, the tiled bilinear pass, for Hopper (sm_90a).
//
// Replaces the Pallas kernel photon_ml_tpu/ops/tiled_sparse.py
// (_bilinear_pass_kernel, launched by _run_bilinear_pass). It computes the
// block-sparse matvec that a static schedule encodes:
//
//   for every step s (steps sorted by output block) and entry e:
//     out[step_out[s] * W + out_pos[s, e]] +=
//         vals[s, e] * src[step_in[s] * W + in_pos[s, e]]
//
// with W = S_HI * S_LO the window. The z-pass (X . w), the g-pass
// (X^T . c) and the Hessian-diagonal g-pass (values squared) are all this
// one function on different schedules and operands.
//
// What bounds it: bytes. Each entry is read once as 12 bytes (in_pos,
// out_pos, val) and does one multiply-add; at the ads shape (16.7M
// entries per pass) that is ~200 MB, ~60 us at the H100's 3.35 TB/s.
//
// The device code is bilinear_pass_core.cuh (shared with K2, which is the
// same core for a tile of members); its note says what the design does
// about the bound. The TPU kernel's one-hot compares, bf16 hi/lo split,
// (8, L) entry rows and sublane row selection answered TPU limits and are
// gone: the arithmetic is f32 with one rounding per product, like the
// reference's mxu="highest" numerics.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and does not synchronise; the return value is cudaGetLastError().

#include "bilinear_pass_core.cuh"

namespace {

using photon::GATHERED;
using photon::STAGED;

constexpr int kThreads = 512;  // per CTA: 2 resident CTAs per SM

template <int V, int MODE>
__global__ void __launch_bounds__(kThreads)
bilinear_pass_kernel(photon::Pass a) {
  photon::run_item<V, 1, MODE, kThreads>(a);
}

template <int V, int MODE>
int launch(const photon::Pass& a, int n_items, cudaStream_t stream, int* ctas) {
  // the accumulator, and staged two source windows
  const size_t smem = static_cast<size_t>(a.window) * sizeof(float) *
                      (MODE == STAGED ? 3 : 1);
  static size_t done_smem = 0;  // configured once per shared-memory size
  static int done_ctas = 0;
  if (done_smem != smem) {
    cudaError_t err = photon::configure(bilinear_pass_kernel<V, MODE>,
                                        kThreads, smem, &done_ctas);
    if (err != cudaSuccess) return static_cast<int>(err);
    done_smem = smem;
  }
  *ctas = done_ctas;
  if (n_items > 0) {
    bilinear_pass_kernel<V, MODE><<<n_items, kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int by_mode(const photon::Pass& a, int n_items, int mode, cudaStream_t s,
            int* ctas) {
  switch (mode) {
    case STAGED: return launch<V, STAGED>(a, n_items, s, ctas);
    case GATHERED: return launch<V, GATHERED>(a, n_items, s, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// mode: STAGED or GATHERED (a photon::Mode; STAGED needs window % 4 == 0).
// With n_items = 0 it launches nothing and only reports the kernel's resident CTAs per SM in
// *ctas_per_sm.
int photon_bilinear_pass(const void* items, int n_items, const void* step_in,
                         const void* step_sizes, const void* in_pos,
                         const void* out_pos, const void* vals, int L,
                         const void* src, void* out, int window, int vec,
                         int mode, int* ctas_per_sm, void* stream) {
  if (mode == STAGED && window % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  photon::Pass a;
  a.items = static_cast<const int32_t*>(items);
  a.step_in = static_cast<const int32_t*>(step_in);
  a.step_sizes = static_cast<const int32_t*>(step_sizes);
  a.in_pos = static_cast<const int32_t*>(in_pos);
  a.out_pos = static_cast<const int32_t*>(out_pos);
  a.vals = static_cast<const float*>(vals);
  a.L = L;
  a.src = static_cast<const float*>(src);
  a.n_in = 0;
  a.out = static_cast<float*>(out);
  a.n_out = 0;
  a.window = window;
  a.num_members = 1;
  a.gt = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? by_mode<4>(a, n_items, mode, s, ctas_per_sm)
             : by_mode<1>(a, n_items, mode, s, ctas_per_sm);
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
