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
// Every addition comes in an order fixed by the schedule and the work plan
// (bilinear_pass_core.cuh), so a schedule gives the same bits on every
// launch.
//
// What bounds it: bytes. Each entry is read once as 12 bytes (in_pos,
// out_pos, val) and does one multiply-add; at the ads shape (16.7M
// entries per pass) that is ~200 MB, ~60 us at the H100's 3.35 TB/s.
//
// The spill remainder (K3 in the JAX package: the tile tails its steps
// leave out, an XLA scatter-add after the Pallas kernel) is added in the
// same launch, where each output element is written once.
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
int launch(const photon::Pass& a, int n_items, const int32_t* shared,
           int n_shared, cudaStream_t stream, int* ctas) {
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
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(photon::launch_reduce(a, shared, n_shared, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int by_mode(const photon::Pass& a, int n_items, const int32_t* shared,
            int n_shared, int mode, cudaStream_t s, int* ctas) {
  switch (mode) {
    case STAGED: return launch<V, STAGED>(a, n_items, shared, n_shared, s, ctas);
    case GATHERED: return launch<V, GATHERED>(a, n_items, shared, n_shared, s, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// mode: STAGED or GATHERED (a photon::Mode; STAGED needs window % 4 == 0).
// items: [n_items, 7] (the plan's, with each item's scratch row); shared:
// [n_shared, 3] (block, first scratch row, rows); scratch: [rows, window]
// (may be null when n_shared = 0). spill_map, spill_offsets, spill_in and
// spill_vals: the spill remainder by output slot (bilinear_pass.SpillPlan;
// spill_map null: none), added to the pass's output. Launches the pass, then, when n_shared > 0, the
// reduction of the shared blocks, on one stream.
// With n_items = 0 it launches nothing and only reports the kernel's resident CTAs per SM in
// *ctas_per_sm.
int photon_bilinear_pass(const void* items, int n_items, const void* shared,
                         int n_shared, void* scratch, const void* step_in,
                         const void* step_sizes, const void* in_pos,
                         const void* out_pos, const void* vals, int L,
                         const void* src, void* out, int window, int vec,
                         int mode, const void* spill_map,
                         const void* spill_offsets, const void* spill_in,
                         const void* spill_vals,
                         int* ctas_per_sm, void* stream) {
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
  a.scratch = static_cast<float*>(scratch);
  a.window = window;
  a.num_members = 1;
  a.gt = 1;
  a.spill_map = static_cast<const int32_t*>(spill_map);
  a.spill_offsets = static_cast<const int32_t*>(spill_offsets);
  a.spill_in = static_cast<const int32_t*>(spill_in);
  a.spill_vals = static_cast<const float*>(spill_vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sh = static_cast<const int32_t*>(shared);
  return vec ? by_mode<4>(a, n_items, sh, n_shared, mode, s, ctas_per_sm)
             : by_mode<1>(a, n_items, sh, n_shared, mode, s, ctas_per_sm);
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
