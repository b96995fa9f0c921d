// K1, the tiled bilinear pass, for Hopper (sm_90a).
//
// Replaces the Pallas kernel photon_ml_tpu/ops/tiled_sparse.py
// (_bilinear_pass_kernel, launched by _run_bilinear_pass). It computes the
// block-sparse matvec that a static schedule encodes:
//
//   for every step s (steps sorted by output block) and entry e < L:
//     out[step_out[s] * W + out_pos[s, e]] +=
//         vals[s, e] * src[step_in[s] * W + in_pos[s, e]]
//
// with W = S_HI * S_LO the window. The z-pass (X . w), the g-pass
// (X^T . c) and the Hessian-diagonal g-pass (values squared) are all this
// one function on different schedules and operands.
//
// What bounds it: bytes. Each entry is read once as 12 bytes (in_pos,
// out_pos, val) and does one multiply-add; at the ads shape (16.7M
// entries per pass) that is ~200 MB, ~60 us at the H100's 3.35 TB/s. The
// gathered source window (32 KB) and the output window stay on chip.
//
// Design (a simple one that is right; making it fast is later work):
// - The TPU kernel's one-hot compares, bf16 hi/lo split, (8, L) entry rows
//   and sublane row selection answered TPU limits and are gone. The
//   arithmetic is f32 with one rounding per product, like the reference's
//   mxu="highest" numerics.
// - The host cuts each output block's run of steps into segments of at most
//   a few steps; one CTA owns one segment. That keeps enough CTAs in flight
//   (the z-pass at the ads shape has only 32 output blocks, which one CTA
//   per block would spread over 32 of 132 SMs).
// - A CTA zeroes a window-sized accumulator in shared memory, walks its
//   steps reading the entry arrays coalesced, gathers src through the
//   read-only path, accumulates with shared-memory atomicAdd, and flushes
//   the window into the (zeroed) output with global atomicAdd.
// - step_init is implied: the wrapper zeroes the output and every step of a
//   block adds into it, which equals "the first step of a block starts the
//   window" because a block's steps are consecutive (checked on the host).
// - Float atomics make the order of additions vary from run to run, so
//   results agree with the plain version to f32 rounding, not bitwise.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and does not synchronise; the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bilinear_pass_kernel(const int32_t* __restrict__ segments,  // [n_seg, 3]
                     const int32_t* __restrict__ step_in,   // [G]
                     const int32_t* __restrict__ in_pos,    // [G8, L]
                     const int32_t* __restrict__ out_pos,   // [G8, L]
                     const float* __restrict__ vals,        // [G8, L]
                     int L,
                     const float* __restrict__ src,  // [n_in_blocks * W]
                     float* __restrict__ out,        // [n_out_blocks * W]
                     int window) {
  extern __shared__ float acc[];
  const int seg = blockIdx.x;
  const int out_block = segments[3 * seg];
  const int first = segments[3 * seg + 1];
  const int last = segments[3 * seg + 2];

  for (int i = threadIdx.x; i < window; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  for (int s = first; s < last; ++s) {
    const float* win = src + static_cast<int64_t>(step_in[s]) * window;
    const int64_t base = static_cast<int64_t>(s) * L;
    for (int e = threadIdx.x; e < L; e += kThreads) {
      const int ip = __ldg(in_pos + base + e);
      const int op = __ldg(out_pos + base + e);
      const float v = __ldg(vals + base + e);
      atomicAdd(acc + op, v * __ldg(win + ip));
    }
  }
  __syncthreads();

  float* dst = out + static_cast<int64_t>(out_block) * window;
  for (int i = threadIdx.x; i < window; i += kThreads) {
    const float a = acc[i];
    // untouched slots add nothing; a NaN (a != a) still propagates
    if (a != 0.0f || a != a) atomicAdd(dst + i, a);
  }
}

}  // namespace

extern "C" {

int photon_bilinear_pass(const void* segments, int n_segments,
                         const void* step_in, const void* in_pos,
                         const void* out_pos, const void* vals, int L,
                         const void* src, void* out, int window,
                         void* stream) {
  const size_t smem = static_cast<size_t>(window) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_segments > 0) {
    bilinear_pass_kernel<<<n_segments, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(segments),
        static_cast<const int32_t*>(step_in),
        static_cast<const int32_t*>(in_pos),
        static_cast<const int32_t*>(out_pos),
        static_cast<const float*>(vals), L, static_cast<const float*>(src),
        static_cast<float*>(out), window);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
