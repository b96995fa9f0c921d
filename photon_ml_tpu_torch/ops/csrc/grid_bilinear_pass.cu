// K2, the grid-batched bilinear pass, for Hopper (sm_90a).
//
// Replaces photon_ml_tpu/ops/tiled_sparse.py::_grid_bilinear_pass, the
// operator that the custom_vmap rule of _bilinear_pass_auto swaps in when
// the optimizers run over a [G, d] coefficient bank (the batched lambda
// grid). It is K1's function for G source columns at once:
//
//   for every member g < G, step s and entry e < L:
//     out[g][step_out[s] * W + out_pos[s, e]] +=
//         vals[s, e] * src[g][step_in[s] * W + in_pos[s, e]]
//
// The schedule (in_pos, out_pos, vals: 12 bytes per entry) is shared by
// every member; only the source and the output carry the member axis.
//
// What bounds it: bytes. The schedule is the dominant traffic, so the
// point of K2 is to read each entry once for several members: at the ads
// shape with G = 4 that is ~200 MB of schedule plus 4 * G * (n_src + n_out)
// bytes of vectors, ~0.066 ms at the H100's 3.35 TB/s.
//
// Design (K1's, with a member tile; simple and right first):
// - Launch grid (n_seg, n_tiles). blockIdx.x is one segment of at most a
//   few steps of one output block (plan_segments, as in K1); blockIdx.y is
//   a tile of up to GT consecutive members. A CTA loads each entry's
//   (in_pos, out_pos, val) once and uses it for its GT members.
// - The accumulator holds the output window of each member of the tile in
//   shared memory, [GT][W] floats. The gathers and shared atomics are
//   latency-bound, so occupancy beats reuse: the host picks GT so that two
//   CTAs of 1024 threads fit on an SM (W * GT * 4 bytes within half the
//   227 KB opt-in: GT = 3 at the default window) and balances the tiles,
//   so G = 4 runs as two tiles of 2; the last tile may be short (gt < GT).
// - The source and the output are the optimizer's banks as they are,
//   [G, n_in] and [G, n_out] row-major, with int64 offsets; a member's
//   gathers are strided by n_in (a transposed [n, G] copy of the bank was
//   timed and was slower once its transposes are counted; PERF.md).
// - Accumulation is f32 with shared-memory atomicAdd, the flush global
//   atomicAdd into the zeroed output, as in K1; the order of additions
//   varies from run to run, so results match the plain version to f32
//   rounding, not bitwise.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and does not synchronise; the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // threads per CTA; two CTAs fill an SM
constexpr int kMaxGT = 8;  // members per CTA, at most

__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
grid_bilinear_pass_kernel(const int32_t* __restrict__ segments,  // [n_seg, 3]
                          const int32_t* __restrict__ step_in,   // [S]
                          const int32_t* __restrict__ in_pos,    // [S8, L]
                          const int32_t* __restrict__ out_pos,   // [S8, L]
                          const float* __restrict__ vals,        // [S8, L]
                          int L,
                          const float* __restrict__ src,  // [G, n_in]
                          int64_t n_in,
                          float* __restrict__ out,        // [G, n_out]
                          int64_t n_out, int window, int num_members, int gt_per_cta) {
  extern __shared__ float acc[];  // [gt][window]
  const int seg = blockIdx.x;
  const int out_block = segments[3 * seg];
  const int first = segments[3 * seg + 1];
  const int last = segments[3 * seg + 2];
  const int g0 = blockIdx.y * gt_per_cta;
  const int gt = min(gt_per_cta, num_members - g0);
  if (gt <= 0) return;

  for (int i = threadIdx.x; i < gt * window; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const float* src_tile = src + static_cast<int64_t>(g0) * n_in;
  for (int s = first; s < last; ++s) {
    const int64_t in_base = static_cast<int64_t>(step_in[s]) * window;
    const int64_t base = static_cast<int64_t>(s) * L;
    for (int e = threadIdx.x; e < L; e += kThreads) {
      const int ip = __ldg(in_pos + base + e);
      const int op = __ldg(out_pos + base + e);
      const float v = __ldg(vals + base + e);
      const float* p = src_tile + in_base + ip;
#pragma unroll
      for (int j = 0; j < kMaxGT; ++j) {
        if (j < gt) {
          atomicAdd(acc + j * window + op,
                    v * __ldg(p + static_cast<int64_t>(j) * n_in));
        }
      }
    }
  }
  __syncthreads();

  const int64_t out_base = static_cast<int64_t>(out_block) * window;
  for (int j = 0; j < gt; ++j) {
    float* dst = out + static_cast<int64_t>(g0 + j) * n_out + out_base;
    const float* a_j = acc + j * window;
    for (int i = threadIdx.x; i < window; i += kThreads) {
      const float a = a_j[i];
      // untouched slots add nothing; a NaN (a != a) still propagates
      if (a != 0.0f || a != a) atomicAdd(dst + i, a);
    }
  }
}

}  // namespace

extern "C" {

int photon_grid_bilinear_pass(const void* segments, int n_segments,
                              const void* step_in, const void* in_pos,
                              const void* out_pos, const void* vals, int L,
                              const void* src, int64_t n_in, void* out,
                              int64_t n_out, int window, int num_members, int gt_per_cta,
                              void* stream) {
  if (gt_per_cta < 1 || gt_per_cta > kMaxGT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(window) * gt_per_cta * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        grid_bilinear_pass_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (num_members + gt_per_cta - 1) / gt_per_cta;
  if (n_segments > 0 && n_tiles > 0) {
    dim3 grid(n_segments, n_tiles);
    grid_bilinear_pass_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(segments),
        static_cast<const int32_t*>(step_in),
        static_cast<const int32_t*>(in_pos),
        static_cast<const int32_t*>(out_pos),
        static_cast<const float*>(vals), L, static_cast<const float*>(src),
        n_in, static_cast<float*>(out), n_out, window, num_members,
        gt_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* photon_grid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
