// K2, the grid-batched bilinear pass, for Hopper (sm_90a).
//
// Replaces photon_ml_tpu/ops/tiled_sparse.py::_grid_bilinear_pass, the
// operator that the custom_vmap rule of _bilinear_pass_auto swaps in when
// the optimizers run over a [G, d] coefficient bank (the batched lambda
// grid). It is K1's function for G source rows at once:
//
//   for every member g < G, step s and entry e:
//     out[g][step_out[s] * W + out_pos[s, e]] +=
//         vals[s, e] * src[g][step_in[s] * W + in_pos[s, e]]
//
// The schedule (in_pos, out_pos, vals: 12 bytes per entry) is shared by
// every member; only the source and the output carry the member axis.
//
// What bounds it: bytes. The schedule is the dominant traffic, so the
// point of K2 is to read each entry once for the whole bank: at the ads
// shape with G = 4 that is ~200 MB of schedule plus 4 * G * (n_src + n_out)
// bytes of vectors, ~0.066 ms at the H100's 3.35 TB/s.
//
// The device code is K1's (bilinear_pass_core.cuh), with its fixed order
// of additions, for a tile of GT members: launch grid (work items, member tiles); the accumulator holds
// the tile's output windows, [GT][W] f32 in shared memory, and each entry
// is loaded once for the tile's members. The host cuts the bank into as
// many tiles as still run in one wave (members_per_cta): the tiles' walks
// over the schedule then share it in L2, and a smaller tile gathers from
// fewer source windows, which must stay in L1 beside the accumulator. The
// source and the output are the optimizer's banks as they are, [G, n_in]
// and [G, n_out] row-major, with int64 offsets; a member's gathers are
// strided by n_in (a transposed [n, G] copy of the bank was timed and was
// slower once its transposes are counted; PERF.md).
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and does not synchronise; the return value is cudaGetLastError().

#include "bilinear_pass_core.cuh"

namespace {

using photon::GATHERED;

constexpr int kMaxGT = 7;      // members per CTA, at most
constexpr int kThreads = 1024;  // per CTA

template <int V, int GT>
__global__ void __launch_bounds__(kThreads)
grid_bilinear_pass_kernel(photon::Pass a) {
  photon::run_item<V, GT, GATHERED, kThreads>(a);
}

template <int V, int GT>
int launch(const photon::Pass& a, int n_items, const int32_t* shared,
           int n_shared, cudaStream_t stream, int* ctas) {
  static size_t done_smem = 0;  // configured once per shared-memory size
  static int done_ctas = 0;
  const size_t smem = static_cast<size_t>(a.window) * sizeof(float) * GT;
  if (done_smem != smem) {
    cudaError_t err = photon::configure(grid_bilinear_pass_kernel<V, GT>,
                                        kThreads, smem, &done_ctas);
    if (err != cudaSuccess) return static_cast<int>(err);
    done_smem = smem;
  }
  *ctas = done_ctas;
  const int n_tiles = (a.num_members + a.gt - 1) / a.gt;
  if (n_items > 0 && n_tiles > 0) {
    dim3 grid(n_items, n_tiles);
    grid_bilinear_pass_kernel<V, GT><<<grid, kThreads, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(photon::launch_reduce(a, shared, n_shared, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int by_tile(const photon::Pass& a, int n_items, const int32_t* sh,
            int n_sh, cudaStream_t s, int* ctas) {
  switch (a.gt) {
    case 1: return launch<V, 1>(a, n_items, sh, n_sh, s, ctas);
    case 2: return launch<V, 2>(a, n_items, sh, n_sh, s, ctas);
    case 3: return launch<V, 3>(a, n_items, sh, n_sh, s, ctas);
    case 4: return launch<V, 4>(a, n_items, sh, n_sh, s, ctas);
    case 5: return launch<V, 5>(a, n_items, sh, n_sh, s, ctas);
    case 6: return launch<V, 6>(a, n_items, sh, n_sh, s, ctas);
    case 7: return launch<V, 7>(a, n_items, sh, n_sh, s, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// gt_per_cta: members per CTA, 1..7. items, shared, scratch and the spill
// arrays as for K1's photon_bilinear_pass, with scratch [rows, num_members,
// window]; every member's spill sums are added to its output.
// With n_items = 0 it launches nothing and only reports the kernel's
// resident CTAs per SM in *ctas_per_sm.
int photon_grid_bilinear_pass(const void* items, int n_items,
                              const void* shared, int n_shared, void* scratch,
                              const void* step_in, const void* step_sizes,
                              const void* in_pos, const void* out_pos,
                              const void* vals, int L, const void* src,
                              int64_t n_in, void* out, int64_t n_out,
                              int window, int num_members, int gt_per_cta,
                              int vec, const void* spill_map,
                              const void* spill_offsets, const void* spill_in,
                              const void* spill_vals,
                              int* ctas_per_sm, void* stream) {
  if (gt_per_cta < 1 || gt_per_cta > kMaxGT) {
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
  a.n_in = n_in;
  a.out = static_cast<float*>(out);
  a.n_out = n_out;
  a.scratch = static_cast<float*>(scratch);
  a.window = window;
  a.num_members = num_members;
  a.gt = gt_per_cta;
  a.spill_map = static_cast<const int32_t*>(spill_map);
  a.spill_offsets = static_cast<const int32_t*>(spill_offsets);
  a.spill_in = static_cast<const int32_t*>(spill_in);
  a.spill_vals = static_cast<const float*>(spill_vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sh = static_cast<const int32_t*>(shared);
  return vec ? by_tile<4>(a, n_items, sh, n_shared, s, ctas_per_sm)
             : by_tile<1>(a, n_items, sh, n_shared, s, ctas_per_sm);
}

const char* photon_grid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
