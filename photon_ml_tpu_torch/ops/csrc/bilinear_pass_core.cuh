// The device code of K1 (bilinear_pass.cu) and K2 (grid_bilinear_pass.cu),
// the tiled bilinear pass for Hopper (sm_90a). K1 is this core for one
// member; K2 for a tile of GT members of a [G, n] bank.
//
// Function, for every member g of the CTA's tile, step s and entry e < the
// step's real size:
//
//   out[g][step_out[s] * W + out_pos[s, e]] +=
//       vals[s, e] * src[g][step_in[s] * W + in_pos[s, e]]
//
// What bounds it: bytes. Each entry is read once as 12 bytes (in_pos,
// out_pos, val); the gathered source windows and the output windows stay on
// chip (L1 and shared memory).
//
// Design:
// - Work sized to the pass. The host cuts the pass into work items
//   (bilinear_pass.plan_work): a contiguous run of one output block's
//   entries, as many items as the card holds CTAs at once, so the pass is
//   one wave and no CTA walks more than its share. An item may start or end
//   inside a step (a pass with fewer steps than CTA slots splits steps).
// - Loads in flight. Each thread takes V = 4 consecutive entries per trip
//   with 16-byte loads that bypass L1 (rows of L % 4 != 0 take V = 1); the
//   V (x members) gathers and adds of a trip are independent.
// - Source windows (Mode): STAGED copies each step's input window into
//   shared memory with cp.async while the CTA walks the previous step
//   (walk_staged, one member a CTA), so every gather is a shared-memory
//   load; GATHERED reads the windows through L1 for all the tile's members
//   (walk_gathered). The host picks by the order of a pass's gathers, which
//   it observes on the schedule (bilinear_pass.default_mode): where they
//   fall at random in the window each lane of a warp would take an L1 line
//   of its own, so K1 stages; where they come in order a warp's gathers
//   share lines, so K1 reads through L1. K2 reads through L1 either way.
//   (A register double buffer of each thread's next trip's entries was
//   timed and was slower: its registers cost resident CTAs; PERF.md.)
// - A step ends at its real size (step_sizes): padding slots are never
//   read, gathered or added (they used to pile onto slot 0). So a NaN or
//   an infinity in a window's first source slot, which the plain version
//   carries through the padding's 0 * src into slot 0 of the output block,
//   reaches only the outputs that a real entry adds it to.
// - An item with no steps (s_last < s_first: an output block without
//   steps) only writes its zero windows.
// - The accumulator is the tile's output windows in shared memory, [GT][W]
//   f32, added to with shared atomics. An item alone on its output block
//   stores its windows with plain 16-byte stores into an uninitialised
//   output; items that share a block add with 16-byte global atomics, into
//   a zeroed output, only the quads they touched (NaN != 0, so a NaN that a
//   real entry adds still reaches the output).
// - K2 reads an entry once for all GT members of its tile; the host picks
//   the tiles (grid_bilinear_pass.members_per_cta).
// - Float atomics make the order of additions vary from run to run, so
//   results agree with the plain version to f32 rounding, not bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace photon {

// Columns of a work item (bilinear_pass.ITEM_COLUMNS).
constexpr int kItemColumns = 6;
constexpr int kReservedSmemPerCta = 1024;  // the SM's own reserve per CTA
constexpr int kSmemPerSm = 228 * 1024;      // shared memory an SM can hold

struct Pass {
  const int32_t* items;       // [n_items, kItemColumns]
  const int32_t* step_in;     // [S]
  const int32_t* step_sizes;  // [S] real entries of each step
  const int32_t* in_pos;      // [S8, L]
  const int32_t* out_pos;     // [S8, L]
  const float* vals;          // [S8, L]
  int L;
  const float* src;  // [G, n_in]
  int64_t n_in;
  float* out;  // [G, n_out]
  int64_t n_out;
  int window;
  int num_members;
  int gt;  // members per CTA (the last tile may hold fewer)
};

__device__ __forceinline__ int4 load_stream_v4(const int32_t* p) {
  int4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float4 load_stream_v4(const float* p) {
  float4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}

template <int V>
struct Entries {
  int ip[V];
  int op[V];
  float v[V];
};

template <int V>
__device__ __forceinline__ void load_entries(const Pass& a, int64_t at,
                                             Entries<V>& e) {
  if constexpr (V == 4) {
    const int4 i = load_stream_v4(a.in_pos + at);
    const int4 o = load_stream_v4(a.out_pos + at);
    const float4 v = load_stream_v4(a.vals + at);
    e.ip[0] = i.x; e.ip[1] = i.y; e.ip[2] = i.z; e.ip[3] = i.w;
    e.op[0] = o.x; e.op[1] = o.y; e.op[2] = o.z; e.op[3] = o.w;
    e.v[0] = v.x; e.v[1] = v.y; e.v[2] = v.z; e.v[3] = v.w;
  } else {
    e.ip[0] = __ldg(a.in_pos + at);
    e.op[0] = __ldg(a.out_pos + at);
    e.v[0] = __ldg(a.vals + at);
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(at), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;");  // all but the newest group done
}

// Walk the item's entries for one member (g) with the source window staged
// in shared memory: each step's window of the input block is copied
// (cp.async, 16 bytes a thread, bypassing L1) into one of two buffers while
// the previous step is walked from the other, so every gather is a
// shared-memory load. bufs: [2][W].
template <int V, int THREADS>
__device__ __forceinline__ void walk_staged(const Pass& a, float* acc,
                                            float* bufs, int s_first,
                                            int e_first, int s_last,
                                            int e_end, int g) {
  const int W = a.window;
  const float* src = a.src + static_cast<int64_t>(g) * a.n_in;
  auto stage = [&](int s, float* buf) {
    const float* win = src + static_cast<int64_t>(__ldg(a.step_in + s)) * W;
    for (int i = threadIdx.x; i < W / 4; i += THREADS) {
      cp_async16(buf + 4 * i, win + 4 * i);
    }
  };
  const int lane0 = V * static_cast<int>(threadIdx.x);  // first entry
  stage(s_first, bufs);
  cp_async_commit();
  for (int s = s_first, parity = 0; s <= s_last; ++s, parity ^= 1) {
    if (s < s_last) stage(s + 1, bufs + (parity ^ 1) * W);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const float* buf = bufs + parity * W;
    const int hi = s == s_last ? e_end : __ldg(a.step_sizes + s);
    const int lo = s == s_first ? e_first : 0;
    for (int e0 = lo + lane0; e0 < hi; e0 += V * THREADS) {
      Entries<V> cur;
      load_entries<V>(a, static_cast<int64_t>(s) * a.L + e0, cur);
      float x[V];
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = e0 + k < hi ? buf[cur.ip[k]] : 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (e0 + k < hi) atomicAdd(acc + cur.op[k], cur.v[k] * x[k]);
      }
    }
    __syncthreads();  // the buffer is restaged two steps on
  }
}

// Walk the item's entries with every gather read through L1, for all GT
// members of the tile at once (one entry load serves them all).
template <int V, int GT, int THREADS>
__device__ __forceinline__ void walk_gathered(const Pass& a, float* acc,
                                              int s_first, int e_first,
                                              int s_last, int e_end, int g0,
                                              int gt) {
  const int W = a.window;
  // A thread's cursor: the step s and its slot v (V entries each) among
  // that step's slots, from the item's first entry on.
  int s = s_first, v = threadIdx.x;
  int lo = 0, hi = 0;
  auto seek = [&]() -> bool {
    for (; s <= s_last; ++s) {
      hi = s == s_last ? e_end : __ldg(a.step_sizes + s);
      lo = s == s_first ? e_first / V : 0;
      const int n = (hi + V - 1) / V - lo;
      if (v < n) return true;
      v -= max(n, 0);
    }
    return false;
  };

  bool have = seek();
  while (have) {
    const int cs = s, e0 = (lo + v) * V, chi = hi;
    Entries<V> cur;
    load_entries<V>(a, static_cast<int64_t>(cs) * a.L + e0, cur);
    v += THREADS;
    have = seek();  // the next trip's step, while this trip's entries load

    const float* win = a.src + static_cast<int64_t>(g0) * a.n_in +
                       static_cast<int64_t>(__ldg(a.step_in + cs)) * W;
    float x[GT][V];
#pragma unroll
    for (int j = 0; j < GT; ++j) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        x[j][k] = (j < gt && e0 + k < chi)
                      ? __ldg(win + static_cast<int64_t>(j) * a.n_in + cur.ip[k])
                      : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < GT; ++j) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (j < gt && e0 + k < chi) {
          atomicAdd(acc + j * W + cur.op[k], cur.v[k] * x[j][k]);
        }
      }
    }
  }
}

// Write the tile's windows: plain stores where the item is its block's only
// writer, else 16-byte atomics of the quads it touched.
__device__ __forceinline__ void flush(const Pass& a, const float* acc,
                                      int block, bool sole, int g0, int gt,
                                      int W, bool quads, int threads) {
  for (int j = 0; j < gt; ++j) {
    float* dst = a.out + static_cast<int64_t>(g0 + j) * a.n_out +
                 static_cast<int64_t>(block) * W;
    const float* acc_j = acc + j * W;
    if (quads) {
      float4* dst4 = reinterpret_cast<float4*>(dst);
      const float4* acc4 = reinterpret_cast<const float4*>(acc_j);
      for (int i = threadIdx.x; i < W / 4; i += threads) {
        const float4 x = acc4[i];
        if (sole) {
          dst4[i] = x;
        } else if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f) {
          atomicAdd(dst4 + i, x);  // untouched quads add nothing
        }
      }
    } else {
      for (int i = threadIdx.x; i < W; i += threads) {
        const float x = acc_j[i];
        if (sole) {
          dst[i] = x;
        } else if (x != 0.f) {
          atomicAdd(dst + i, x);
        }
      }
    }
  }
}

// How a CTA reads the source windows: STAGED copies each step's window into
// shared memory (one member a CTA); GATHERED reads them through L1.
enum Mode {
  STAGED = 0,
  GATHERED = 1,
};

// One CTA: one work item (blockIdx.x) for one member tile (blockIdx.y).
// V entries per thread and trip, GT members at most in the tile, THREADS
// per CTA.
template <int V, int GT, int MODE, int THREADS>
__device__ __forceinline__ void run_item(const Pass& a) {
  static_assert(MODE != STAGED || GT == 1, "staged windows serve one member");
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [gt][W]
  const int32_t* item = a.items + kItemColumns * blockIdx.x;
  const int block = item[0];
  const int s_first = item[1];
  const int e_first = item[2];
  const int s_last = item[3];
  const int e_end = item[4];
  const bool sole = item[5] != 0;
  const int g0 = blockIdx.y * a.gt;
  const int gt = min(a.gt, a.num_members - g0);
  const int W = a.window;
  const bool quads = (W & 3) == 0;
  if (gt <= 0) return;

  if (quads) {
    for (int i = threadIdx.x; i < gt * W / 4; i += THREADS) {
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < gt * W; i += THREADS) acc[i] = 0.f;
  }
  __syncthreads();

  if (s_first <= s_last) {  // an item without steps leaves its windows zero
    if constexpr (MODE == STAGED) {
      walk_staged<V, THREADS>(a, acc, acc + W, s_first, e_first, s_last,
                              e_end, g0);
    } else {
      walk_gathered<V, GT, THREADS>(a, acc, s_first, e_first, s_last, e_end,
                                    g0, gt);
    }
  }
  __syncthreads();
  flush(a, acc, block, sole, g0, gt, W, quads, THREADS);
}

// Allow `smem` bytes of dynamic shared memory, ask for the carveout that
// holds as many CTAs as the occupancy calculator allows (the rest of the SM's
// 256 KB stays L1, for the gathered source windows), and return that many
// CTAs per SM in *ctas.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int threads, size_t smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  const size_t need = (smem + kReservedSmemPerCta) * n;
  const int percent =
      static_cast<int>((need * 100 + kSmemPerSm - 1) / kSmemPerSm);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             percent < 100 ? percent : 100);
  *ctas = n;
  return err;
}

}  // namespace photon
