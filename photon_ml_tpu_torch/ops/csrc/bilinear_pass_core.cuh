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
//   f32, and every addition into it comes in one fixed order (no atomics):
//   the host sorts each step's entries by output slot, stably
//   (tiled_sparse.sort_steps_by_output), so a trip's entries for one slot
//   of one step are adjacent. Each trip (V entries a thread, threads in
//   entry order) is one segmented inclusive scan over the CTA: a thread's
//   V entries in order, then a warp's 32 threads in a shuffle tree, then
//   the warps' totals in a shuffle tree of their own (add_trip). The last
//   entry of each run then holds the run's sum and adds it to its slot, one
//   step of the trip after another with a barrier between (a slot meets at
//   most one run of each step). A slot that many entries share (an
//   intercept column's) takes one add a trip instead of one an entry.
// - The output: an item alone on its output block stores its windows with
//   plain 16-byte stores; items that share a block store theirs into a
//   scratch row of their own ([rows, G, W], the plan's shared-item table),
//   and reduce_shared then sums each such block's rows in a fixed order
//   (eight interleaved partial sums in row order, then those in order)
//   and writes the block once. So every output element is written exactly
//   once, as in the Pallas kernel, and the output needs no zeroing.
// - The spill remainder (the tile tails the schedule leaves out of its
//   steps, sorted by output slot once a schedule: bilinear_pass.SpillPlan)
//   is added where each output element is written once, each column's
//   slot read from the plan's map: an item alone on its block adds its
//   block's spill sums into the accumulator before its store (one thread a
//   column), reduce_shared adds a shared block's to its total (read while
//   the rows are summed). A slot's sum starts at 0 and
//   takes each spilled product in entry order by a fused multiply-add
//   (__fmaf_rn: product and add rounded once together, the bits of the
//   separate remainder kernel this fold replaced), then one add to the
//   slot (__fadd_rn); bilinear_pass.spill_ordered repeats it in plain
//   PyTorch. Slots without a spill are stored as they are.
// - K2 reads an entry once for all GT members of its tile; the host picks
//   the tiles (grid_bilinear_pass.members_per_cta).
// - Determinism: the order of every addition is a function of the
//   schedule and the work plan, and the plan of the schedule and the CTA
//   target (SMs x resident CTAs). So one schedule gives the same bits on
//   every launch, in every process, on every card with the same target; a
//   plan for another target cuts items elsewhere and may round otherwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace photon {

// Columns of a work item on the device (bilinear_pass.KERNEL_ITEM_COLUMNS):
// plan_work's six, then the item's scratch row (-1 when it is its block's
// only writer).
constexpr int kItemColumns = 7;
// Columns of a shared block (bilinear_pass.shared_items): output block,
// first scratch row, rows.
constexpr int kSharedColumns = 3;
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
  float* scratch;  // [rows, num_members, W]: shared items' windows
  int window;
  int num_members;
  int gt;  // members per CTA (the last tile may hold fewer)
  // the spill remainder by output slot (spill_map null: none)
  const int32_t* spill_map;      // [num_out_blocks * W] each output's slot, or -1
  const int32_t* spill_offsets;  // [slots + 1] each slot's first entry
  const int32_t* spill_in;       // [entries] flat input coordinate
  const float* spill_vals;       // [entries]
};

// The spill sums of slot i for members g0 .. g0 + gt - 1: from 0, each of
// its entries' products fused-multiply-added in entry order.
template <int GT>
__device__ __forceinline__ void spill_sums(const Pass& a, int i, int g0, int gt,
                                           float (&sum)[GT]) {
#pragma unroll
  for (int j = 0; j < GT; ++j) sum[j] = 0.f;
  const int end = __ldg(a.spill_offsets + i + 1);
  for (int k = __ldg(a.spill_offsets + i); k < end; ++k) {
    const float v = __ldg(a.spill_vals + k);
    const float* src = a.src + static_cast<int64_t>(g0) * a.n_in + __ldg(a.spill_in + k);
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      if (j < gt) sum[j] = __fmaf_rn(v, __ldg(src + static_cast<int64_t>(j) * a.n_in), sum[j]);
    }
  }
}

// Add output block `block`'s spill sums into the tile's windows in shared
// memory, one thread a column (its slot from the plan's map).
template <int GT>
__device__ __forceinline__ void add_block_spill(const Pass& a, float* acc, int block,
                                                int g0, int gt, int threads) {
  const int W = a.window;
  const int32_t* map = a.spill_map + static_cast<int64_t>(block) * W;
  for (int i = threadIdx.x; i < W; i += threads) {
    const int slot = __ldg(map + i);
    if (slot < 0) continue;
    float sum[GT];
    spill_sums<GT>(a, slot, g0, gt, sum);
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      if (j < gt) acc[j * W + i] = __fadd_rn(acc[j * W + i], sum[j]);
    }
  }
}

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

// A scan element: a key (the step and output slot of a run of entries;
// kEmpty for none) and the GT members' sums over the run so far.
constexpr unsigned kEmpty = 0xFFFFFFFFu;

template <int GT>
struct Run {
  unsigned key;
  float v[GT];
};

// The run a, then b. Equal keys are adjacent in a trip (entries sorted by
// slot within a step), so this is associative; a's sum comes first.
template <int GT>
__device__ __forceinline__ Run<GT> combine(const Run<GT>& a, const Run<GT>& b) {
  if (b.key == kEmpty || a.key != b.key) return b.key == kEmpty ? a : b;
  Run<GT> r;
  r.key = b.key;
#pragma unroll
  for (int j = 0; j < GT; ++j) r.v[j] = a.v[j] + b.v[j];
  return r;
}

template <int GT>
__device__ __forceinline__ Run<GT> shfl_up(const Run<GT>& a, int d) {
  Run<GT> r;
  r.key = __shfl_up_sync(0xffffffffu, a.key, d);
#pragma unroll
  for (int j = 0; j < GT; ++j) r.v[j] = __shfl_up_sync(0xffffffffu, a.v[j], d);
  return r;
}

template <int GT>
__device__ __forceinline__ Run<GT> shfl_from(const Run<GT>& a, int lane) {
  Run<GT> r;
  r.key = __shfl_sync(0xffffffffu, a.key, lane);
#pragma unroll
  for (int j = 0; j < GT; ++j) r.v[j] = __shfl_sync(0xffffffffu, a.v[j], lane);
  return r;
}

template <int GT>
__device__ __forceinline__ Run<GT> empty_run() {
  Run<GT> r;
  r.key = kEmpty;
#pragma unroll
  for (int j = 0; j < GT; ++j) r.v[j] = 0.f;
  return r;
}

// Inclusive scan of a warp's elements, lane order.
template <int GT>
__device__ __forceinline__ Run<GT> warp_scan(Run<GT> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Run<GT> o = shfl_up(x, d);
    if (lane >= d) x = combine(o, x);
  }
  return x;
}

// What a trip's scan shares between warps. Trips alternate between two of
// these, so one barrier a trip orders every read of a trip's before the
// writes of the trip after the next.
template <int GT, int THREADS>
struct TripShared {
  Run<GT> total[THREADS / 32];     // each warp's inclusive total
  unsigned first_key[THREADS / 32];  // each warp's first key
  int last_step[THREADS / 32];     // each warp's last step (-1: no entry)
  int first_step;                  // the step of the trip's first entry
};

// Add one trip into the accumulator in a fixed order. Each thread holds n
// (a prefix of V) entries of one step: their output slots op and their
// products x (one per member). Threads hold the trip's entries in order,
// and thread 0 holds the first whenever any thread holds one. Called by
// every thread of the CTA; -> false when the trip held no entries.
template <int V, int GT, int THREADS>
__device__ __forceinline__ bool add_trip(float* acc, int W, int step, int n,
                                         const int (&op)[V], float (&x)[GT][V],
                                         TripShared<GT, THREADS>& sh) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned key[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    // distinct for distinct (step, slot) within a trip, even, so never kEmpty
    key[k] = k < n ? (static_cast<unsigned>(step) * static_cast<unsigned>(W) +
                      static_cast<unsigned>(op[k])) << 1
                   : kEmpty;
  }
  // the thread's entries in order: x[.][k] becomes its run's sum up to k
#pragma unroll
  for (int k = 1; k < V; ++k) {
    if (k < n && key[k] == key[k - 1]) {
#pragma unroll
      for (int j = 0; j < GT; ++j) x[j][k] = x[j][k - 1] + x[j][k];
    }
  }
  Run<GT> own = empty_run<GT>();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < n) {
      own.key = key[k];
#pragma unroll
      for (int j = 0; j < GT; ++j) own.v[j] = x[j][k];
    }
  }
  const Run<GT> inc = warp_scan(own, lane);
  Run<GT> before = shfl_up(inc, 1);  // the warp's threads before this one
  if (lane == 0) before = empty_run<GT>();
  const int warp_last = __reduce_max_sync(0xffffffffu, n > 0 ? step : -1);
  if (lane == 31) sh.total[warp] = inc;
  if (lane == 0) {
    sh.first_key[warp] = key[0];
    sh.last_step[warp] = warp_last;
  }
  if (threadIdx.x == 0) sh.first_step = n > 0 ? step : -1;
  __syncthreads();
  const int first_step = sh.first_step;
  if (first_step < 0) return false;  // the same for every thread
  const int last_step =
      __reduce_max_sync(0xffffffffu, lane < NW ? sh.last_step[lane] : -1);

  // the warps before this one: a scan of the warps' totals, lane by warp
  Run<GT> wt = lane < warp && lane < NW ? sh.total[lane] : empty_run<GT>();
  wt = warp_scan(wt, lane);
  const Run<GT> pre = combine(warp > 0 ? shfl_from(wt, warp - 1) : empty_run<GT>(),
                              before);
  if (pre.key != kEmpty) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (key[k] == pre.key) {
#pragma unroll
        for (int j = 0; j < GT; ++j) x[j][k] = pre.v[j] + x[j][k];
      }
    }
  }
  // the key after each entry: a run ends where it changes
  unsigned next = __shfl_down_sync(0xffffffffu, key[0], 1);
  if (lane == 31) next = warp + 1 < NW ? sh.first_key[warp + 1] : kEmpty;
  bool last[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    last[k] = k < n && key[k] != (k + 1 < V ? key[k + 1] : next);
  }
  // one step of the trip after another, a barrier between two: a slot
  // meets one run of each
  for (int s = first_step; s <= last_step; ++s) {
    if (n > 0 && step == s) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (last[k]) {
#pragma unroll
          for (int j = 0; j < GT; ++j) acc[j * W + op[k]] += x[j][k];
        }
      }
    }
    if (s < last_step) __syncthreads();
  }
  return true;
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
                                            int e_end, int g,
                                            TripShared<1, THREADS>* sh) {
  const int W = a.window;
  const float* src = a.src + static_cast<int64_t>(g) * a.n_in;
  auto stage = [&](int s, float* buf) {
    const float* win = src + static_cast<int64_t>(__ldg(a.step_in + s)) * W;
    for (int i = threadIdx.x; i < W / 4; i += THREADS) {
      cp_async16(buf + 4 * i, win + 4 * i);
    }
  };
  const int lane0 = V * static_cast<int>(threadIdx.x);  // first entry
  int trip = 0;  // the trip's TripShared: sh[trip & 1]
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
    for (int base = lo; base < hi; base += V * THREADS) {  // same for all
      const int e0 = base + lane0;
      const int n = max(0, min(V, hi - e0));
      Entries<V> cur;
      float x[1][V];
      if (n > 0) load_entries<V>(a, static_cast<int64_t>(s) * a.L + e0, cur);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k >= n) cur.op[k] = 0;
        x[0][k] = k < n ? cur.v[k] * buf[cur.ip[k]] : 0.f;
      }
      add_trip<V, 1, THREADS>(acc, W, s, n, cur.op, x, sh[trip++ & 1]);
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
                                              int gt,
                                              TripShared<GT, THREADS>* sh) {
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
  int trip = 0;  // the trip's TripShared: sh[trip & 1]
  for (;;) {  // one trip; add_trip ends the walk for every thread at once
    const int cs = s, e0 = (lo + v) * V;
    const int n = have ? max(0, min(V, hi - e0)) : 0;
    Entries<V> cur;
    if (n > 0) load_entries<V>(a, static_cast<int64_t>(cs) * a.L + e0, cur);
    v += THREADS;
    if (have) have = seek();  // the next trip's step, while this one loads

    float x[GT][V];
    if (n > 0) {
      const float* win = a.src + static_cast<int64_t>(g0) * a.n_in +
                         static_cast<int64_t>(__ldg(a.step_in + cs)) * W;
#pragma unroll
      for (int j = 0; j < GT; ++j) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          x[j][k] = (j < gt && k < n)
                        ? cur.v[k] * __ldg(win + static_cast<int64_t>(j) * a.n_in + cur.ip[k])
                        : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < GT; ++j) {
#pragma unroll
        for (int k = 0; k < V; ++k) x[j][k] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k >= n) cur.op[k] = 0;
    }
    if (!add_trip<V, GT, THREADS>(acc, W, cs, n, cur.op, x, sh[trip++ & 1])) break;
  }
}

// Write the tile's windows with plain stores: to the output where the item
// is its block's only writer (row < 0; its spill sums are in acc by then),
// else to the item's scratch row.
__device__ __forceinline__ void flush(const Pass& a, const float* acc,
                                      int block, int row, int g0, int gt,
                                      int W, bool quads, int threads) {
  for (int j = 0; j < gt; ++j) {
    float* dst =
        row < 0 ? a.out + static_cast<int64_t>(g0 + j) * a.n_out +
                      static_cast<int64_t>(block) * W
                : a.scratch + (static_cast<int64_t>(row) * a.num_members + g0 + j) * W;
    const float* acc_j = acc + j * W;
    if (quads) {
      float4* dst4 = reinterpret_cast<float4*>(dst);
      const float4* acc4 = reinterpret_cast<const float4*>(acc_j);
      for (int i = threadIdx.x; i < W / 4; i += threads) dst4[i] = acc4[i];
    } else {
      for (int i = threadIdx.x; i < W; i += threads) dst[i] = acc_j[i];
    }
  }
}

// The second kernel of a pass whose plan has shared blocks: for shared
// block blockIdx.y and member blockIdx.z, sum the block's scratch rows and
// write the output window once, in a fixed order: for each column
// (threadIdx.x), kReduceLanes partial sums over rows y, y + kReduceLanes,
// ... (threadIdx.y = y), each in row order, then the partials in y order.
// shared: [n, kSharedColumns].
constexpr int kReduceCols = 32;
constexpr int kReduceLanes = 8;

// Then the block's spill sum, where its slot has one, is added to the
// total before the single write.
__global__ void reduce_shared(const int32_t* shared, Pass a) {
  __shared__ float part[kReduceLanes][kReduceCols];
  const int W = a.window;
  const int i = blockIdx.x * kReduceCols + threadIdx.x;
  const int32_t* t = shared + kSharedColumns * blockIdx.y;
  const int g = blockIdx.z;
  // the column's spill slot, read while the rows are summed
  const int spill = threadIdx.y == 0 && i < W && a.spill_map != nullptr
                        ? __ldg(a.spill_map + static_cast<int64_t>(t[0]) * W + i)
                        : -1;
  float sum = 0.f;
  if (i < W) {
    const float* row =
        a.scratch + (static_cast<int64_t>(t[1]) * a.num_members + g) * W + i;
    const int64_t stride = static_cast<int64_t>(a.num_members) * W;
    for (int r = threadIdx.y; r < t[2]; r += kReduceLanes) {
      sum += row[r * stride];
    }
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && i < W) {
    float total = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kReduceLanes; ++y) total += part[y][threadIdx.x];
    if (spill >= 0) {
      float add[1];
      spill_sums<1>(a, spill, g, 1, add);
      total = __fadd_rn(total, add[0]);
    }
    a.out[static_cast<int64_t>(g) * a.n_out + static_cast<int64_t>(t[0]) * W + i] = total;
  }
}

// Launch reduce_shared over the plan's n_shared shared blocks (none: no
// launch).
__host__ inline cudaError_t launch_reduce(const Pass& a, const int32_t* shared,
                                          int n_shared, cudaStream_t stream) {
  if (n_shared <= 0) return cudaSuccess;
  dim3 grid((a.window + kReduceCols - 1) / kReduceCols, n_shared, a.num_members);
  dim3 block(kReduceCols, kReduceLanes);
  reduce_shared<<<grid, block, 0, stream>>>(shared, a);
  return cudaGetLastError();
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
  __shared__ TripShared<GT, THREADS> sh[2];
  float* acc = reinterpret_cast<float*>(smem4);  // [gt][W]
  const int32_t* item = a.items + kItemColumns * blockIdx.x;
  const int block = item[0];
  const int s_first = item[1];
  const int e_first = item[2];
  const int s_last = item[3];
  const int e_end = item[4];
  const int row = item[6];
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
                              e_end, g0, sh);
    } else {
      walk_gathered<V, GT, THREADS>(a, acc, s_first, e_first, s_last, e_end,
                                    g0, gt, sh);
    }
  }
  __syncthreads();
  if (row < 0 && a.spill_map != nullptr) {
    add_block_spill<GT>(a, acc, block, g0, gt, THREADS);
    __syncthreads();
  }
  flush(a, acc, block, row, g0, gt, W, quads, THREADS);
}

// Allow `smem` bytes of dynamic shared memory (beside the kernel's static
// TripShared), ask for the carveout that
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
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t need = (smem + attr.sharedSizeBytes + kReservedSmemPerCta) * n;
  const int percent =
      static_cast<int>((need * 100 + kSmemPerSm - 1) / kSmemPerSm);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             percent < 100 ? percent : 100);
  *ctas = n;
  return err;
}

}  // namespace photon
