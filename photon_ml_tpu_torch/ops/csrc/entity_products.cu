// K4, the per-entity products in a fixed order of additions, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (the einsums of photon_ml_tpu/game/random_effect.py: the Gram
// "bsd,btd->bst" of solve_dense_newton, the batched matvecs of its CG and
// of the dense per-entity objective, and the per-member sums of the
// vmapped optimizers). The port ran them on torch.bmm and .sum(dim=-1),
// whose order of additions on the card follows the whole batch's shape
// (cuBLAS picks its batched algorithm by the shape, batch count included;
// the reduction kernel lays out its threads by it). An entity solved in a
// bucket of 25,000 and in a padded shard block of 12,517 then rounds
// otherwise and may stop a Newton step apart. This kernel makes every
// output a function of its own row alone.
//
// What it computes, for every output o = (e, i, j) of an [E, I, J] grid:
//
//   out[o] = sum over k < K of a[e, i, j, k] * b[e, i, j, k]
//
// with a and b read through four strides each (b may be null: then the
// product is a alone). The Gram X X^T, X c, X^T r and G v are all this one
// function on other strides (tree_dot_kernel; the Gram and the member-wise
// rows also have kernels of their own, below).
//
// The order of additions is data/batch.py's row_sum: each product rounded
// once (no fused multiply-add), the row zero-padded to W = the next power
// of two of K, then halved by adds: position p of width w takes
// S(p, w) = S(p, 2w) + S(p + w, 2w), down to S(0, 1). It depends on K alone,
// so the plain version (row_sum of the products) gives the same bits on
// any device, and so does every launch plan below. A group of P threads
// (a power of two, P <= W) serves one output: thread q first sums its
// M = W / P leaves q + P m serially in that tree's order (the halving of a
// 16-slot register array), then the group halves over its threads
// (shuffles within the warp, shared memory above it). A long row
// (W > 16,384) is cut into partials S(q, P) by one launch in "partial"
// mode, and their row of P continues the same tree in the next launch.
//
// The member-wise dots, sums and norms (row_dot, row_norm, row_dots) have
// a kernel of their own too (row_dot_kernel), one launch a call at any row
// length and for up to kMaxPairs pairs of one shape. A thread owns V
// consecutive positions of each stride (V = 4 in float32, 2 in float64,
// so each leaf is one 16-byte load; V = 1 where a stride or the row's
// alignment forbids it) and sums each position's leaves serially in the
// tree's order; the halvings of widths >= V run across threads (shuffles,
// shared memory above a warp), the last log2(V) inside the thread. A row
// of up to 256 threads' leaves is one CTA's (several rows a CTA below
// that); a longer one is C CTAs' of eight warps, which split each of
// their 32 V residues' leaves and merge them through shared memory, so a
// CTA writes only its 32 V partials S(q, P) to the row's scratch; the last
// CTA of each group of up to kFanin (a per-group ticket: __threadfence,
// atomicAdd, the last resets it) continues the same tree over the group's
// partials, and so on until one CTA finishes the row.
// Which CTA finishes changes from run to run; the order of the adds does
// not. The norm reads its operand once and takes the sqrt of its squares'
// sum in the kernel.
//
// The Gram has a kernel of its own (gram_kernel): one CTA per entity
// stages the entity's X (S x W, zero-padded to W) in shared memory once,
// then its groups of P threads compute the S (S + 1) / 2 entries i <= j,
// each group a run of consecutive entries in row-major order with row i's
// leaves held in registers while j walks, each entry by the same tree,
// and write each to (i, j) and (j, i) (x_i x_j and x_j x_i round alike).
// It serves rows of W <= 512 whose block fits in shared memory; a wider or
// larger one takes tree_dot_kernel on the Gram's strides, with the same
// bits. Index arithmetic is 32-bit wherever the offsets fit.
//
// What bounds it on the H100: bytes. A row of W <= 16 is one thread's
// (P = 1), so X^T r, whose rows run down X's columns, reads X with
// consecutive lanes on consecutive columns; a longer row takes W / 16
// threads (a warp at W = 512), each reading 16 leaves P apart.

// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and does not synchronise; the return value is cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 16;  // leaves a thread sums serially, at most
constexpr int kBlock = 256;  // threads per CTA when a group is no wider
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }

template <typename Idx>
struct Strides {
  Idx e, i, j, k;
};

// Idx is int where every thread index and element offset fits (the usual
// case), long long otherwise: 64-bit division and multiplication cost
// many instructions a thread. P is 1 << lp.
template <typename T, typename Idx>
__global__ void tree_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                T* __restrict__ out, Idx n_out, Idx I, Idx J, Idx K,
                                Strides<Idx> sa, Strides<Idx> sb, int lp, int M,
                                int partial) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int P = 1 << lp;
  const Idx tid = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Idx o = tid >> lp;
  const int q = static_cast<int>(tid & (P - 1));
  const bool live = o < n_out;
  const Idx oo = live ? o : 0;
  Idx j = 0, r = oo;
  if (J != 1) {
    j = oo % J;
    r = oo / J;
  }
  Idx i = 0, e = r;
  if (I != 1) {
    i = r % I;
    e = r / I;
  }
  const T* pa = a + e * sa.e + i * sa.i + j * sa.j;
  const T* pb = b == nullptr ? nullptr : b + e * sb.e + i * sb.i + j * sb.j;

  // the thread's leaves q + P m; those past K are the tree's zero padding
  T buf[kLeaves];
#pragma unroll
  for (int m = 0; m < kLeaves; ++m) {
    T v = T(0);
    const Idx k = q + static_cast<Idx>(P) * m;
    if (live && m < M && k < K) {
      v = pa[k * sa.k];
      if (pb != nullptr) v = mul_rn(v, pb[k * sb.k]);
    }
    buf[m] = v;
  }
  // S(q, P) from the M leaves: halvings of width P * 2h down to P
#pragma unroll
  for (int h = kLeaves / 2; h >= 1; h >>= 1) {
    if (2 * h <= M) {
#pragma unroll
      for (int m = 0; m < h; ++m) buf[m] = add_rn(buf[m], buf[m + h]);
    }
  }
  T v = buf[0];
  if (partial) {
    if (live) out[o * P + q] = v;
    return;
  }
  if (P <= 32) {
    for (int off = P / 2; off >= 1; off >>= 1)
      v = add_rn(v, __shfl_down_sync(0xffffffffu, v, off, P));
  } else {
    smem[threadIdx.x] = v;
    __syncthreads();
    for (int off = P / 2; off >= 32; off >>= 1) {
      if (q < off) smem[threadIdx.x] = add_rn(smem[threadIdx.x], smem[threadIdx.x + off]);
      __syncthreads();
    }
    if (q < 32) {
      v = smem[threadIdx.x];
      for (int off = 16; off >= 1; off >>= 1)
        v = add_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
  }
  if (live && q == 0) out[o] = v;
}

long long span(long long E, long long I, long long J, long long K, const Strides<long long>& s) {
  auto ext = [](long long n, long long st) { return (n - 1) * (st < 0 ? -st : st); };
  return ext(E, s.e) + ext(I, s.i) + ext(J, s.j) + ext(K, s.k);
}

template <typename T, typename Idx>
void start(const void* a, const void* b, void* out, long long n_out, long long I,
           long long J, long long K, const Strides<long long>& sa,
           const Strides<long long>& sb, int lp, int M, int partial, long long grid,
           int block, size_t smem, void* stream) {
  const Strides<Idx> ta{static_cast<Idx>(sa.e), static_cast<Idx>(sa.i),
                        static_cast<Idx>(sa.j), static_cast<Idx>(sa.k)};
  const Strides<Idx> tb{static_cast<Idx>(sb.e), static_cast<Idx>(sb.i),
                        static_cast<Idx>(sb.j), static_cast<Idx>(sb.k)};
  tree_dot_kernel<T, Idx><<<static_cast<unsigned>(grid), block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      static_cast<Idx>(n_out), static_cast<Idx>(I), static_cast<Idx>(J),
      static_cast<Idx>(K), ta, tb, lp, M, partial);
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long E, long long I,
           long long J, long long K, Strides<long long> sa, Strides<long long> sb,
           int P, int M, int partial, void* stream) {
  const long long n_out = E * I * J;
  if (n_out <= 0) return 0;
  // a partial launch's threads are independent; a full one's group of P
  // threads shares one CTA
  if (P < 1 || (P & (P - 1)) != 0 || (!partial && P > 1024) || M < 1 || M > kLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  int lp = 0;
  while ((1 << lp) < P) ++lp;
  const int block = (!partial && P > kBlock) ? P : kBlock;
  const long long threads = n_out * P;
  const long long grid = (threads + block - 1) / block;
  const size_t smem = (!partial && P > 32) ? block * sizeof(T) : 0;
  const long long limit = 0x7fffffffLL - 1024;
  const bool narrow = grid * block < limit && span(E, I, J, K, sa) < limit &&
                      (b == nullptr || span(E, I, J, K, sb) < limit) &&
                      static_cast<long long>(P) * kLeaves < limit;
  if (narrow)
    start<T, int>(a, b, out, n_out, I, J, K, sa, sb, lp, M, partial, grid, block, smem, stream);
  else
    start<T, long long>(a, b, out, n_out, I, J, K, sa, sb, lp, M, partial, grid, block, smem,
                        stream);
  return static_cast<int>(cudaGetLastError());
}

// The Gram of entity blockIdx.x: X[e] staged as S rows of W = P * M
// (zero past D), then the entries i <= j in row-major order, cut into one
// run of consecutive entries a group of P <= 32 threads (thread q: leaves
// q + P m, then the shuffles); a group keeps row i's leaves in registers
// while j walks, and writes each entry to both halves. Every group takes
// the same number of steps, so the shuffles always see the whole warp.
template <typename T>
__global__ void gram_kernel(const T* __restrict__ x, T* __restrict__ out, int S, int D,
                            long long st_e, int st_s, int st_d, int P, int M, int lw) {
  extern __shared__ unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int W = P * M;  // = 1 << lw
  const T* xe = x + static_cast<long long>(blockIdx.x) * st_e;
#pragma unroll 4
  for (int t = threadIdx.x; t < (S << lw); t += blockDim.x) {
    const int s = t >> lw, d = t & (W - 1);
    xs[t] = d < D ? xe[s * st_s + d * st_d] : T(0);
  }
  __syncthreads();
  const int groups = blockDim.x / P;
  const int g = threadIdx.x / P;
  const int q = threadIdx.x - g * P;
  const int n_pairs = S * (S + 1) / 2;
  const int per = (n_pairs + groups - 1) / groups;
  // the group's first entry (i, j)
  int pr = g * per, i = 0;
  while (i < S && pr >= S - i) {
    pr -= S - i;
    ++i;
  }
  int j = i + pr;
  T* oe = out + static_cast<long long>(blockIdx.x) * S * S;
  T xi[kLeaves];
  int loaded = -1;
  for (int step = 0; step < per; ++step) {
    const bool live = g * per + step < n_pairs;
    if (live && loaded != i) {
#pragma unroll
      for (int m = 0; m < kLeaves; ++m) xi[m] = m < M ? xs[i * W + q + P * m] : T(0);
      loaded = i;
    }
    T buf[kLeaves];
#pragma unroll
    for (int m = 0; m < kLeaves; ++m)
      buf[m] = (live && m < M) ? mul_rn(xi[m], xs[j * W + q + P * m]) : T(0);
#pragma unroll
    for (int h = kLeaves / 2; h >= 1; h >>= 1) {
      if (2 * h <= M) {
#pragma unroll
        for (int m = 0; m < h; ++m) buf[m] = add_rn(buf[m], buf[m + h]);
      }
    }
    T v = buf[0];
    for (int off = P / 2; off >= 1; off >>= 1)
      v = add_rn(v, __shfl_down_sync(0xffffffffu, v, off, P));
    if (live && q == 0) {
      oe[i * S + j] = v;
      oe[j * S + i] = v;
    }
    if (++j == S) {
      ++i;
      j = i;
    }
  }
}

template <typename T>
int launch_gram(const void* x, void* out, long long E, long long S, long long D,
                long long st_e, long long st_s, long long st_d, int P, int M,
                void* stream) {
  if (E <= 0 || S <= 0) return 0;
  if (P < 1 || P > 32 || (P & (P - 1)) != 0 || M < 1 || M > kLeaves || P * M < D ||
      S * (S + 1) / 2 > 0x7fffffffLL || st_s < 0 || st_d < 0 ||
      (S - 1) * st_s + (D - 1) * st_d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(S) * P * M * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int lw = 0;
  while ((1 << lw) < P * M) ++lw;
  gram_kernel<T><<<static_cast<unsigned>(E), kBlock, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<int>(S),
      static_cast<int>(D), st_e, static_cast<int>(st_s), static_cast<int>(st_d), P, M, lw);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// row_dot_kernel: the member-wise sums of [R, K] rows, for up to kMaxPairs
// pairs of one shape in one launch (blockIdx.y = the pair)
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;  // threads per CTA
constexpr int kRowLog = 8;        // log2(kRowThreads)
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxPairs = 8;
constexpr int kFanin = kRowWarps * kLeaves;  // a long row's items merged per ticket, at most

// What a row reduces: a (kSum), a * b (kDot), and the sqrt of a * a's sum
// (kNorm: a read once).
enum RowMode { kSum = 0, kDot = 1, kNorm = 2 };

struct RowPairs {
  const void* a[kMaxPairs];
  const void* b[kMaxPairs];
  long long a_r[kMaxPairs], a_k[kMaxPairs], b_r[kMaxPairs], b_k[kMaxPairs];
};

// V consecutive elements in one load: 16 bytes where V > 1
template <typename T, int V>
struct Vec {
  __device__ static void load(const T* p, T (&x)[V]) { x[0] = __ldg(p); }
  __device__ static void load_cg(const T* p, T (&x)[V]) { x[0] = __ldcg(p); }
  __device__ static void store(T* p, const T (&x)[V]) { p[0] = x[0]; }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void load_cg(const float* p, float (&x)[4]) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<double, 2> {
  __device__ static void load(const double* p, double (&x)[2]) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    x[0] = v.x; x[1] = v.y;
  }
  __device__ static void load_cg(const double* p, double (&x)[2]) {
    const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
    x[0] = v.x; x[1] = v.y;
  }
  __device__ static void store(double* p, const double (&x)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  }
};

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// Halve n (a power of two <= N) slots of V values in place, slot m taking
// slot m + h for h = n / 2 ... 1: the tree's order over the slots. Each
// width H is a template argument, so every index is a constant and buf
// stays in registers.
template <int H, typename T, int N, int V>
__device__ __forceinline__ void halve_from(T (&buf)[N][V], int n) {
  if constexpr (H >= 1) {
    if (2 * H <= n) {
#pragma unroll
      for (int m = 0; m < H; ++m) {
#pragma unroll
        for (int j = 0; j < V; ++j) buf[m][j] = add_rn(buf[m][j], buf[m + H][j]);
      }
    }
    halve_from<H / 2>(buf, n);
  }
}

template <typename T, int N, int V>
__device__ __forceinline__ void halve(T (&buf)[N][V], int n) {
  halve_from<N / 2>(buf, n);
}

// Halve the values v[] of warps w < n (n <= 8, a power of two) across
// warps in the tree's order (warp w takes warp w + h, h = n / 2 ... 1),
// through shared memory; warp 0 ends with the result. Called by every
// thread of the CTA.
template <typename T, int V>
__device__ __forceinline__ void halve_warps(T (&v)[V], int n, T* smem) {
  const int t = threadIdx.x, w = t >> 5;
#pragma unroll
  for (int j = 0; j < V; ++j) smem[j * kRowThreads + t] = v[j];
  __syncthreads();
  for (int h = n / 2; h >= 1; h >>= 1) {
    if (w < h) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        smem[j * kRowThreads + t] = add_rn(smem[j * kRowThreads + t], smem[j * kRowThreads + t + 32 * h]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = smem[j * kRowThreads + t];
}

// Short rows (lc = 0): a group of 1 << lu threads (g its thread's place in
// it) serves a row of W = V 2^lu M positions, kRowThreads >> lu rows a
// CTA: thread g owns positions V g + j + V U m (j < V, m < M, U = 2^lu),
// sums each j's M leaves serially in the tree's order, then the group
// halves across its threads (shuffles, shared memory above a warp) and
// its first thread the last log2(V) widths.
//
// Long rows (lc > 0): C = 2^lc CTAs a row, each of kRowWarps warps and Q
// = 32 V residues: lane l of every warp owns residues q = c Q + V l + j,
// P = C Q of them a row, whose positions are q + P i for i < W / P = 8 M;
// warp w takes the leaves i = w + 8 s (s < M), sums them serially, then
// the warps halve across (shared memory), which leaves S(q, P) in warp 0.
// A CTA's Q partials are one item of the row's scratch; the last CTA of
// each group of up to kFanin items gi + (n / f) k (a ticket) halves them
// over k the same way (warp w takes k = w + 8 s), level by level, until
// one item, S(q, Q), is left; its warp 0 halves across its lanes.
// out: [pairs, R]; scratch: [pairs, R, P]; tickets: [pairs, R, C] int,
// zero on entry and on exit.
template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
row_dot_kernel(RowPairs ops, T* __restrict__ out, T* __restrict__ scratch,
               int* __restrict__ tickets, long long R, long long K, int mode,
               int lu, int lc, int M) {
  __shared__ T smem[V * kRowThreads];
  __shared__ int last;
  constexpr int Q = 32 * V;
  const int pair = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool long_row = lc > 0;
  const int group = long_row ? 32 : 1 << lu;  // threads that share residues
  const int g = t & (group - 1);
  const int c = static_cast<int>(blockIdx.x & ((1u << lc) - 1));  // CTA of the row
  const long long row = long_row ? static_cast<long long>(blockIdx.x >> lc)
                                 : (static_cast<long long>(blockIdx.x) << (kRowLog - lu)) + (t >> lu);
  const bool live = row < R;
  const long long rr = live ? row : 0;
  // the thread's first position and its leaves' stride
  const long long P = static_cast<long long>(Q) << lc;
  const long long first = long_row ? c * Q + V * lane + P * w : static_cast<long long>(V) * g;
  const long long stride = long_row ? 8 * P : static_cast<long long>(V) << lu;

  // the thread's leaf m at first + m stride, through each operand's strides
  const long long ak = ops.a_k[pair], bk = ops.b_k[pair];
  const T* pa = static_cast<const T*>(ops.a[pair]) + rr * ops.a_r[pair] + first * ak;
  const T* pb = mode == kDot
                    ? static_cast<const T*>(ops.b[pair]) + rr * ops.b_r[pair] + first * bk
                    : pa;
  const long long sa = stride * ak, sb = stride * bk;

  // every leaf's loads first (those past K are the tree's zero padding),
  // then the products
  T buf[kLeaves][V], other[kLeaves][V];
#pragma unroll
  for (int m = 0; m < kLeaves; ++m) {
    if (live && m < M && first + m * stride < K) {
      Vec<T, V>::load(pa + m * sa, buf[m]);
      if (mode == kDot) Vec<T, V>::load(pb + m * sb, other[m]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) buf[m][j] = other[m][j] = T(0);
    }
  }
  if (mode != kSum) {
#pragma unroll
    for (int m = 0; m < kLeaves; ++m) {
#pragma unroll
      for (int j = 0; j < V; ++j) buf[m][j] = mul_rn(buf[m][j], mode == kDot ? other[m][j] : buf[m][j]);
    }
  }
  halve(buf, M);
  T v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = buf[0][j];

  if (long_row) {
    halve_warps(v, kRowWarps, smem);  // S(q, P) in warp 0
    T* part = scratch + (static_cast<long long>(pair) * R + row) * P;
    int* ticket = tickets + ((static_cast<long long>(pair) * R + row) << lc);
    int n = 1 << lc, item = c, base = 0;
    while (n > 1) {
      if (w == 0) {
        Vec<T, V>::store(part + static_cast<long long>(item) * Q + V * lane, v);
        __threadfence();
      }
      const int f = n < kFanin ? n : kFanin;
      const int groups = n / f;
      const int gi = item & (groups - 1);
      __syncthreads();
      if (t == 0) {
        const int before = atomicAdd(ticket + base + gi, 1);
        last = before == f - 1;
        if (last) {
          ticket[base + gi] = 0;  // for the next launch
          __threadfence();
        }
      }
      __syncthreads();
      if (!last) return;
      // items gi + groups k: warp w takes k = w + fw s, s < f / fw
      const int fw = f < kRowWarps ? f : kRowWarps;
      const int per = f / fw;
      T ib[kLeaves][V];
#pragma unroll
      for (int s = 0; s < kLeaves; ++s) {
        if (w < fw && s < per) {
          Vec<T, V>::load_cg(part + static_cast<long long>(gi + groups * (w + fw * s)) * Q + V * lane,
                             ib[s]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) ib[s][j] = T(0);
        }
      }
      halve(ib, per);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = ib[0][j];
      halve_warps(v, fw, smem);
      n = groups;
      item = gi;
      base += groups;
    }
  } else if (group > 32) {
    // halvings of widths V * group / 2 ... V * 32 across the group's warps
#pragma unroll
    for (int j = 0; j < V; ++j) smem[j * kRowThreads + t] = v[j];
    __syncthreads();
    for (int off = group / 2; off >= 32; off >>= 1) {
      if (g < off) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          smem[j * kRowThreads + t] = add_rn(smem[j * kRowThreads + t], smem[j * kRowThreads + t + off]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = smem[j * kRowThreads + t];
  }
  // the halvings of widths V * 16 ... V across a warp's lanes (whole
  // warps: a long row's warp 0, a group's first warp)
  if (long_row ? w == 0 : g < 32) {
    const int width = group < 32 ? group : 32;
    for (int off = width / 2; off >= 1; off >>= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = add_rn(v[j], __shfl_down_sync(0xffffffffu, v[j], off, width));
    }
  }
  if (g == 0 && live && (!long_row || w == 0)) {
    // S(j, V) -> the widths 2 and 1 inside the thread
    T s;
    if constexpr (V == 4) {
      s = add_rn(add_rn(v[0], v[2]), add_rn(v[1], v[3]));
    } else if constexpr (V == 2) {
      s = add_rn(v[0], v[1]);
    } else {
      s = v[0];
    }
    if (mode == kNorm) s = sqrt_rn(s);
    out[static_cast<long long>(pair) * R + row] = s;
  }
}

template <typename T, int V>
int launch_rows(const RowPairs& ops, int n_pairs, void* out, void* scratch, void* tickets,
                long long R, long long K, int mode, int lu, int lc, int M, void* stream) {
  const long long grid =
      lc > 0 ? (R << lc) : (R + (kRowThreads >> lu) - 1) / (kRowThreads >> lu);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_dot_kernel<T, V><<<dim3(static_cast<unsigned>(grid), n_pairs), kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ops, static_cast<T*>(out), static_cast<T*>(scratch), static_cast<int*>(tickets), R, K,
      mode, lu, lc, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[o] for o < E * I * J (or, with partial = 1, the partials
// out[o * P + q], q < P); a and b as the note says, b may be null; strides
// in elements. dtype: 0 = float32, 1 = float64.
int photon_entity_products(int dtype, const void* a, const void* b, void* out,
                           long long E, long long I, long long J, long long K,
                           long long a_e, long long a_i, long long a_j, long long a_k,
                           long long b_e, long long b_i, long long b_j, long long b_k,
                           int P, int M, int partial, void* stream) {
  const Strides<long long> sa{a_e, a_i, a_j, a_k};
  const Strides<long long> sb{b_e, b_i, b_j, b_k};
  if (dtype == 0)
    return launch<float>(a, b, out, E, I, J, K, sa, sb, P, M, partial, stream);
  if (dtype == 1)
    return launch<double>(a, b, out, E, I, J, K, sa, sb, P, M, partial, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out [E, S, S] = X X^T for X [E, S, D] (strides in elements), one CTA
// per entity with S * P * M elements of X in shared memory; P * M is D's
// padded width, P <= 32. dtype as above.
int photon_entity_gram(int dtype, const void* x, void* out, long long E, long long S,
                       long long D, long long st_e, long long st_s, long long st_d,
                       int P, int M, void* stream) {
  if (dtype == 0)
    return launch_gram<float>(x, out, E, S, D, st_e, st_s, st_d, P, M, stream);
  if (dtype == 1)
    return launch_gram<double>(x, out, E, S, D, st_e, st_s, st_d, P, M, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The member-wise sums of n_pairs (1..kMaxPairs) pairs of [R, K] rows in
// one launch, into out [n_pairs, R]: table [n_pairs, 6] holds each pair's
// a and b (b unused unless mode = kDot) and their row and element strides
// (a_r, a_k, b_r, b_k, in elements). vec: V, elements a thread loads at
// once (1, or 4 in float32 and 2 in float64: every a and b then 16-byte
// aligned with K, the row strides multiples of V and the element strides
// 1). M leaves a thread, lu and lc as row_dot_kernel's (lu unused when
// lc > 0); scratch and tickets as there (unused when lc = 0). dtype: 0 =
// float32, 1 = float64.
int photon_row_dots(int dtype, int vec, int n_pairs, const long long* table, void* out,
                    void* scratch, void* tickets, long long R, long long K, int mode,
                    int M, int lu, int lc, void* stream) {
  if (R <= 0) return 0;
  if (n_pairs < 1 || n_pairs > kMaxPairs || mode < kSum || mode > kNorm || M < 1 ||
      M > kLeaves || (M & (M - 1)) != 0 || lu < 0 || lu > kRowLog || lc < 0 || lc > 24 ||
      (lc > 0 && (scratch == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  RowPairs ops;
  for (int i = 0; i < n_pairs; ++i) {
    ops.a[i] = reinterpret_cast<const void*>(table[6 * i]);
    ops.b[i] = reinterpret_cast<const void*>(table[6 * i + 1]);
    ops.a_r[i] = table[6 * i + 2];
    ops.a_k[i] = table[6 * i + 3];
    ops.b_r[i] = table[6 * i + 4];
    ops.b_k[i] = table[6 * i + 5];
    if (vec > 1 && (ops.a_k[i] != 1 || (mode == kDot && ops.b_k[i] != 1)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && K % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 1)
    return launch_rows<float, 1>(ops, n_pairs, out, scratch, tickets, R, K, mode, lu, lc, M, stream);
  if (dtype == 0 && vec == 4)
    return launch_rows<float, 4>(ops, n_pairs, out, scratch, tickets, R, K, mode, lu, lc, M, stream);
  if (dtype == 1 && vec == 1)
    return launch_rows<double, 1>(ops, n_pairs, out, scratch, tickets, R, K, mode, lu, lc, M, stream);
  if (dtype == 1 && vec == 2)
    return launch_rows<double, 2>(ops, n_pairs, out, scratch, tickets, R, K, mode, lu, lc, M, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* photon_entity_products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
