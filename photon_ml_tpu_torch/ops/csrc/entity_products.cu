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
// product is a alone). The Gram X X^T, X c, X^T r, G v and a bank's
// member-wise dot products are all this one function on other strides.
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

const char* photon_entity_products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
