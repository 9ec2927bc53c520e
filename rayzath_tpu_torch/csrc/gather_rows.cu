// Row gathers from a table and their backward: G1 `gather_kernel` and G2
// (`grad_block_kernel` + `grad_sum_kernel` for a table that fits in shared
// memory, `grad_atomic_kernel` + `round_kernel` for one that does not).
//
// Replaces rayzath_tpu/ops/gather.py `gather_rows`, which is not a Pallas
// kernel: for a table of at most 128 rows it is a one-hot product on the
// MXU, so its transpose, the table's gradient, is a dense reduction of the
// cotangents onto each row. The plain versions are ops/gather.py
// `gather_rows_plain` (table[idx]) and `gather_rows_grad_plain` (an
// index_add_ of the cotangent rows, in float64 rounded once).
//
// G1: out[r, c] = table[clamp(idx[r], 0, n - 1), c] for 4-byte elements
// (float32 or int32 tables), copied as bits, one thread per output element.
// It reads idx once and each gathered element once and writes the output
// once: bound by bytes.
//
// G2: d_table[i, c] = sum of g[r, c] over the rays r with clamp(idx[r]) == i.
// It reads g and idx once and writes [n, k] once: bound by bytes too. What
// holds a plain scatter back is that a few rows take most of the rays (the
// material table, a light's emission): 262,144 adds to one address
// serialize, in torch's index backward as in a float atomicAdd. The design:
// * every sum runs in float64 and is rounded to float32 once at the end, so
//   G2 returns the exact sum to float32 rounding whatever its order (a sum
//   of 262,144 float32 shares in float32 is off by ~1e-6 of its size, and
//   by more where shares of both signs cancel);
// * a warp takes 32 consecutive rays; __match_any_sync groups its lanes by
//   row, and every lane sums its group's values for each column in lane
//   order with 32 __shfl_sync reads; the group's lowest lane then adds the
//   sum once: one add per distinct row per warp instead of one per ray;
// * small table (n * k * 8 <= SMALL_BYTES): each warp of a block owns an
//   [n, k] float64 slice of shared memory, so no two threads ever add to
//   one address at once; the block sums its slices in warp order into its
//   own [n, k] partial, and a second launch sums the partials of every
//   block per element, a warp per element (a lane per 32nd partial, then a
//   butterfly). Every sum runs in a fixed order, so two calls give the same
//   bits;
// * large table (the texture atlases): each group's sum goes to a float64
//   [n, k] buffer with one atomicAdd, and a last launch rounds it to
//   float32; the order of the float64 adds varies from call to call, so
//   the last float32 bit may too (only where the sum lies within ~1e-16
//   of a rounding boundary).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int G1_THREADS = 256;
constexpr long long G1_MAX_BLOCKS = 1 << 16;
constexpr int SMALL_BYTES = 48 * 1024;      // float64 slices of the small path
constexpr int WARPS_MAX = 8;                // warps per block of the small path
constexpr int BLOCKS_MAX = 256;             // blocks (partials) of the small path
constexpr long long PARTIALS_MAX = 1 << 20; // doubles of all partials
constexpr int SUM_THREADS = 256;            // grad_sum_kernel: a warp per element
constexpr int ATOMIC_THREADS = 256;
constexpr long long ATOMIC_MAX_BLOCKS = 1 << 14;

template <typename I>
__device__ __forceinline__ long long row_of(const I* idx, long long r, int n) {
  long long i = (long long)idx[r];
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <typename I>
__global__ void gather_kernel(const uint32_t* __restrict__ table,
                              const I* __restrict__ idx, long long m, int k,
                              int n, uint32_t* __restrict__ out) {
  const long long total = m * k;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long r = e / k;
    const int c = (int)(e - r * k);
    out[e] = table[row_of(idx, r, n) * k + c];
  }
}

// The sum, over the lanes of `peers`, of each lane's v, in lane order; every
// lane of the warp must call it.
__device__ __forceinline__ double group_sum(double v, unsigned peers) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const double x = __shfl_sync(FULL, v, j);
    if ((peers >> j) & 1u) s += x;
  }
  return s;
}

// Small path, pass 1: block b sums rays [b * per, (b + 1) * per) into
// partial[b, n * k] through one shared [n, k] slice per warp.
template <typename I>
__global__ void grad_block_kernel(const I* __restrict__ idx,
                                  const float* __restrict__ g, long long m,
                                  int k, int n, long long per,
                                  double* __restrict__ partial) {
  extern __shared__ double acc[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = n * k;
  for (int j = threadIdx.x; j < warps * nk; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  double* mine = acc + warp * nk;
  const long long begin = (long long)blockIdx.x * per;
  const long long end = begin + per < m ? begin + per : m;
  for (long long base = begin + 32LL * warp; base < end; base += 32LL * warps) {
    const long long r = base + lane;
    const bool live = r < end;
    const int i = live ? (int)row_of(idx, r, n) : -1;
    const unsigned peers = __match_any_sync(FULL, i);
    const bool leader = live && lane == __ffs(peers) - 1;
    for (int c = 0; c < k; ++c) {
      const double s = group_sum(live ? (double)g[r * k + c] : 0.0, peers);
      if (leader) mine[i * k + c] += s;
    }
  }
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * nk;
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < warps; ++w) s += acc[w * nk + j];
    out[j] = s;
  }
}

// Small path, pass 2: d_table[j] = the sum of partial[:, j] rounded to
// float32, a warp per element j.
__global__ void grad_sum_kernel(const double* __restrict__ partial, int blocks,
                                int nk, float* __restrict__ out) {
  const int j = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= nk) return;                      // the whole warp
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * nk + j];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) out[j] = (float)s;
}

// Large path, pass 1: each warp's group sums added to acc (float64 [n, k],
// zeroed by the caller) with atomicAdd.
template <typename I>
__global__ void grad_atomic_kernel(const I* __restrict__ idx,
                                   const float* __restrict__ g, long long m,
                                   int k, int n, double* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 32; base < m; base += warps * 32) {
    const long long r = base + lane;
    const bool live = r < m;
    const long long i = live ? row_of(idx, r, n) : -1;
    const unsigned peers = __match_any_sync(FULL, i);
    const bool leader = live && lane == __ffs(peers) - 1;
    for (int c = 0; c < k; ++c) {
      const double s = group_sum(live ? (double)g[r * k + c] : 0.0, peers);
      if (leader) atomicAdd(acc + i * k + c, s);
    }
  }
}

// Large path, pass 2: out = acc rounded to float32.
__global__ void round_kernel(const double* __restrict__ acc, long long nk,
                             float* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nk;
       j += step)
    out[j] = (float)acc[j];
}

// The small path's warps per block and blocks for (m, n, k), or 0 blocks
// for the large path.
void small_shape(long long m, int n, int k, int* warps, int* blocks) {
  const long long bytes = 8LL * n * k;
  *warps = 0;
  *blocks = 0;
  if (bytes > SMALL_BYTES || m <= 0) return;
  long long w = SMALL_BYTES / bytes;
  *warps = (int)(w < WARPS_MAX ? w : WARPS_MAX);
  long long b = (m + 32LL * *warps * 4 - 1) / (32LL * *warps * 4);
  const long long cap = PARTIALS_MAX / ((long long)n * k);
  if (b > BLOCKS_MAX) b = BLOCKS_MAX;
  if (b > cap) b = cap;
  *blocks = (int)(b < 1 ? 1 : b);
}

template <typename I>
int launch_grad(const void* idx, const float* g, long long m, int k, int n,
                double* scratch, float* out, cudaStream_t stream) {
  if (!scratch) return (int)cudaErrorInvalidValue;
  int warps, blocks;
  small_shape(m, n, k, &warps, &blocks);
  const int nk = n * k;
  cudaError_t err;
  if (blocks) {
    long long per = (m + blocks - 1) / blocks;
    per = (per + 31) / 32 * 32;
    grad_block_kernel<I><<<blocks, 32 * warps, (size_t)warps * nk * 8, stream>>>(
        (const I*)idx, g, m, k, n, per, scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long threads = 32LL * nk;
    grad_sum_kernel<<<(int)((threads + SUM_THREADS - 1) / SUM_THREADS),
                      SUM_THREADS, 0, stream>>>(scratch, blocks, nk, out);
    return (int)cudaGetLastError();
  }
  long long b = (m + ATOMIC_THREADS - 1) / ATOMIC_THREADS;
  if (b > ATOMIC_MAX_BLOCKS) b = ATOMIC_MAX_BLOCKS;
  grad_atomic_kernel<I><<<(int)b, ATOMIC_THREADS, 0, stream>>>(
      (const I*)idx, g, m, k, n, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long rb = (nk + ATOMIC_THREADS - 1) / ATOMIC_THREADS;
  if (rb > ATOMIC_MAX_BLOCKS) rb = ATOMIC_MAX_BLOCKS;
  round_kernel<<<(int)rb, ATOMIC_THREADS, 0, stream>>>(scratch, nk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out [m, k] = table[clamp(idx), :] for a table [n, k] of 4-byte elements;
// idx is int64 when idx64, else int32.
extern "C" int rz_gather_rows(const void* table, const void* idx, int idx64,
                              long long m, int k, int n, void* out,
                              void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (n <= 0 || m > LLONG_MAX / k) return (int)cudaErrorInvalidValue;
  long long b = (m * k + G1_THREADS - 1) / G1_THREADS;
  if (b > G1_MAX_BLOCKS) b = G1_MAX_BLOCKS;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    gather_kernel<long long><<<(int)b, G1_THREADS, 0, s>>>(
        (const uint32_t*)table, (const long long*)idx, m, k, n, (uint32_t*)out);
  else
    gather_kernel<int><<<(int)b, G1_THREADS, 0, s>>>(
        (const uint32_t*)table, (const int*)idx, m, k, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// Doubles of the small path's partials for (m, n, k): 0 when G2 takes the
// large path or there is nothing to sum.
extern "C" long long rz_gather_grad_partials(long long m, int n, int k) {
  int warps, blocks;
  small_shape(m, n, k, &warps, &blocks);
  return (long long)blocks * n * k;
}

// out [n, k] (float32) = the sum of g [m, k] rows per clamped index.
// scratch: rz_gather_grad_partials(m, n, k) doubles, or, when that is 0,
// n * k doubles set to zero (the large path's accumulator).
extern "C" int rz_gather_rows_grad(const void* idx, int idx64, const float* g,
                                   long long m, int k, int n, double* scratch,
                                   float* out, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (n <= 0 || (long long)n * k > INT_MAX || m > LLONG_MAX / k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? launch_grad<long long>(idx, g, m, k, n, scratch, out, s)
               : launch_grad<int>(idx, g, m, k, n, scratch, out, s);
}
