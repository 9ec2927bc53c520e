// Row gathers from a table and their backward: G1 (`gather_kernel`,
// `gather_vec_kernel`) and G2 (`grad_block_kernel` + `grad_sum_kernel` for a
// table that fits in shared memory, `grad_atomic_kernel` + `round_kernel`
// for one that does not).
//
// Replaces rayzath_tpu/ops/gather.py `gather_rows`, which is not a Pallas
// kernel: for a table of at most 128 rows it is a one-hot product on the
// MXU, so its transpose, the table's gradient, is a dense reduction of the
// cotangents onto each row. The plain versions are ops/gather.py
// `gather_rows_plain` (table[idx]) and `gather_rows_grad_plain` (an
// index_add_ of the cotangent rows, in float64 rounded once).
//
// G1: out[r, c] = table[clamp(idx[r], 0, n - 1), c] for 4-byte elements
// (float32 or int32 tables), copied as bits. It reads idx once and writes
// the output once: bound by bytes, and by the latency of its dependent
// loads (an index, then that row) unless every thread keeps 16 bytes in
// flight. So a thread writes one 16-byte word of the output:
// * a width that is a multiple of 4 words on a 16-byte aligned table
//   (the texture fetch's [R, 4] block corners and texels, tri_pack's 32):
//   `gather_vec_kernel`, the word one uint4 row vector, read and written
//   whole (6-10% faster there than `gather_kernel` on an H100);
// * any other width (14 for the material table, 3 and 1 for the lights
//   and the scalar atlas): `gather_kernel`, whose 4 consecutive output
//   elements span at most two rows (four at width 1); it reads each row's
//   index once and the 4 elements from the table (which L1 holds: these
//   tables are small) and stores them as one uint4, so a warp's stores
//   leave as 512 contiguous bytes without a round trip through shared
//   memory.
// Both read the width at run time: a constant width was no faster. Offsets
// are 32-bit where the output and the table hold fewer than 2^31 elements.
//
// G2: d_table[i, c] = sum of g[r, c] over the rays r with clamp(idx[r]) == i.
// It reads g and idx once and writes [n, k] once: bound by bytes too, and
// every sum runs in float64 and is rounded to float32 once, so G2 returns
// the exact sum to float32 rounding whatever its order (a sum of 262,144
// float32 shares in float32 is off by ~1e-6 of its size, and by more where
// shares of both signs cancel). A few rows take most of the rays (the
// material table, a light's emission), so a plain scatter serializes on a
// few addresses, and a warp shuffle per value would be bound by the SM's
// one shuffle a clock. No value is shuffled; what is left is bound by the
// instructions each ray costs:
// * small table ([n, k] float64 fits in SMEM_BYTES; the material, light
//   and opacity tables): lanes are columns. A warp takes a run of
//   consecutive rays, its lanes form 32 / 2^s groups of 2^s lanes (2^s the
//   least power of two >= k: 2 groups at width 14, 8 at width 4, 32 at
//   width 1), one group per ray in turn, so that a load of the warp reads
//   consecutive rows; each lane keeps the running sum of its column over a
//   row's rays and adds it to its group's own [n, k] slice of shared
//   memory when the row changes: a load of the index, a load of g, a
//   compare, a conversion and an add per ray and group. No two lanes add
//   to one address at once; the block sums its slices in a fixed
//   order into its [n, k] partial, and a second launch sums the partials
//   of every block per element, a warp per element (a lane per 32nd
//   partial, then a butterfly). Every sum runs in a fixed order, so two
//   calls give the same bits;
// * large table (the texture atlases): a running sum per lane would add to
//   the atlas once per ray at random texels, so a warp takes 32
//   consecutive rays, groups them by row (__match_any_sync on the 32-bit
//   row) and lists each group in shared memory; its lanes take (group,
//   column) pairs, each sums its group's values of its column in lane
//   order (four reads of g in flight at a time; staging them in shared
//   memory was slower on the H100) and adds the sum to a float64 [n, k]
//   buffer with one atomicAdd, and a last launch rounds it to float32; the
//   order of the float64 adds varies from call to call, so the last
//   float32 bit may too (only where the sum lies within ~1e-16 of a
//   rounding boundary).
// The zeroing of the atomic path's buffer (a fill, 1.0 us) and the second
// launches (the sum 2.0 us, the round 1.4 us) stay: fusing them needs
// either a buffer kept zeroed from call to call, which a failed or an
// overlapping call leaves dirty for every later one, or a barrier across
// the grid, whose blocks a CUDA graph does not promise to keep resident
// together.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int G1_THREADS = 256;
constexpr long long G1_MAX_BLOCKS = 1 << 20;
constexpr int SMEM_BYTES = 48 * 1024;       // a block of the small path
constexpr int WARPS_MAX = 16;               // warps a block, small path
constexpr int RAYS_PER_WARP = 64;           // the small path's rays a warp
constexpr int G2_UNROLL = 8;                // rays a small-path lane loads
constexpr int BLOCKS_MAX = 256;             // blocks (partials) of the small path
constexpr long long PARTIALS_MAX = 1 << 20; // doubles of all partials
constexpr int SUM_THREADS = 256;            // grad_sum_kernel: a warp per element
constexpr int ATOMIC_THREADS = 256;
constexpr long long ATOMIC_MAX_BLOCKS = 1 << 16;

// an index clamped into a table of n rows, as JAX clamps a take
template <typename I>
__device__ __forceinline__ int clamp_row(I i, int n) {
  return i < 0 ? 0 : (i >= (I)n ? n - 1 : (int)i);
}

template <typename I>
__device__ __forceinline__ int row_of(const I* idx, long long r, int n) {
  return clamp_row(idx[r], n);
}

// log2 of the lanes per group for width k: the least power of two >= k,
// at most 32
__host__ __device__ inline int lane_shift(int k) {
  int s = 0;
  while (s < 5 && (1 << s) < k) ++s;
  return s;
}

// G1, any width: thread j writes output elements [4j, 4j + 4) (fewer in
// the last word).
template <typename I, typename O>
__global__ void __launch_bounds__(G1_THREADS)
gather_kernel(const uint32_t* __restrict__ table, const I* __restrict__ idx,
              O m, int width, int n, bool aligned,
              uint32_t* __restrict__ out) {
  const O k = (O)width;
  const O total = m * k;
  const O words = (total + 3) / 4;
  const O step = (O)gridDim.x * blockDim.x;
  for (O j = (O)blockIdx.x * blockDim.x + threadIdx.x; j < words; j += step) {
    const O e0 = 4 * j;
    O r = e0 / k;
    O c = e0 - r * k;
    int row = row_of(idx, (long long)r, n);
    uint32_t v[4];
    const int live = total - e0 < 4 ? (int)(total - e0) : 4;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w < live) {
        if (c == k) {
          c = 0;
          ++r;
          row = row_of(idx, (long long)r, n);
        }
        v[w] = table[(O)row * k + c];
        ++c;
      }
    }
    if (live == 4 && aligned) {
      reinterpret_cast<uint4*>(out)[j] = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (w < live) out[e0 + w] = v[w];
    }
  }
}

// G1, a width of 4 * vecs_per_row words and a 16-byte aligned table and
// output: thread j copies the 16-byte vector j of the output.
template <typename I, typename O>
__global__ void __launch_bounds__(G1_THREADS)
gather_vec_kernel(const uint4* __restrict__ table, const I* __restrict__ idx,
                  O m, int vecs_per_row, int n, uint4* __restrict__ out) {
  const O v = (O)vecs_per_row;
  const O vecs = m * v;
  const O step = (O)gridDim.x * blockDim.x;
  for (O j = (O)blockIdx.x * blockDim.x + threadIdx.x; j < vecs; j += step) {
    const O r = j / v;
    out[j] = table[(O)row_of(idx, (long long)r, n) * v + (j - r * v)];
  }
}

template <typename I, typename O>
int launch_gather(const void* table, const I* idx, long long m, int k, int n,
                  void* out, cudaStream_t s) {
  const bool al = (uintptr_t)out % 16 == 0;    // uint4 stores
  const bool vec = k % 4 == 0 && al && (uintptr_t)table % 16 == 0;
  const long long work = vec ? m * (k / 4) : (m * k + 3) / 4;
  long long b = (work + G1_THREADS - 1) / G1_THREADS;
  if (b > G1_MAX_BLOCKS) b = G1_MAX_BLOCKS;
  const dim3 grid((unsigned)b), block(G1_THREADS);
  if (vec)
    gather_vec_kernel<I, O><<<grid, block, 0, s>>>(
        (const uint4*)table, idx, (O)m, k / 4, n, (uint4*)out);
  else
    gather_kernel<I, O><<<grid, block, 0, s>>>(
        (const uint32_t*)table, idx, (O)m, k, n, al, (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_gather_idx(const void* table, const void* idx, long long m, int k,
                      int n, void* out, cudaStream_t s) {
  // 32-bit offsets while every output element and table element has one
  const long long big = INT_MAX;
  if (m * k + 3 <= big && (long long)n * k <= big)
    return launch_gather<I, uint32_t>(table, (const I*)idx, m, k, n, out, s);
  return launch_gather<I, unsigned long long>(table, (const I*)idx, m, k, n,
                                              out, s);
}

// G2, the large path's grouping of one warp's 32 rays: `raw` the lane's
// index, `live` whether the lane has a ray. The groups' rows and lane
// masks go to `list`, in the order of their lowest lane; returns the
// number of groups. Every lane of the warp must call it.
template <typename I>
__device__ __forceinline__ int group_rays(I raw, bool live, int n, int lane,
                                          int2* list) {
  const int row = live ? clamp_row(raw, n) : -1;
  const unsigned peers = __match_any_sync(FULL, row);
  const bool leader = live && lane == __ffs(peers) - 1;
  const unsigned leaders = __ballot_sync(FULL, leader);
  if (leader)
    list[__popc(leaders & ((1u << lane) - 1u))] = make_int2(row, (int)peers);
  __syncwarp();
  return __popc(leaders);
}

// The large path's sums of one warp's groups: its lanes take (group,
// column) pairs, 2^shift lanes per group (the least power of two >= k, at
// most 32), and each adds `add(row, c, s)` with s the float64 sum, in lane
// order, of column c of its group's rows of `rows` (g from the warp's
// first ray on), four reads in flight at a time.
template <typename Add>
__device__ __forceinline__ void sum_groups(const float* __restrict__ rows,
                                           int k, int lane, int shift,
                                           const int2* list, int groups,
                                           Add add) {
  const int per = 1 << shift;
  for (int j = lane >> shift; j < groups; j += 32 >> shift) {
    const int2 e = list[j];
    for (int c = lane & (per - 1); c < k; c += per) {
      unsigned lanes = (unsigned)e.y;
      double s = 0.0;
      while (lanes) {
        float v[4];
        int got = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (lanes) {
            const int q = __ffs(lanes) - 1;
            lanes &= lanes - 1u;
            v[u] = rows[(long long)q * k + c];
            got = u + 1;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < got) s += (double)v[u];
      }
      add(e.x, c, s);
    }
  }
}

// Small path, pass 1: block b sums rays [b * warps * chunk, ...) into
// partial[b, n * k]. Each warp takes `chunk` consecutive rays; its lanes
// form `groups` groups of 32 / groups lanes, a lane per column, and group q
// takes rays q, q + groups, ... of the warp's chunk (so one load of the
// warp reads `groups` consecutive rows). A lane keeps the running sum of
// its column over the rays of one row and adds it to its group's own
// [n, k] float64 slice of shared memory when the row changes: no two lanes
// ever add to one address at once, and every sum runs in ray order.
// Shared memory: warps x groups slices.
template <typename I>
__global__ void __launch_bounds__(32 * WARPS_MAX)
grad_block_kernel(const I* __restrict__ idx, const float* __restrict__ g,
                  long long m, int k, int n, int groups, long long chunk,
                  double* __restrict__ partial) {
  extern __shared__ double acc[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = n * k;
  const int slices = warps * groups;
  for (int j = threadIdx.x; j < slices * nk; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  const int per = 32 / groups;              // lanes per group
  const int q = lane / per, cl = lane - q * per;
  double* mine = acc + (warp * groups + q) * nk;
  const long long r0 = ((long long)blockIdx.x * warps + warp) * chunk;
  const long long r1 = r0 + chunk < m ? r0 + chunk : m;
  for (int c = cl; c < k; c += per) {       // one pass unless k > 32
    int cur = -1;
    double s = 0.0;
    const I* ip = idx + r0 + q;
    const float* gp = g + (r0 + q) * k + c;
    const long long gstep = (long long)groups * k;
    for (long long r = r0 + q; r < r1; r += (long long)groups * G2_UNROLL) {
      int rows[G2_UNROLL];
      float v[G2_UNROLL];
#pragma unroll
      for (int u = 0; u < G2_UNROLL; ++u) {   // the loads first, all in flight
        const bool in = r + (long long)u * groups < r1;
        rows[u] = in ? row_of(ip, (long long)u * groups, n) : -1;
        v[u] = in ? gp[u * gstep] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < G2_UNROLL; ++u) {
        if (rows[u] < 0) break;
        if (rows[u] != cur) {
          if (cur >= 0) mine[cur * k + c] += s;
          cur = rows[u];
          s = 0.0;
        }
        s += (double)v[u];
      }
      ip += groups * G2_UNROLL;
      gp += gstep * G2_UNROLL;
    }
    if (cur >= 0) mine[cur * k + c] += s;
  }
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * nk;
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < slices; ++w) s += acc[w * nk + j];
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

// Large path, pass 1: each warp takes 32 consecutive rays, groups them by
// row and adds each group's sums to acc (float64 [n, k], zeroed by the
// caller) with atomicAdd: one add per distinct row and column per warp.
template <typename I>
__global__ void __launch_bounds__(ATOMIC_THREADS)
grad_atomic_kernel(const I* __restrict__ idx, const float* __restrict__ g,
                   long long m, int k, int n, double* __restrict__ acc) {
  __shared__ int2 lists[ATOMIC_THREADS / 32][32];
  const int lane = threadIdx.x & 31;
  int2* list = lists[threadIdx.x >> 5];
  const int shift = lane_shift(k < 32 ? k : 32);
  const long long tiles = (m + 31) / 32;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       t < tiles; t += warps) {
    const long long base = 32 * t;
    const bool live = base + lane < m;
    const int groups = group_rays(live ? idx[base + lane] : (I)0, live, n,
                                  lane, list);
    sum_groups(g + base * k, k, lane, shift, list, groups,
               [&](int row, int c, double s) {
                 atomicAdd(acc + (long long)row * k + c, s);
               });
    __syncwarp();                         // the list is rewritten next tile
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

// The small path's shape for (m, n, k): warps per block, lane groups per
// warp, rays per warp and blocks (0 blocks: the large path).
struct SmallShape {
  int warps = 0, groups = 0, blocks = 0;
  long long chunk = 0;
};

SmallShape small_shape(long long m, int n, int k) {
  SmallShape sh;
  const long long slice = 8LL * n * k;
  if (slice > SMEM_BYTES || m <= 0) return sh;
  // lane groups: 32 / (the least power of two >= k), fewer where the
  // slices would not fit
  sh.groups = 1 << (5 - lane_shift(k < 32 ? k : 32));
  while (sh.groups > 1 && sh.groups * slice > SMEM_BYTES) sh.groups >>= 1;
  const long long w = SMEM_BYTES / (sh.groups * slice);
  sh.warps = (int)(w < WARPS_MAX ? w : WARPS_MAX);
  const long long rays = (long long)RAYS_PER_WARP * sh.warps;
  long long b = (m + rays - 1) / rays;
  const long long cap = PARTIALS_MAX / ((long long)n * k);
  if (b > BLOCKS_MAX) b = BLOCKS_MAX;
  if (b > cap) b = cap;
  sh.blocks = (int)(b < 1 ? 1 : b);
  const long long per_block = (m + sh.blocks - 1) / sh.blocks;
  sh.chunk = (per_block + sh.warps - 1) / sh.warps;
  return sh;
}

template <typename I>
int launch_grad(const void* idx, const float* g, long long m, int k, int n,
                double* scratch, float* out, cudaStream_t stream) {
  if (!scratch) return (int)cudaErrorInvalidValue;
  const SmallShape sh = small_shape(m, n, k);
  const int nk = n * k;
  cudaError_t err;
  if (sh.blocks) {
    const size_t smem = (size_t)sh.warps * sh.groups * 8 * nk;
    grad_block_kernel<I><<<sh.blocks, 32 * sh.warps, smem, stream>>>(
        (const I*)idx, g, m, k, n, sh.groups, sh.chunk, scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long threads = 32LL * nk;
    grad_sum_kernel<<<(int)((threads + SUM_THREADS - 1) / SUM_THREADS),
                      SUM_THREADS, 0, stream>>>(scratch, sh.blocks, nk, out);
    return (int)cudaGetLastError();
  }
  long long b = ((m + 31) / 32 * 32 + ATOMIC_THREADS - 1) / ATOMIC_THREADS;
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
  if (n <= 0 || m > (LLONG_MAX - 3) / k) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? launch_gather_idx<long long>(table, idx, m, k, n, out, s)
               : launch_gather_idx<int>(table, idx, m, k, n, out, s);
}

// Doubles of the small path's partials for (m, n, k): 0 when G2 takes the
// large path or there is nothing to sum.
extern "C" long long rz_gather_grad_partials(long long m, int n, int k) {
  return (long long)small_shape(m, n, k).blocks * n * k;
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
