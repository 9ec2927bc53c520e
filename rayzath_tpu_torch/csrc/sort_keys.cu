// Coherence keys of a batch of rays, ahead of the ray sort: the int64 key
// of ops/sort_rays.py `coherence_keys_plain`, bit for bit, in two launches.
//
// Replaces no TPU kernel: the JAX package computes the key in XLA
// (rayzath_tpu/ops/sort_rays.py `coherence_keys`). The key's bits:
//
//   [31:26] coarse origin cell    (2 bits/axis, batch-normalized bounds)
//   [25:23] direction octant      (3 bits)
//   [22:15] direction bits        (4+4 bits of the two minor |d| ratios)
//   [14:0]  fine origin Morton    (5 bits/axis)
//
// The plain version in torch is ~90 elementwise launches plus a top-2 of
// three lanes per ray (torch.topk's radix select and a sort of its two
// outputs); here the top two of the two non-dominant ratios are their max
// and min.
//
// What bounds it on the H100: bytes. A ray reads its origin and direction
// (24 B) and writes its key (8 B): 29.5 MB at 921,600 rays, 8.8 us at
// 3.35 TB/s; the bounds launch reads the origins once more (11 MB, most of
// them left in L2 for the keys). Per ray about 150 instructions, five of
// them IEEE divisions, which the card issues in less than the bytes' time.
//
// The design:
// * `ray_sort_bounds_kernel`: each of at most BLOCKS blocks folds a
//   grid-stride share of the origins, read as a flat float array, into the
//   min and max of each axis, and writes them to its row of the
//   [blocks, 6] partials (min x, y, z, max x, y, z). The block and the grid
//   hold a multiple of 3 threads, so a thread only ever meets one axis.
// * `ray_sort_key_kernel`: each block first folds every row of the
//   partials in shared memory (at most BLOCKS x 6 floats from L2), which
//   gives the batch's bounds, then computes one key per ray in a
//   grid-stride loop.
// * min and max keep a NaN, as torch's amin/amax do; min and max are exact
//   in any order, so the keys do not depend on the fold's order, and a
//   zero's sign in a bound cannot change a key. No atomics, no host sync,
//   no allocation: the two launches capture into a CUDA graph.
// * The float arithmetic is the plain path's, op for op and in its order,
//   each op rounded on its own (-fmad=false): (v - lo) / clamp(hi - lo,
//   1e-20) * levels, clamped (a NaN kept, as torch.clamp keeps it) and
//   truncated to int64; |d| / clamp(max |d|, 1e-20). The dominant lane is
//   torch.argmax's (the first maximum; a NaN counts as the largest), and the
//   two others are ordered as torch.topk orders values (a NaN first). The
//   bit fields are assembled in 64-bit unsigned arithmetic, which is what
//   torch's int64 shifts, ands and ors compute.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 768;          // a multiple of 3: thread t keeps axis t % 3
constexpr int BLOCKS = 264;           // the most blocks of a launch (2 per SM of an H100)

static_assert(THREADS % 3 == 0 && (THREADS / 3 & (THREADS / 3 - 1)) == 0,
              "the block fold halves THREADS down to 3");

__device__ __forceinline__ float fold_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float fold_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// torch.clamp(x, min=lower): a NaN stays
__device__ __forceinline__ float clamp_min(float x, float lower) {
  return isnan(x) ? x : fmaxf(x, lower);
}

// Fold every thread's (lo, hi) into threads 0-2 of s_lo and s_hi (axes x,
// y, z): a tree over strides that are multiples of 3, so a thread only
// meets threads of its own axis. Ends on a barrier: every thread may read
// the result.
__device__ __forceinline__ void fold_block(float lo, float hi, float* s_lo,
                                           float* s_hi) {
  const int t = threadIdx.x;
  s_lo[t] = lo;
  s_hi[t] = hi;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s >= 3; s /= 2) {
    if (t < s) {
      s_lo[t] = fold_min(s_lo[t], s_lo[t + s]);
      s_hi[t] = fold_max(s_hi[t], s_hi[t + s]);
    }
    __syncthreads();
  }
}

// ops/sort_rays.py `_quant` of one value: (v - lo) / span * levels,
// clamped to [0, levels - 1] and truncated, as the int64 bit pattern
__device__ __forceinline__ uint64_t quant(float v, float lo, float span,
                                          float levels) {
  float q = (v - lo) / span * levels;
  q = isnan(q) ? q : fminf(fmaxf(q, 0.0f), levels - 1.0f);
  return (uint64_t)(long long)q;
}

// interleave with two zero bits per bit (Morton), as `_spread3`
__device__ __forceinline__ uint64_t spread3(uint64_t x) {
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  x = (x | (x << 2)) & 0x09249249ull;
  return x;
}

__global__ void __launch_bounds__(THREADS, 2)
ray_sort_bounds_kernel(const float* __restrict__ origin, long long n3,
                       float* __restrict__ parts) {
  __shared__ float s_lo[THREADS], s_hi[THREADS];
  float lo = INFINITY, hi = -INFINITY;
  const long long stride = (long long)gridDim.x * THREADS;   // a multiple of 3
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n3;
       i += stride) {
    const float v = __ldg(origin + i);
    lo = fold_min(lo, v);
    hi = fold_max(hi, v);
  }
  fold_block(lo, hi, s_lo, s_hi);
  if (threadIdx.x < 3) {
    parts[blockIdx.x * 6 + threadIdx.x] = s_lo[threadIdx.x];
    parts[blockIdx.x * 6 + 3 + threadIdx.x] = s_hi[threadIdx.x];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
ray_sort_key_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction, long long n,
                    const float* __restrict__ parts, int n_parts,
                    long long* __restrict__ keys) {
  __shared__ float s_lo[THREADS], s_hi[THREADS];
  float lo = INFINITY, hi = -INFINITY;
  for (int j = threadIdx.x; j < 3 * n_parts; j += THREADS) {
    const float* row = parts + (j / 3) * 6 + j % 3;
    lo = fold_min(lo, __ldg(row));
    hi = fold_max(hi, __ldg(row + 3));
  }
  fold_block(lo, hi, s_lo, s_hi);
  const float lo_x = s_lo[0], lo_y = s_lo[1], lo_z = s_lo[2];
  const float span_x = clamp_min(s_hi[0] - lo_x, 1e-20f);
  const float span_y = clamp_min(s_hi[1] - lo_y, 1e-20f);
  const float span_z = clamp_min(s_hi[2] - lo_z, 1e-20f);

  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float ox = __ldg(origin + 3 * i), oy = __ldg(origin + 3 * i + 1),
                oz = __ldg(origin + 3 * i + 2);
    const float dx = __ldg(direction + 3 * i),
                dy = __ldg(direction + 3 * i + 1),
                dz = __ldg(direction + 3 * i + 2);
    // origin cells: 2 and 5 bits an axis (the same quotient feeds both)
    const uint64_t coarse = quant(ox, lo_x, span_x, 4.0f)
                            | (quant(oy, lo_y, span_y, 4.0f) << 2)
                            | (quant(oz, lo_z, span_z, 4.0f) << 4);
    const uint64_t fine = (spread3(quant(ox, lo_x, span_x, 32.0f))
                           | (spread3(quant(oy, lo_y, span_y, 32.0f)) << 1)
                           | (spread3(quant(oz, lo_z, span_z, 32.0f)) << 2))
                          & 0x7FFFull;
    // the two non-dominant |d| ratios
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const float m = clamp_min(fold_max(fold_max(ax, ay), az), 1e-20f);
    int axis = 0;
    float best = ax;
    if (!isnan(best) && (isnan(ay) || ay > best)) {
      axis = 1;
      best = ay;
    }
    if (!isnan(best) && (isnan(az) || az > best)) axis = 2;
    const float a = (axis == 0 ? ay : ax) / m;
    const float b = (axis == 2 ? ay : az) / m;
    const bool a_first = isnan(a) || a > b;
    const uint64_t db = (quant(a_first ? a : b, 0.0f, 1.0f, 16.0f) << 4)
                        | quant(a_first ? b : a, 0.0f, 1.0f, 16.0f);
    const uint64_t octant = (uint64_t)(dx < 0.0f)
                            | ((uint64_t)(dy < 0.0f) << 1)
                            | ((uint64_t)(dz < 0.0f) << 2);
    keys[i] = (long long)((coarse << 26) | (octant << 23) | (db << 15) | fine);
  }
}

int bounds_blocks(long long n) {
  const long long need = (3 * n + THREADS - 1) / THREADS;
  return (int)(need < BLOCKS ? need : BLOCKS);
}

}  // namespace

// Floats of the partials buffer that rz_ray_sort_keys takes for n rays.
extern "C" long long rz_ray_sort_partials(long long n) {
  return n > 0 ? 6LL * bounds_blocks(n) : 0;
}

// keys[i]: the coherence key of ray i. origin, direction: float[n][3];
// parts: rz_ray_sort_partials(n) floats of scratch; keys: int64[n].
extern "C" int rz_ray_sort_keys(const float* origin, const float* direction,
                                long long n, float* parts, long long* keys,
                                void* stream) {
  if (n <= 0) return 0;
  const int n_parts = bounds_blocks(n);
  const long long need = (n + THREADS - 1) / THREADS;
  const int key_blocks = (int)(need < BLOCKS ? need : BLOCKS);
  const cudaStream_t s = (cudaStream_t)stream;
  ray_sort_bounds_kernel<<<n_parts, THREADS, 0, s>>>(origin, 3 * n, parts);
  ray_sort_key_kernel<<<key_blocks, THREADS, 0, s>>>(origin, direction, n,
                                                     parts, n_parts, keys);
  return (int)cudaGetLastError();
}
