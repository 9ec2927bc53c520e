// Threefry uniforms of one render pass: the [rows, ns] float32 draws of
// image rows [row0, row0 + height), each row of width * ns numbers.
//
// Replaces no TPU kernel: the JAX package draws these streams in XLA
// (rayzath_tpu/engine/integrator.py `pass_uniforms`, jax.random's default
// threefry2x32 in its partitionable layout). The plain version is
// ops/rng.py `uniform_rows_plain`, and this kernel returns its bits exactly:
// row y is keyed by fold_in(pass_key, y) = threefry2x32(pass_key, (0, y)),
// element e of the row (e = pixel * ns + stream) takes the bits
// x0 ^ x1 of threefry2x32(row_key, (0, e)), and the float is
// bitcast((bits >> 9) | 0x3F800000) - 1, exact in float32.
//
// What bounds it on the H100: the function writes R * ns * 4 bytes once and
// reads nothing but its arguments, and per element it runs 20 rounds of
// (add, rotate, xor) plus the key injections: integer operations, about
// five times the time of the bytes at the card's int32 rate. The plain
// version in torch is ~200 elementwise int64 launches over the same
// elements, each reading and writing the whole [R, ns] block.
//
// What the design does about it: one launch; each thread keeps its words in
// registers through the 20 rounds (rotations as funnel shifts) and writes
// PER_THREAD floats, neighbouring threads on neighbouring addresses. A block
// covers THREADS * PER_THREAD elements of one row, and its first thread
// derives that row's key once, in a prologue, into shared memory, so the
// key costs one hash per block instead of one per element.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int MAX_GRID_Y = 65535;
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// jax's threefry2x32, 20 rounds: key (k0, k1), counter (x0, x1) in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
#define RZ_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define RZ_ROUNDS_A RZ_ROUND(13) RZ_ROUND(15) RZ_ROUND(26) RZ_ROUND(6)
#define RZ_ROUNDS_B RZ_ROUND(17) RZ_ROUND(29) RZ_ROUND(16) RZ_ROUND(24)
  x0 += k0;
  x1 += k1;
  RZ_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  RZ_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  RZ_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  RZ_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  RZ_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef RZ_ROUNDS_B
#undef RZ_ROUNDS_A
#undef RZ_ROUND
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void __launch_bounds__(THREADS)
uniform_kernel(float* __restrict__ out, uint32_t k0, uint32_t k1, int row0,
               int height, int row_len) {
  __shared__ uint32_t row_key[2];
  const int base = blockIdx.x * (THREADS * PER_THREAD) + threadIdx.x;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    if (threadIdx.x == 0) {
      uint32_t a = 0u, b = (uint32_t)(row0 + y);
      threefry2x32(k0, k1, a, b);
      row_key[0] = a;
      row_key[1] = b;
    }
    __syncthreads();
    const uint32_t r0 = row_key[0], r1 = row_key[1];
    float* row = out + (size_t)y * (size_t)row_len;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int e = base + j * THREADS;
      if (e < row_len) {
        uint32_t x0 = 0u, x1 = (uint32_t)e;
        threefry2x32(r0, r1, x0, x1);
        row[e] = to_unit(x0 ^ x1);
      }
    }
    __syncthreads();  // every thread has read row_key before the next row's
  }
}

}  // namespace

// out: float[height][width * ns]; (k0, k1): the pass key.
extern "C" int rz_threefry_uniform(float* out, unsigned int k0,
                                   unsigned int k1, int row0, int height,
                                   int width, int ns, void* stream) {
  if (height <= 0 || width <= 0 || ns <= 0) return 0;
  const long long row_len = (long long)width * ns;
  if (row_len > INT_MAX - THREADS * PER_THREAD)
    return (int)cudaErrorInvalidValue;
  const int per_block = THREADS * PER_THREAD;
  const dim3 grid((unsigned)((row_len + per_block - 1) / per_block),
                  (unsigned)(height < MAX_GRID_Y ? height : MAX_GRID_Y));
  uniform_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      out, k0, k1, row0, height, (int)row_len);
  return (int)cudaGetLastError();
}
