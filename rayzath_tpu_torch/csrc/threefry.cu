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
// (add, rotate, xor) plus the key injections, about 70 instructions: twice
// the time of the bytes at the card's issue rate (four warp instructions a
// clock per SM, whatever their pipe). A kernel that leaves every integer
// instruction to the integer pipe, which takes a warp instruction every
// other clock, runs at half that rate; the plain version in torch is ~200
// elementwise int64 launches, each reading and writing the whole block.
//
// What the design does about it:
// * the adds (rounds and key injections) issue as IMAD on the FMA pipe:
//   `add` multiplies by `one`, a kernel argument (always 1) the compiler
//   cannot fold, so the integer pipe keeps only the funnel-shift rotations
//   and the xors, and the two pipes share the issue slots;
// * each warp owns SPAN consecutive floats of the flattened output, in
//   STEPS steps of UNIT consecutive floats per lane (two float4 stores);
//   lane i hashes the key of the span's (i + 1)-th row once, and a unit
//   takes its row's key from that lane with __shfl_sync: no shared memory,
//   no barrier, one row-key hash per lane per 32 float hashes;
// * a unit that crosses a row's end, ends the output, or lies past the
//   span's 32 keyed rows (rows shorter than ~32 floats) hashes each float's
//   row key itself and stores floats one by one;
// * one span per warp: a 512^2 x 14 pass is 896 blocks of 4 warps, all
//   resident at once (6.8 per SM), so no grid-stride loop is needed.
//
// Two entry points draw the same pass. `rz_threefry_uniform` takes the pass
// key by value. `rz_threefry_uniform_keyed` takes the render's key words
// and the pass index as device pointers and folds the pass key on the
// device, fold_in(key, pass_idx) = threefry2x32(key, (0, pass_idx)): a
// CUDA graph freezes a launch's arguments, and a replayed pass must draw
// from the pass counter it reads when it runs (engine/cycle.py). Each warp
// hashes the pass key once, its lanes in lockstep: one hash on top of a
// lane's 33, and three cached 4-byte loads.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                    // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int UNIT = 8;                     // consecutive floats per lane and step
constexpr int STEP = 32 * UNIT;             // floats per warp and step
constexpr int STEPS = 4;
constexpr int SPAN = STEP * STEPS;          // consecutive floats per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// a + b, issued as an IMAD on the FMA pipe (`one` == 1 at run time)
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, uint32_t one) {
  return a * one + b;
}

// jax's threefry2x32, 20 rounds: key (k0, k1), counter (x0, x1) in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t one, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
#define RZ_ROUND(r)       \
  x0 = add(x0, x1, one);  \
  x1 = rotl(x1, r) ^ x0;
#define RZ_ROUNDS_A RZ_ROUND(13) RZ_ROUND(15) RZ_ROUND(26) RZ_ROUND(6)
#define RZ_ROUNDS_B RZ_ROUND(17) RZ_ROUND(29) RZ_ROUND(16) RZ_ROUND(24)
  x0 = add(x0, k0, one);
  x1 = add(x1, k1, one);
  RZ_ROUNDS_A
  x0 = add(x0, k1, one);
  x1 = add(x1, k2 + 1u, one);
  RZ_ROUNDS_B
  x0 = add(x0, k2, one);
  x1 = add(x1, k0 + 2u, one);
  RZ_ROUNDS_A
  x0 = add(x0, k0, one);
  x1 = add(x1, k1 + 3u, one);
  RZ_ROUNDS_B
  x0 = add(x0, k1, one);
  x1 = add(x1, k2 + 4u, one);
  RZ_ROUNDS_A
  x0 = add(x0, k2, one);
  x1 = add(x1, k0 + 5u, one);
#undef RZ_ROUNDS_B
#undef RZ_ROUNDS_A
#undef RZ_ROUND
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// the float of element e of a row keyed (r0, r1)
__device__ __forceinline__ float draw(uint32_t r0, uint32_t r1, uint32_t one,
                                      int e) {
  uint32_t x0 = 0u, x1 = (uint32_t)e;
  threefry2x32(r0, r1, one, x0, x1);
  return to_unit(x0 ^ x1);
}

// The draw of one pass under the pass key (k0, k1). out: the
// n = height * row_len floats, flattened; 16-byte aligned.
__device__ __forceinline__ void draw_pass(float* __restrict__ out, uint32_t k0,
                                          uint32_t k1, int row0, int row_len,
                                          int n, uint32_t one) {
  const int lane = threadIdx.x & 31;
  const int span0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * SPAN;
  if (span0 >= n) return;                   // the whole warp
  const int y_first = span0 / row_len;
  uint32_t key0 = 0u, key1 = (uint32_t)(row0 + y_first + lane);
  threefry2x32(k0, k1, one, key0, key1);    // rows past the end: unused
  int y = y_first;
  int e = span0 - y_first * row_len + lane * UNIT;
#pragma unroll 1
  for (int s = 0; s < STEPS; ++s, e += STEP) {
    while (e >= row_len) {
      e -= row_len;
      ++y;
    }
    const int ry = y - y_first;
    const uint32_t r0 = __shfl_sync(FULL, key0, ry & 31);
    const uint32_t r1 = __shfl_sync(FULL, key1, ry & 31);
    const int g = span0 + s * STEP + lane * UNIT;
    if (g >= n) continue;
    if (ry < 32 && e + UNIT <= row_len && g + UNIT <= n) {
      float v[UNIT];
#pragma unroll
      for (int j = 0; j < UNIT; ++j) v[j] = draw(r0, r1, one, e + j);
      float4* dst = reinterpret_cast<float4*>(out + g);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    int yy = y, ee = e;
    for (int j = 0; j < UNIT && g + j < n; ++j, ++ee) {
      while (ee >= row_len) {
        ee -= row_len;
        ++yy;
      }
      uint32_t a = 0u, b = (uint32_t)(row0 + yy);
      threefry2x32(k0, k1, one, a, b);
      out[g + j] = draw(a, b, one, ee);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
uniform_kernel(float* __restrict__ out, uint32_t k0, uint32_t k1, int row0,
               int row_len, int n, uint32_t one) {
  draw_pass(out, k0, k1, row0, row_len, n, one);
}

// key: the render key's two words; pass_idx: the pass counter, as jax
// folds an int32 in (its bits as uint32).
__global__ void __launch_bounds__(THREADS)
uniform_keyed_kernel(float* __restrict__ out, const uint32_t* __restrict__ key,
                     const int32_t* __restrict__ pass_idx, int row0,
                     int row_len, int n, uint32_t one) {
  uint32_t k0 = 0u, k1 = (uint32_t)__ldg(pass_idx);
  threefry2x32(__ldg(key), __ldg(key + 1), one, k0, k1);
  draw_pass(out, k0, k1, row0, row_len, n, one);
}

// The launch shape of a draw of height x width x ns floats at out: 0 and
// n, blocks; or the error that refuses it.
int launch_shape(const float* out, int height, int width, int ns, int& n,
                 unsigned& blocks) {
  const long long total = (long long)height * width * ns;
  if (total > INT_MAX - SPAN) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long spans = (total + SPAN - 1) / SPAN;
  n = (int)total;
  blocks = (unsigned)((spans + WARPS - 1) / WARPS);
  return 0;
}

}  // namespace

// out: float[height][width * ns], 16-byte aligned; (k0, k1): the pass key.
extern "C" int rz_threefry_uniform(float* out, unsigned int k0,
                                   unsigned int k1, int row0, int height,
                                   int width, int ns, void* stream) {
  if (height <= 0 || width <= 0 || ns <= 0) return 0;
  int n;
  unsigned blocks;
  if (const int err = launch_shape(out, height, width, ns, n, blocks))
    return err;
  uniform_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      out, k0, k1, row0, width * ns, n, 1u);
  return (int)cudaGetLastError();
}

// As rz_threefry_uniform under the pass key fold_in(key, *pass_idx), both
// read on the device when the kernel runs: key = uint32[2], pass_idx =
// int32[1], each 4-byte aligned.
extern "C" int rz_threefry_uniform_keyed(float* out, const unsigned int* key,
                                         const int* pass_idx, int row0,
                                         int height, int width, int ns,
                                         void* stream) {
  if (height <= 0 || width <= 0 || ns <= 0) return 0;
  int n;
  unsigned blocks;
  if (const int err = launch_shape(out, height, width, ns, n, blocks))
    return err;
  uniform_keyed_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      out, key, pass_idx, row0, width * ns, n, 1u);
  return (int)cudaGetLastError();
}
