// B2-grad: the backward of the flat-table shadow product (B2), as two
// ranked front-to-back walks per block of 128 rays with no alpha stop.
//
// Replaces the backward rule of the JAX package's custom_vjp around
// `_shadow_kernel` (rayzath_tpu/ops/traverse_cluster.py
// `_make_cluster_shadow` bwd, lines 1327-1339): there a dense replay of
// every ray against every triangle (`project_shadow` in
// rayzath_tpu/ops/intersect.py, compiled by XLA), not a Pallas kernel.
// What it computes is that rule's result for the opacity table: with
// cotangents (g_rgb [R,3], g_a [R]), d_op_tab [cp][4][CT] where slot j of
// cluster c gets, for every ray r that hits it with t in (0, dist_r) and
// per channel k, g[r,k] times the product of the ray's other factors on
// channel k, over every hit (the replay has no stop). The rays, dist and
// the triangles get no gradient: the product is piecewise constant in
// them.
//
// The product of the others, without a division by zero: walk 1 keeps per
// ray and channel the product P of the non-zero factors and the count z of
// zero factors (an opaque surface has a factor of exactly 0); walk 2 gives
// a hit of factor f the share g P / f when f != 0 and z == 0, g P when
// f == 0 and z == 1, and nothing otherwise.
//
// What bounds it on the H100: the forward's work twice without the stop,
// per ray the clusters whose slab interval meets (0, dist), each 128
// ray-triangle tests of 49 f32 operations, plus a division and an add per
// hit and channel; the bytes are the rays and cotangents, per needed
// cluster a 6 KB frame block and a 2 KB opacity block, and the gradient
// table written once. Without the stop a bounce-like ray with dist = BIG
// passes every cluster on its line: more tests than B2's.
//
// What the design does about it: B2's walk (rz_cluster.cuh), run twice
// over the same ranked candidates and gates, so both walks meet exactly
// the forward's hits (no dense R x T replay, which on a 65k-triangle mesh
// would cost tens of ms a call). Rays with a zero cotangent take no part,
// and rays whose coefficients are all zero (two zero factors on every
// channel) skip walk 2. Many rays hit the same floor or wall triangle, so
// a visit's contributions are summed in a shared-memory accumulator
// (4 x 128 floats) over the block's rays and added to the table with one
// atomicAdd per non-zero entry per block visit. The atomics make the sums'
// order, and so their last bits, vary from call to call.
//
// Built with -fmad=false (see rz_cluster.cuh).
#include "rz_cluster.cuh"

namespace {

using namespace rz;

__global__ void __launch_bounds__(THREADS)
shadow_grad_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ dist_in,
                   const float* __restrict__ g_rgb,
                   const float* __restrict__ g_a,
                   const float* __restrict__ box,
                   const float* __restrict__ frames,
                   const float* __restrict__ op_tab, int n_rays, int cp,
                   int list_rows, float* __restrict__ d_op,
                   int* __restrict__ visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = shared_layout(smem, B2_SIDE, 0, GRAD_BYTES);
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool in_range = ray < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float dist = -1.0f;
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (in_range) {
    ox = origin[3 * ray + 0];
    oy = origin[3 * ray + 1];
    oz = origin[3 * ray + 2];
    dx = direction[3 * ray + 0];
    dy = direction[3 * ray + 1];
    dz = direction[3 * ray + 2];
    dist = dist_in[ray];
    g[0] = g_rgb[3 * ray + 0];
    g[1] = g_rgb[3 * ray + 1];
    g[2] = g_rgb[3 * ray + 2];
    g[3] = g_a[ray];
  }
  // walk 1: every ray with a cotangent; walk 2: those with a coefficient
  bool walking = in_range && dist > 0.0f &&
                 (g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f || g[3] != 0.0f);
  float P[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  unsigned z[4] = {0u, 0u, 0u, 0u};
  int phase = 1;
  int n_tests = 0;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Walk w{0, 0};
  int* block_visits = visits ? visits + n_rays + blockIdx.x : nullptr;

  auto reach = [&]() { return walking ? dist : -1.0f; };
  auto need = [&](int c) {
    if (!walking) return false;
    float tmin, tmax;
    slab(box, cp, c, ox, oy, oz, ix, iy, iz, tmin, tmax);
    return (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
  };
  auto center = [&](int c, float* ctr) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ctr[a] = (box[a * cp + c] + box[(3 + a) * cp + c]) * 0.5f;
    return (int)box[7 * cp + c];
  };
  auto side = [&](int buf, int c) {
    stage_rows(sh.side + buf * B2_SIDE, op_tab + (size_t)c * B2_SIDE, B2_SIDE);
  };
  auto test = [&](const float* fr, int buf, const float* ctr, int cnt, int r) {
    const float* op = sh.side + buf * B2_SIDE;
    auto factor = [&](int j, float* f) {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = op[k * CT + j];
    };
    if (phase == 1) {
      grad_test_ray(sh, fr, ctr, cnt, r, factor);
    } else {
      scatter_test_ray(sh, fr, ctr, cnt, r, factor, [&](int j, int k, float v) {
        atomicAdd(sh.acc + k * CT + j, v);
      });
    }
  };
  auto apply = [&](int) {
    ++n_tests;
    if (phase == 1) {
      const float4 p = sh.prod[threadIdx.x];
      const u64 zc = sh.res[threadIdx.x];
      P[0] = P[0] * p.x;
      P[1] = P[1] * p.y;
      P[2] = P[2] * p.z;
      P[3] = P[3] * p.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) z[k] += zero_count(zc, k);
    }
  };
  auto after = [&](int c) {
    if (phase == 2) flush_acc(sh.acc, d_op + (size_t)c * B2_SIDE, B2_SIDE);
  };
  auto row_box = [&](int c, float* lo, float* hi) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = box[a * cp + c];
      hi[a] = box[(3 + a) * cp + c];
    }
    return box[7 * cp + c] > 0.0f;
  };
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
  store_ray(sh, o, d, dist);
  for (int i = threadIdx.x; i < GRAD_ACC; i += THREADS) sh.acc[i] = 0.0f;

  auto walk = [&]() {
    for (int w0 = 0; w0 < cp; w0 += list_rows) {
      const int n = min(list_rows, cp - w0);
      const Bounds b = block_bounds(sh, walking, o, d, 0.0f, dist);
      const int nf = rank_window(sh, sh.keys, w0, n, b, row_box);
      walk_clusters(sh, w, sh.keys, nf, walking, frames, block_visits, need,
                    reach, center, side, test, apply, after);
    }
  };
  if (__syncthreads_or(walking)) {
    walk();
    phase = 2;
    const bool coef = store_coef(sh, g, P, z);
    walking = walking && coef;
    if (__syncthreads_or(walking)) walk();  // the barrier publishes coef
  }
  if (in_range && visits) visits[ray] = n_tests;
}

}  // namespace

// d_op: float[cp][4][CT], zeroed by the caller, receives the gradient;
// visits: null on the training path; else int[n_rays + blocks] that
// receives each ray's cluster tests (both walks) and each block's staged
// clusters.
extern "C" int rz_cluster_shadow_grad(const float* origin,
                                      const float* direction,
                                      const float* dist, const float* g_rgb,
                                      const float* g_a, const float* box_tab,
                                      const float* frames, const float* op_tab,
                                      int n_rays, int cp, float* d_op,
                                      int* visits, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const int list_rows = rank_rows_for(cp);
  const size_t smem = kernel_smem(B2_GRAD, cp);
  cudaError_t err = allow_smem(shadow_grad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  shadow_grad_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, dist, g_rgb, g_a, box_tab, frames, op_tab, n_rays, cp,
      list_rows, d_op, visits);
  return (int)cudaGetLastError();
}
