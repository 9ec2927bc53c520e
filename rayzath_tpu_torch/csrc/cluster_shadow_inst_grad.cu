// B4-grad: the backward of the two-level shadow product (B4), as two
// ranked front-to-back walks at both levels per block of 128 rays with no
// alpha stop.
//
// Replaces the backward rule of the JAX package's custom_vjp around
// `_shadow_kernel_inst` (rayzath_tpu/ops/traverse_cluster.py
// `_make_cluster_shadow_inst` bwd, lines 1957-1983): there a dense replay
// of every ray against the expanded (instance, triangle) set, each
// triangle moved to world space (`project_shadow`, compiled by XLA), not a
// Pallas kernel. What it computes is that rule's result for the instance
// slot table of `instance_opacity`: with cotangents (g_rgb [R,3],
// g_a [R]), d_op_tab [I][4][SLOTS] where entry (gid, k, q) gets, for
// every ray r and every hit with t in (0, dist_r) of a triangle whose slot
// is q under instance gid, g[r,k] times the product of the ray's other
// factors on channel k, over every hit (no stop). Autograd through
// `instance_opacity` (plain torch) carries it on to the material table.
// The rays, dist and the triangles get no gradient.
//
// The product of the others as in B2-grad (cluster_shadow_grad.cu): walk 1
// keeps per ray and channel the product P of the non-zero factors and the
// count z of zero factors; walk 2 gives a hit of factor f the share
// g P / f when f != 0 and z == 0, g P when f == 0 and z == 1, else
// nothing.
//
// What bounds it on the H100: B4's work twice without the stop, per ray
// the (instance, cluster) pairs whose slab intervals meet (0, dist), each
// 128 ray-triangle tests of 49 f32 operations, plus 33 operations per
// needed instance for `to_object`, plus a division and an add per hit and
// channel; the bytes are the rays and cotangents, per needed cluster a
// 6 KB frame block and a 512 B slot row, per needed instance a 1 KB
// opacity row, and the gradient table written once. A dense replay over
// instanced_field's 317,954 expanded triangles would take minutes a call.
//
// What the design does about it: B4's walk at both levels
// (rz_cluster.cuh), run twice over the same gates, so both walks meet the
// forward's hits. Rays with a zero cotangent take no part, rays whose
// coefficients are all zero skip walk 2. The table is per instance slot,
// and many rays of a block hit the same slots of the same instance, so a
// visited instance's contributions are summed in a shared-memory
// accumulator (4 x 64 floats, shared-memory atomics: two lanes may hit
// triangles of one slot) over its whole mesh walk and the block's rays,
// then added to the table with one atomicAdd per non-zero entry. The
// atomics make the sums' order, and so their last bits, vary from call to
// call.
//
// Built with -fmad=false (see rz_cluster.cuh).
#include "rz_cluster.cuh"

namespace {

using namespace rz;

__global__ void __launch_bounds__(THREADS)
shadow_inst_grad_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ dist_in,
                        const float* __restrict__ g_rgb,
                        const float* __restrict__ g_a,
                        const float* __restrict__ ti_rows,
                        const float* __restrict__ cl_obox,
                        const float* __restrict__ frames,
                        const float* __restrict__ cl_slot,
                        const float* __restrict__ op_tab, int n_rays, int ip,
                        int list_i, int list_c, float* __restrict__ d_op,
                        int* __restrict__ visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = shared_layout(smem, B4_SIDE, OP_ROW, GRAD_BYTES);
  u64* keys_i = sh.keys;
  u64* keys_c = sh.keys + list_i;
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
  auto gate = [&](float tmin, float tmax) {
    return (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
  };
  auto ineed = [&](int k) {
    if (!walking) return false;
    const float* row = ti_rows + (size_t)k * TI_W;
    float tmin, tmax;
    slab_wide(row + TI_MIN, row + TI_MAX, ox, oy, oz, ix, iy, iz, tmin,
              tmax);
    return gate(tmin, tmax);
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
  auto center = [&](int s, float* ctr) {
    const float* cb = cl_obox + (size_t)s * OBOX_W;
#pragma unroll
    for (int a = 0; a < 3; ++a) ctr[a] = (cb[a] + cb[3 + a]) * 0.5f;
    return (int)cb[7];
  };
  auto side = [&](int buf, int s) {
    stage_rows(sh.side + buf * B4_SIDE, cl_slot + (size_t)s * CT, B4_SIDE);
  };
  auto test = [&](const float* fr, int buf, const float* ctr, int cnt, int r) {
    const float* sl = sh.side + buf * B4_SIDE;
    const float* op = sh.op_row;
    auto factor = [&](int j, float* f) {
      const int q = (int)sl[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = op[k * SLOTS + q];
    };
    if (phase == 1) {
      grad_test_ray(sh, fr, ctr, cnt, r, factor);
    } else {
      scatter_test_ray(sh, fr, ctr, cnt, r, factor, [&](int j, int k, float v) {
        atomicAdd(sh.acc + k * SLOTS + (int)sl[j], v);
      });
    }
  };
  auto cluster_box = [&](int s, float* lo, float* hi) {
    const float* cb = cl_obox + (size_t)s * OBOX_W;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = cb[a];
      hi[a] = cb[3 + a];
    }
    return true;
  };

  // One instance visit, block-uniform, as in B4: the walking rays that
  // need instance row k walk its mesh's clusters in object space; in walk
  // 2 the instance's accumulated gradient then goes to its table row.
  auto visit_inst = [&](int k) {
    const float* row = ti_rows + (size_t)k * TI_W;
    const bool in_k = ineed(k);
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
    if (in_k) to_object(row + TI_INV, ox, oy, oz, dx, dy, dz, o, d);
    const float ixl = safe_inv(d[0]), iyl = safe_inv(d[1]),
                izl = safe_inv(d[2]);
    const int cl0 = (int)row[TI_CL0];
    const int ncl = (int)row[TI_NCL];
    const int gid = (int)row[TI_ID];
    // the instance's opacity row, its own commit group (see B4)
    __pipeline_wait_prior(0);
    stage_rows(sh.op_row, op_tab + (size_t)gid * OP_ROW, OP_ROW);
    __pipeline_commit();
    auto cneed = [&](int s) {
      if (!walking) return false;
      const float* cb = cl_obox + (size_t)s * OBOX_W;
      float tmin, tmax;
      slab_wide(cb, cb + 3, o[0], o[1], o[2], ixl, iyl, izl, tmin, tmax);
      return gate(tmin, tmax);
    };
    store_ray(sh, o, d, dist);  // read after the window's first barrier
    for (int s0 = 0; s0 < ncl; s0 += list_c) {
      const int n = min(list_c, ncl - s0);
      int nf;
      if (ncl <= SWEEP_MAX) {
        nf = sweep_window(keys_c, cl0 + s0, n);
      } else {
        const Bounds b = block_bounds(sh, in_k && walking, o, d, 0.0f, dist);
        nf = rank_window(sh, keys_c, cl0 + s0, n, b, cluster_box);
      }
      walk_clusters(sh, w, keys_c, nf, in_k, frames, block_visits, cneed,
                    reach, center, side, test, apply);
    }
    // the last visit's tests ended at a barrier; the next instance's start
    // after their own
    if (phase == 2) flush_acc(sh.acc, d_op + (size_t)gid * OP_ROW, OP_ROW);
  };

  auto instance_box = [&](int k, float* lo, float* hi) {
    const float* row = ti_rows + (size_t)k * TI_W;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = row[TI_MIN + a];
      hi[a] = row[TI_MAX + a];
    }
    return row[TI_NCL] > 0.0f;
  };
  const float wo[3] = {ox, oy, oz}, wd[3] = {dx, dy, dz};
  for (int i = threadIdx.x; i < GRAD_ACC; i += THREADS) sh.acc[i] = 0.0f;

  auto walk = [&]() {
    for (int k0 = 0; k0 < ip; k0 += list_i) {
      const int n = min(list_i, ip - k0);
      const Bounds b = block_bounds(sh, walking, wo, wd, 0.0f, dist);
      const int nf = rank_window(sh, keys_i, k0, n, b, instance_box);
      walk_rows(sh, w, keys_i, nf, walking, ineed, reach, visit_inst);
    }
    __pipeline_wait_prior(0);  // the last opacity row, if no cluster took it
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

// d_op: float[I][4][SLOTS], zeroed by the caller, receives the gradient;
// visits: null on the training path; else int[n_rays + blocks] that
// receives each ray's (instance, cluster) tests (both walks) and each
// block's staged clusters.
extern "C" int rz_cluster_shadow_inst_grad(
    const float* origin, const float* direction, const float* dist,
    const float* g_rgb, const float* g_a, const float* ti_rows,
    const float* cl_obox, const float* frames, const float* cl_slot,
    const float* op_tab, int n_rays, int ip, float* d_op, int* visits,
    void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const int list_i = rank_rows_for(ip);
  const int list_c = CL_WINDOW;
  const size_t smem = kernel_smem(B4_GRAD, ip);
  cudaError_t err = allow_smem(shadow_inst_grad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  shadow_inst_grad_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, dist, g_rgb, g_a, ti_rows, cl_obox, frames, cl_slot,
      op_tab, n_rays, ip, list_i, list_c, d_op, visits);
  return (int)cudaGetLastError();
}
