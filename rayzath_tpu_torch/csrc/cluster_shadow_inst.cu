// B4: transmission-filtered shadow traversal of the instanced (two-level)
// cluster tables, ranked front to back per block of 128 rays at both levels
// (one ray's product per thread).
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_shadow_kernel_inst` (launched by `_cluster_shadow_inst_impl`, entry
// point `cluster_shadow_inst`). What it computes is the same: per ray, the
// product of the rgba opacity over every triangle hit with t in (0, dist),
// over every instance, each triangle tested in its instance's object space
// as in B3. The opacity of slot j of cluster s under instance k is
// op_tab[gid][c][cl_slot[s][j]], op_tab being rebuilt from the live
// materials by the wrapper (`instance_opacity`). A ray is blocked, and
// visits no more instances or clusters, once its alpha is below ALPHA_STOP
// (1e-4), as in B2. Left out, as TPU workarounds: the bf16-rounded rank
// distances, the ranked/direct split, the one-hot matrix resolve of the
// slot opacity, bf16 limbs, HBM streaming and `_clamp_c` (the JAX ranked
// loops never reach their last candidate; this walk takes every row). The
// gradient replay of the JAX custom_vjp is not part of this forward kernel.
//
// What bounds it on the H100: as B3, per ray the (instance, cluster) pairs
// whose slab intervals meet (0, dist) up to the first opaque hit, each 128
// ray-triangle tests of 49 f32 operations, plus 33 operations per needed
// instance for `to_object`; the bytes are the rays and products, the
// instance rows, and per needed cluster a 6 KB frame block and a 512 B slot
// row, per needed instance a 1 KB opacity row. On instanced_field's 262,144
// bounce-like rays with dist = BIG that is ~1.15 cluster tests per ray:
// 0.018 ms of operations at the 67 TFLOP/s f32 peak; with -fmad=false the
// ALU reaches at most half of it. The first port walked every instance row
// and every cluster of a visited mesh in table order with a barrier per
// row, tested each ray on its own thread and copied synchronously.
//
// What the design does about it, per block of 128 coherence-ordered rays:
// B3's walk at both levels (rz_cluster.cuh), with B2's product.
// - Rank the instance rows by the interval bound of the block's live world
//   rays against their widened world AABBs, capped at the largest live
//   dist, and walk them in rank order, 32 per block vote; a blocked ray
//   votes no more, and the block stops when no live ray can reach the next
//   candidate.
// - In a visited instance, each live ray that needs it moves into object
//   space once (`to_object`) and publishes itself for the cooperative
//   tests; the instance's 4x64 opacity row is copied with cp.async into a
//   buffer of its own, published by the barrier of the mesh's first
//   cluster visit and left alone until the mesh walk ends. A mesh of more
//   than SWEEP_MAX (8) clusters has its clusters ranked by the bounds of
//   the object-space rays (instanced_field's sphere has 24); a smaller mesh
//   is swept in table order (faster on <= 8 clusters, PERF.md).
// - Each needing ray of a visited cluster is tested by a whole warp, a slot
//   per lane, each hit's factor resolved through the staged slot row and
//   the instance's opacity row, and the lanes' products multiplied by
//   shuffles; the ray's own thread folds it into its product.
// - The next marked cluster's frames and slot row stream into the other
//   shared buffers as one cp.async group while the current one is tested.
// - Instance tables larger than RANK_MAX rows, and meshes of more than
//   CL_WINDOW (512) clusters, are ranked and walked in consecutive windows.
// Both gates stay widened (GATE_PAD on the boxes) with tmin <= dist and
// tmax >= 0, so they can only add visits.
//
// Built with -fmad=false (see rz_cluster.cuh): the object transform and
// the projection round like the plain PyTorch version.
#include "rz_cluster.cuh"

namespace {

using namespace rz;

__global__ void __launch_bounds__(THREADS)
shadow_inst_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ dist_in,
                   const float* __restrict__ ti_rows,
                   const float* __restrict__ cl_obox,
                   const float* __restrict__ frames,
                   const float* __restrict__ cl_slot,
                   const float* __restrict__ op_tab, int n_rays, int ip,
                   int list_i, int list_c, float* __restrict__ rgb_out,
                   float* __restrict__ a_out, int* __restrict__ visits,
                   unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = shared_layout(smem, B4_SIDE, OP_ROW);
  u64* keys_i = sh.keys;
  u64* keys_c = sh.keys + list_i;
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool in_range = ray < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float dist = -1.0f;
  if (in_range) {
    ox = origin[3 * ray + 0];
    oy = origin[3 * ray + 1];
    oz = origin[3 * ray + 2];
    dx = direction[3 * ray + 0];
    dy = direction[3 * ray + 1];
    dz = direction[3 * ray + 2];
    dist = dist_in[ray];
  }
  const bool active = in_range && dist > 0.0f;
  float mr = 1.0f, mg = 1.0f, mb = 1.0f, ma = 1.0f;
  int n_tests = 0;
  int n_inst = 0;  // instances this ray moved into (to_object calls)
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Walk w{0, 0};
  int* block_visits = visits ? visits + n_rays + blockIdx.x : nullptr;

  auto live = [&]() { return active && ma >= ALPHA_STOP; };
  auto reach = [&]() { return live() ? dist : -1.0f; };
  auto gate = [&](float tmin, float tmax) {
    return (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
  };
  auto ineed = [&](int k) {
    if (!live()) return false;
    const float* row = ti_rows + (size_t)k * TI_W;
    float tmin, tmax;
    slab_wide(row + TI_MIN, row + TI_MAX, ox, oy, oz, ix, iy, iz, tmin,
              tmax);
    return gate(tmin, tmax);
  };
  auto apply = [&](int) {
    ++n_tests;
    const float4 p = sh.prod[threadIdx.x];
    mr = mr * p.x;
    mg = mg * p.y;
    mb = mb * p.z;
    ma = ma * p.w;
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
    shadow_test_ray(sh, fr, ctr, cnt, r, [&](int j, float* f) {
      const int q = (int)sl[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = op[k * SLOTS + q];
    });
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

  // One instance visit, block-uniform: the live rays that need instance row
  // k walk its mesh's clusters in object space.
  auto visit_inst = [&](int k) {
    const float* row = ti_rows + (size_t)k * TI_W;
    const bool in_k = ineed(k);
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
    if (in_k) {
      to_object(row + TI_INV, ox, oy, oz, dx, dy, dz, o, d);
      ++n_inst;
    }
    const float ixl = safe_inv(d[0]), iyl = safe_inv(d[1]),
                izl = safe_inv(d[2]);
    const int cl0 = (int)row[TI_CL0];
    const int ncl = (int)row[TI_NCL];
    const int gid = (int)row[TI_ID];
    // The instance's opacity row, its own commit group, waited for with the
    // first cluster's rows. An earlier instance's copy may still be in
    // flight when that mesh had no cluster visit: wait for it first. No
    // thread reads the buffer here: the last test of the previous mesh
    // ended at a barrier.
    __pipeline_wait_prior(0);
    stage_rows(sh.op_row, op_tab + (size_t)gid * OP_ROW, OP_ROW);
    __pipeline_commit();
    auto cneed = [&](int s) {
      if (!live()) return false;
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
        const Bounds b = block_bounds(sh, in_k && live(), o, d, 0.0f, dist);
        nf = rank_window(sh, keys_c, cl0 + s0, n, b, cluster_box);
      }
      walk_clusters(sh, w, keys_c, nf, in_k, frames, block_visits, cneed,
                    reach, center, side, test, apply);
    }
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
  if (__syncthreads_or(active)) {
    for (int k0 = 0; k0 < ip; k0 += list_i) {
      const int n = min(list_i, ip - k0);
      const Bounds b = block_bounds(sh, live(), wo, wd, 0.0f, dist);
      const int nf = rank_window(sh, keys_i, k0, n, b, instance_box);
      walk_rows(sh, w, keys_i, nf, active, ineed, reach, visit_inst);
    }
    __pipeline_wait_prior(0);  // the last opacity row, if no cluster took it
  }
  if (in_range) {
    rgb_out[3 * ray + 0] = mr;
    rgb_out[3 * ray + 1] = mg;
    rgb_out[3 * ray + 2] = mb;
    a_out[ray] = ma;
    if (visits) visits[ray] = n_tests;
  }
  if (work) add_walk_counts(sh, work, n_inst, n_tests);
}

}  // namespace

// visits: null on the render path; else int[n_rays + blocks] that receives
// each ray's (instance, cluster) tests and each block's staged clusters.
// work: null, or int64[2] that the launch adds its instance visits and its
// (instance, cluster) tests to, as B3's.
extern "C" int rz_cluster_shadow_inst(const float* origin,
                                      const float* direction,
                                      const float* dist, const float* ti_rows,
                                      const float* cl_obox,
                                      const float* frames,
                                      const float* cl_slot,
                                      const float* op_tab, int n_rays, int ip,
                                      float* rgb_out, float* a_out,
                                      int* visits,
                                      unsigned long long* work,
                                      void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const int list_i = rank_rows_for(ip);
  const int list_c = CL_WINDOW;
  const size_t smem = kernel_smem(4, ip);
  cudaError_t err = allow_smem(shadow_inst_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  shadow_inst_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, dist, ti_rows, cl_obox, frames, cl_slot, op_tab,
      n_rays, ip, list_i, list_c, rgb_out, a_out, visits, work);
  return (int)cudaGetLastError();
}
