// B4: transmission-filtered shadow traversal of the instanced (two-level)
// cluster tables, ranked front to back at both levels, the instances per
// block of 128 rays and the walk per warp of 32 (one ray's product per
// thread).
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
// B3's walk at both levels (rz_cluster.cuh, the warp walk), with B2's
// product.
// - The block ranks the instance rows by the interval bound of its live
//   world rays against their widened world AABBs, capped at the largest
//   live dist; tables larger than RANK_MAX rows are ranked in consecutive
//   windows. Each warp walks that list for its own 32 rays, a candidate at
//   a time; a blocked ray votes no more, and the warp stops when no live
//   ray of it can reach the next candidate.
// - In a visited instance, the warp's live rays that need it move into
//   object space (`to_object`). A mesh of more than SWEEP_MAX (8) clusters
//   has its clusters ranked per warp, BATCH (32) at a time, by the bounds
//   of the warp's object-space rays (instanced_field's sphere has 24); a
//   smaller mesh is swept in table order.
// - Each needing ray of a visited cluster is tested by the whole warp, a
//   slot per lane, each hit's factor resolved through the cluster's slot
//   row and the instance's 4x64 opacity row (both read through L1), and
//   the lanes' products multiplied by shuffles; the ray's own thread folds
//   it into its product, in its own walk order.
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
                   int list_i, float* __restrict__ rgb_out,
                   float* __restrict__ a_out, int* __restrict__ visits,
                   unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = warp_layout(smem);
  u64* keys_i = sh.keys;
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
  // A test's result, the ray's rgba product over one cluster, folded in
  // by the ray's own thread.
  auto take = [&](float pr, float pg, float pb, float pa) {
    ++n_tests;
    mr = mr * pr;
    mg = mg * pg;
    mb = mb * pb;
    ma = ma * pa;
  };
  auto center = [&](int s, float* ctr) {
    const float* cb = cl_obox + (size_t)s * OBOX_W;
#pragma unroll
    for (int a = 0; a < 3; ++a) ctr[a] = (cb[a] + cb[3 + a]) * 0.5f;
    return (int)cb[7];
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

  // The gate of cluster s for this thread's object-space ray (origin o,
  // inverse direction il).
  auto cgate = [&](int s, const float* o, const float* il) {
    if (!live()) return false;
    const float* cb = cl_obox + (size_t)s * OBOX_W;
    float tmin, tmax;
    slab_wide(cb, cb + 3, o[0], o[1], o[2], il[0], il[1], il[2], tmin, tmax);
    return gate(tmin, tmax);
  };
  // The object-space ray of this thread in instance row k (when in_k).
  auto enter = [&](int k, bool in_k, float* o, float* d) {
    if (in_k) {
      to_object(ti_rows + (size_t)k * TI_W + TI_INV, ox, oy, oz, dx, dy, dz,
                o, d);
      ++n_inst;
    }
  };

  // One instance visit, warp-uniform: the lanes of mask are live rays that
  // need instance row k and walk its mesh's clusters in object space; each
  // cluster is tested for each live lane of its mask by the whole warp, a
  // hit's factor read through the cluster's slot row and the instance's
  // opacity row in global memory.
  auto visit_inst = [&](int k, unsigned mask) {
    const float* row = ti_rows + (size_t)k * TI_W;
    const int lane = threadIdx.x & 31;
    const bool in_k = (mask >> lane) & 1u;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
    enter(k, in_k, o, d);
    const float il[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    const float* op = op_tab + (size_t)row[TI_ID] * OP_ROW;
    auto cneed = [&](int s) { return cgate(s, o, il); };
    auto visit_cluster = [&](int s, unsigned m) {
      float ctr[3];
      const int cnt = center(s, ctr);
      const float* fr = frames + (size_t)s * FRAME_FLOATS;
      const float* sl = cl_slot + (size_t)s * CT;
      if (block_visits != nullptr && lane == 0) atomicAdd(block_visits, 1);
      while (m) {
        const int r = __ffs(m) - 1;
        m &= m - 1;
        float p[3], dr[3], f[4];
        const float dist_r = warp_ray(o, d, dist, ctr, r, p, dr);
        shadow_slots(fr, cnt, p, dr, dist_r,
                     [&](int j, float, float, float* fj) {
          const int q = (int)sl[j];
#pragma unroll
          for (int c = 0; c < 4; ++c) fj[c] = op[c * SLOTS + q];
        }, f);
        if (lane == r) take(f[0], f[1], f[2], f[3]);
      }
    };
    warp_walk_mesh((int)row[TI_CL0], (int)row[TI_NCL], in_k,
                   [&] { return warp_bounds(in_k && live(), o, d, 0.0f, dist); },
                   cluster_box, cneed, reach, visit_cluster);
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
      warp_walk([&](int i) { return keys_i[i]; }, nf, active, ineed, reach,
                visit_inst);
    }
  }
  if (in_range) {
    rgb_out[3 * ray + 0] = mr;
    rgb_out[3 * ray + 1] = mg;
    rgb_out[3 * ray + 2] = mb;
    a_out[ray] = ma;
    if (visits) visits[ray] = n_tests;
  }
  if (work) add_walk_counts(sh, work, n_inst, n_tests, (int)active);
}

}  // namespace

// visits: null on the render path; else int[n_rays + blocks] that receives
// each ray's (instance, cluster) tests and each block's cluster visits, as
// B3's. work: null, or int64[3] that the launch adds its instance visits,
// its (instance, cluster) tests and its live rays (dist > 0) to.
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
  const size_t smem = kernel_smem(4, ip);
  cudaError_t err = allow_smem(shadow_inst_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  shadow_inst_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, dist, ti_rows, cl_obox, frames, cl_slot, op_tab,
      n_rays, ip, list_i, rgb_out, a_out, visits, work);
  return (int)cudaGetLastError();
}

// Resources of a launch over ip instance rows, as rz_closest_inst_resources.
extern "C" int rz_shadow_inst_resources(int ip, int* out) {
  const size_t smem = kernel_smem(4, ip);
  const cudaError_t err = allow_smem(shadow_inst_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return walk_resources(shadow_inst_kernel, smem, out);
}
