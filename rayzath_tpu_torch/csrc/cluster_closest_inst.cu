// B3: closest-hit traversal of the instanced (two-level) cluster tables,
// ranked front to back at both levels, the instances per block of 128 rays
// and the walk per warp of 32 (one ray's walk state per thread).
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_closest_kernel_inst` (launched by `_cluster_closest_inst_impl`, entry
// point `cluster_closest_inst`). What it computes is the same: per ray, the
// nearest triangle with t in (near, min(far, BIG)) over every instance,
// where a triangle of instance k is tested in k's object space (the ray
// moved by the world->object rows of ti_rows, direction unnormalized so t
// stays the world t) against the shared clusters of k's mesh. It returns
// t, the triangle id in device order (cl_obox column 6 + slot, the order
// of tri_pack: no further mapping) and the global instance index (ti_rows
// column 20, not the row). Left out, as TPU workarounds: the bf16-rounded
// rank distances and their MXU scatter, the ranked/direct split at
// MINI_RANK_MIN, bf16 limbs, SMEM/VMEM staging and HBM streaming.
//
// What bounds it on the H100: as B1, the needed work is per ray the
// (instance, cluster) pairs whose slab intervals meet [near, t_final], each
// 128 ray-triangle tests of 49 f32 operations, plus 33 operations per
// needed instance to move the ray into object space (`to_object`); the
// bytes are the rays and hits, the instance rows and one 6 KB frame block
// per needed cluster (instanced_field's shared mesh has 24 clusters). On
// instanced_field's 262,144 bounce-like rays that is ~1.15 cluster tests
// per ray, 0.018 ms of operations at the 67 TFLOP/s f32 peak; with
// -fmad=false the ALU reaches at most half of it. The first port walked
// every instance row in table order with a barrier per row and per
// cluster, and tested each ray on its own thread.
//
// What the design does about it, per block of 128 coherence-ordered rays
// (rz_cluster.cuh, the warp walk):
// - The block ranks the instance rows by the interval bound of its world
//   rays against their world AABBs and sorts them by (bound, row); tables
//   larger than RANK_MAX rows are ranked in consecutive windows.
// - Each warp then walks that list for its own 32 rays, a candidate at a
//   time under its own stop vote, with no block barrier: a block-uniform
//   walk's instance visits served about 16 of its 128 rays on
//   instanced_field's bounce rays, yet each cost all of them the
//   transform, a block rank and vote, and each cluster visit two barriers.
// - In a visited instance, the warp's rays that need it move into object
//   space (`to_object`). A mesh of more than SWEEP_MAX (8) clusters has its
//   clusters ranked per warp, BATCH (32) at a time, by the bounds of the
//   warp's object-space rays (instanced_field's sphere has 24); a smaller
//   mesh is swept in table order, as the TPU reference does at max_ncl <=
//   8. Each needing ray of a visited cluster is tested by the whole warp,
//   one triangle slot per lane, the frames read through L1.
// Ties resolve as the plain version's table order, whatever the walk's
// order: a hit replaces the best when it is nearer, or equally near with a
// smaller (instance row, cluster row, slot). Both gates are widened
// (GATE_PAD on the boxes, gate_t on best_t), so they can only add visits.
// As in B1, a ray of near < 0 makes its block's instance list and its
// warp's cluster lists table order, walked without the stop.
//
// Built with -fmad=false (see rz_cluster.cuh): the object transform and
// the projection round like the plain PyTorch version.
#include "rz_cluster.cuh"

namespace {

using namespace rz;

__global__ void __launch_bounds__(THREADS)
closest_inst_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ near_in,
                    const float* __restrict__ far_in,
                    const float* __restrict__ ti_rows,
                    const float* __restrict__ cl_obox,
                    const float* __restrict__ frames, int n_rays, int ip,
                    int list_i, float* __restrict__ t_out,
                    int* __restrict__ id_out, int* __restrict__ inst_out,
                    int* __restrict__ visits,
                    unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = warp_layout(smem);
  u64* keys_i = sh.keys;
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool in_range = ray < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float near = 0.0f, far = -1.0f;
  if (in_range) {
    ox = origin[3 * ray + 0];
    oy = origin[3 * ray + 1];
    oz = origin[3 * ray + 2];
    dx = direction[3 * ray + 0];
    dy = direction[3 * ray + 1];
    dz = direction[3 * ray + 2];
    near = near_in[ray];
    far = far_in[ray];
  }
  const bool active = in_range && far > 0.0f;
  float best_t = active ? fminf(far, BIG) : -1.0f;
  u64 best_key = 0;  // (instance row, cluster row, slot); 0 also for none
  int best_id = -1;
  int best_inst = -1;
  int n_tests = 0;
  int n_inst = 0;  // instances this ray moved into (to_object calls)
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int* block_visits = visits ? visits + n_rays + blockIdx.x : nullptr;

  auto cur_best = [&]() { return best_t; };
  auto ineed = [&](int k) {
    const float* row = ti_rows + (size_t)k * TI_W;
    float tmin, tmax;
    slab_wide(row + TI_MIN, row + TI_MAX, ox, oy, oz, ix, iy, iz, tmin,
              tmax);
    return (tmax >= near) && (tmin <= tmax) && (tmin <= gate_t(best_t));
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
  // A test's result, the (t, slot) key hit of cluster s of instance row k
  // (global index gid), taken by the ray's own thread.
  auto take = [&](int k, int s, int gid, u64 hit) {
    ++n_tests;
    if (hit == NO_CAND) return;
    const float t = ord_float((unsigned)(hit >> 32));
    const int j = (int)(unsigned)hit;
    const u64 key = ((u64)k << 32) | ((unsigned)s * CT + j);
    if (t < best_t || (t == best_t && key < best_key)) {
      best_t = t;
      best_key = key;
      best_id = (int)cl_obox[(size_t)s * OBOX_W + 6] + j;
      best_inst = gid;
    }
  };
  // The gate of cluster s for this thread's object-space ray (origin o,
  // inverse direction il).
  auto cgate = [&](int s, const float* o, const float* il) {
    const float* cb = cl_obox + (size_t)s * OBOX_W;
    float tmin, tmax;
    slab_wide(cb, cb + 3, o[0], o[1], o[2], il[0], il[1], il[2], tmin, tmax);
    return (tmax >= near) && (tmin <= tmax) && (tmin <= gate_t(best_t));
  };
  // The object-space ray of this thread in instance row k (when in_k).
  auto enter = [&](int k, bool in_k, float* o, float* d) {
    if (in_k) {
      to_object(ti_rows + (size_t)k * TI_W + TI_INV, ox, oy, oz, dx, dy, dz,
                o, d);
      ++n_inst;
    }
  };

  // One instance visit, warp-uniform: the lanes of mask need instance row k
  // and walk its mesh's clusters in object space; each cluster is tested
  // for each lane of its mask by the whole warp.
  auto visit_inst = [&](int k, unsigned mask) {
    const float* row = ti_rows + (size_t)k * TI_W;
    const int lane = threadIdx.x & 31;
    const bool in_k = (mask >> lane) & 1u;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
    enter(k, in_k, o, d);
    const float il[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    const int gid = (int)row[TI_ID];
    auto cneed = [&](int s) { return cgate(s, o, il); };
    auto visit_cluster = [&](int s, unsigned m) {
      float ctr[3];
      const int cnt = center(s, ctr);
      const float* fr = frames + (size_t)s * FRAME_FLOATS;
      if (block_visits != nullptr && lane == 0) atomicAdd(block_visits, 1);
      while (m) {
        const int r = __ffs(m) - 1;
        m &= m - 1;
        float p[3], dr[3];
        const float nr = warp_ray(o, d, near, ctr, r, p, dr);
        const u64 hit = closest_slots(fr, cnt, p, dr, nr);
        if (lane == r) take(k, s, gid, hit);
      }
    };
    warp_walk_mesh((int)row[TI_CL0], (int)row[TI_NCL], in_k,
                   [&] { return warp_bounds(in_k, o, d, near, best_t); },
                   cluster_box, cneed, cur_best, visit_cluster);
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
      const Bounds b = block_bounds(sh, active, wo, wd, near, best_t);
      const int nf = rank_window(sh, keys_i, k0, n, b, instance_box);
      warp_walk([&](int i) { return keys_i[i]; }, nf, active, ineed,
                cur_best, visit_inst);
    }
  }
  if (in_range) {
    t_out[ray] = best_t;
    id_out[ray] = best_id;
    inst_out[ray] = best_inst;
    if (visits) visits[ray] = n_tests;
  }
  if (work) add_walk_counts(sh, work, n_inst, n_tests);
}

}  // namespace

// visits: null on the render path; else int[n_rays + blocks] that receives
// each ray's (instance, cluster) tests and each block's cluster visits (its
// warps' visits summed). work: null, or int64[2] that the launch adds its
// instance visits and its (instance, cluster) tests to (add_walk_counts);
// the render path's counters, which a captured graph advances on every
// replay.
extern "C" int rz_cluster_closest_inst(const float* origin,
                                       const float* direction,
                                       const float* near, const float* far,
                                       const float* ti_rows,
                                       const float* cl_obox,
                                       const float* frames, int n_rays,
                                       int ip, float* t_out, int* id_out,
                                       int* inst_out, int* visits,
                                       unsigned long long* work,
                                       void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const int list_i = rank_rows_for(ip);
  const size_t smem = kernel_smem(3, ip);
  cudaError_t err = allow_smem(closest_inst_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  closest_inst_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, near, far, ti_rows, cl_obox, frames, n_rays, ip,
      list_i, t_out, id_out, inst_out, visits, work);
  return (int)cudaGetLastError();
}

// Resources of a launch over ip instance rows (walk_resources: registers,
// dynamic shared bytes, blocks per SM, spilled bytes).
extern "C" int rz_closest_inst_resources(int ip, int* out) {
  const size_t smem = kernel_smem(3, ip);
  const cudaError_t err = allow_smem(closest_inst_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return walk_resources(closest_inst_kernel, smem, out);
}
