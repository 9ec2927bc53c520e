// B3: closest-hit traversal of the instanced (two-level) cluster tables, one
// thread per ray.
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
// column 20, not the row). Ties: the lowest slot inside a cluster; a later
// cluster or instance must be strictly nearer. Left out, as TPU
// workarounds: the instance and cluster rank passes, the ranked/direct
// split at MINI_RANK_MIN, bf16 limbs, SMEM/VMEM staging and HBM streaming.
//
// What bounds it on the H100: as B1, each visited (instance, cluster) pair
// costs one 6 KB frame block read from L2 (instanced_field's shared mesh
// has 24 clusters, 147 KB of frames for all 145 instances) against 128
// ray-triangle tests of ~40 f32 operations per ray that needs the cluster,
// plus 18 operations per ray to enter an instance. A ray meets up to
// |instances| x |clusters per mesh| pairs, so the walk is bound by issue
// rate, divergence and the per-visit barriers, not by memory.
//
// What the design does about it: 128 rays per block walk the instance
// rows in table order. Each thread slab-tests its ray against the
// instance's world AABB with its current window (near, best_t), and
// `__syncthreads_or` skips an instance that no ray of the block needs. A
// visiting thread moves its ray into object space once, then the block
// walks the mesh's clusters with the same gate against the object-space
// boxes; frames are staged in shared memory once per visited cluster and
// the triangles are tested from the cluster-local origin, exactly as B1.
// Both gates are widened (rz_cluster.cuh GATE_PAD), so they can only add
// visits. Rays arrive coherence-sorted or in image tiles. One code path
// serves every cluster count per mesh.
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
                    float* __restrict__ t_out, int* __restrict__ id_out,
                    int* __restrict__ inst_out) {
  __shared__ float fr[FRAME_FLOATS];
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
  int best_id = -1;
  int best_inst = -1;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  for (int k = 0; k < ip; ++k) {
    const float* row = ti_rows + (size_t)k * TI_W;
    const int ncl = (int)row[TI_NCL];
    if (ncl <= 0) continue;  // padding row: the same for every thread
    bool need = false;
    if (active) {
      float tmin, tmax;
      slab_wide(row + TI_MIN, row + TI_MAX, ox, oy, oz, ix, iy, iz, tmin,
                tmax);
      need = (tmax >= near) && (tmin <= tmax) && (tmin <= best_t);
    }
    if (!__syncthreads_or(need)) continue;
    float o[3], d[3];
    to_object(row + TI_INV, ox, oy, oz, dx, dy, dz, o, d);
    const float ixl = safe_inv(d[0]), iyl = safe_inv(d[1]),
                izl = safe_inv(d[2]);
    const int cl0 = (int)row[TI_CL0];
    const int gid = (int)row[TI_ID];
    for (int s = cl0; s < cl0 + ncl; ++s) {
      const float* cb = cl_obox + (size_t)s * OBOX_W;
      bool cneed = false;
      if (need) {
        float tmin, tmax;
        slab_wide(cb, cb + 3, o[0], o[1], o[2], ixl, iyl, izl, tmin, tmax);
        cneed = (tmax >= near) && (tmin <= tmax) && (tmin <= best_t);
      }
      // also the barrier that retires the previous cluster's shared frames
      if (!__syncthreads_or(cneed)) continue;
      const float* src = frames + (size_t)s * FRAME_FLOATS;
      for (int q = threadIdx.x; q < FRAME_FLOATS; q += THREADS) fr[q] = src[q];
      __syncthreads();
      if (cneed) {
        const float px = o[0] - (cb[0] + cb[3]) * 0.5f;
        const float py = o[1] - (cb[1] + cb[4]) * 0.5f;
        const float pz = o[2] - (cb[2] + cb[5]) * 0.5f;
        const int base = (int)cb[6];
        const int n = (int)cb[7];
        for (int j = 0; j < n; ++j) {
          bool inside;
          const float t = project(fr, j, px, py, pz, d[0], d[1], d[2], inside);
          if (inside && t > near && t < best_t) {
            best_t = t;
            best_id = base + j;
            best_inst = gid;
          }
        }
      }
    }
  }
  if (in_range) {
    t_out[ray] = best_t;
    id_out[ray] = best_id;
    inst_out[ray] = best_inst;
  }
}

}  // namespace

extern "C" int rz_cluster_closest_inst(const float* origin,
                                       const float* direction,
                                       const float* near, const float* far,
                                       const float* ti_rows,
                                       const float* cl_obox,
                                       const float* frames, int n_rays,
                                       int ip, float* t_out, int* id_out,
                                       int* inst_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  closest_inst_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, near, far, ti_rows, cl_obox, frames, n_rays, ip,
      t_out, id_out, inst_out);
  return (int)cudaGetLastError();
}
