// B1: closest-hit traversal of the flat cluster table, one thread per ray.
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_closest_kernel` (launched by `_cluster_closest_impl`, entry point
// `cluster_closest`). What it computes is the same: per ray, the nearest
// triangle with t in (near, min(far, BIG)), the lowest id on a tie inside a
// cluster, -1 for a miss or for a ray with far <= 0; ids are in cluster
// order (box_tab row 6 + slot) and the wrapper maps them through `order`.
// What the TPU kernel needed for its matrix unit and its memories is left
// out: bf16 limbs, [8,128] relayouts, SMEM/VMEM staging and DMA streaming,
// the tiny/ranked size classes and the visit-order rank pass.
//
// What bounds it on the H100: each visited cluster costs one 6 KB frame
// block (1536 f32, read from L2: mesh_heavy's 4.5 MB of frames fit in the
// 50 MB L2) against 128 ray-triangle tests of ~40 f32 operations each per
// ray that needs the cluster (six 3- or 4-term dot products, one IEEE
// division, two multiply-adds, four compares). With a whole block of rays
// in a cluster that is ~100 operations per frame byte, so the walk is
// bound by issue rate and by warp divergence, not by memory; with few rays
// per cluster it is bound by the per-visit barrier and load latency.
//
// What the design does about it: 128 rays per block walk the table in
// order; each thread slab-tests its ray against the cluster box with its
// current window (near, best_t), `__syncthreads_or` skips a cluster no ray
// of the block needs, otherwise the block stages the cluster's frames in
// shared memory once (every thread then reads the same word: a broadcast)
// and only the threads that need the cluster run its triangles. The
// caller orders rays for coherence (32x32 image tiles or the coherence
// sort), so a block's rays tend to need the same clusters. One code path
// covers every table size. Front-to-back ranking, wgmma/TMA tiles and CUDA
// graphs are later work.
//
// Built with -fmad=false (see rz_cluster.cuh): the projection rounds like
// the plain PyTorch version.
#include "rz_cluster.cuh"

namespace {

using namespace rz;

__global__ void __launch_bounds__(THREADS)
closest_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ near_in,
               const float* __restrict__ far_in,
               const float* __restrict__ box,
               const float* __restrict__ frames, int n_rays, int cp,
               float* __restrict__ t_out, int* __restrict__ id_out) {
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
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  for (int c = 0; c < cp; ++c) {
    const float cnt = box[7 * cp + c];
    if (cnt <= 0.0f) continue;  // padding lane: the same for every thread
    bool need = false;
    if (active) {
      float tmin, tmax;
      slab(box, cp, c, ox, oy, oz, ix, iy, iz, tmin, tmax);
      need = (tmax >= near) && (tmin <= tmax) && (tmin <= best_t);
    }
    // also the barrier that retires the previous cluster's shared frames
    if (!__syncthreads_or(need)) continue;
    const float* src = frames + (size_t)c * FRAME_FLOATS;
    for (int k = threadIdx.x; k < FRAME_FLOATS; k += THREADS) fr[k] = src[k];
    __syncthreads();
    if (need) {
      float px, py, pz;
      local_origin(box, cp, c, ox, oy, oz, px, py, pz);
      const int base = (int)box[6 * cp + c];
      const int n = (int)cnt;
      for (int j = 0; j < n; ++j) {
        bool inside;
        const float t = project(fr, j, px, py, pz, dx, dy, dz, inside);
        if (inside && t > near && t < best_t) {
          best_t = t;
          best_id = base + j;
        }
      }
    }
  }
  if (in_range) {
    t_out[ray] = best_t;
    id_out[ray] = best_id;
  }
}

}  // namespace

extern "C" int rz_cluster_closest(const float* origin, const float* direction,
                                  const float* near, const float* far,
                                  const float* box_tab, const float* frames,
                                  int n_rays, int cp, float* t_out,
                                  int* id_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  closest_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, near, far, box_tab, frames, n_rays, cp, t_out,
      id_out);
  return (int)cudaGetLastError();
}

extern "C" const char* rz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
