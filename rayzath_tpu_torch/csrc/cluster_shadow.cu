// B2: transmission-filtered shadow traversal of the flat cluster table, one
// thread per ray.
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_shadow_kernel` (launched by `_cluster_shadow_impl`, entry point
// `cluster_shadow`). What it computes is the same: per ray, the product of
// the rgba opacity (op_tab, rebuilt from the live materials by the wrapper)
// over every triangle hit with t in (0, dist); a ray stops visiting
// clusters once its alpha is below 1e-4 (the reference's any-hit early
// out, cuda_bvh.cuh:172-232). Left out: bf16 limbs, the one-hot matrix
// transposes of the opacity rows, [8,128] relayouts, SMEM/VMEM staging and
// DMA streaming, and the tiny/ranked size classes. The gradient replay of
// the JAX custom_vjp is not part of this forward kernel.
//
// What bounds it on the H100: each visited cluster costs one 6 KB frame
// block plus a 2 KB opacity block (read from L2) against 128 ray-triangle
// tests of ~40 f32 operations each per ray that needs the cluster, and up
// to four multiplies per hit. As in B1 a full block of rays makes it
// issue-bound; incoherent shadow rays (every NEE sample of a bounce
// wavefront) make it bound by per-visit barriers and divergence.
//
// What the design does about it: the B1 structure (block-wide skip with
// `__syncthreads_or`, frames and opacity staged once per visit in shared
// memory, a per-ray slab gate with the window (0, dist)), and a ray whose
// alpha has fallen below the cut stops asking for clusters, so blocks of
// blocked rays end their walk early. Rays arrive tiled or coherence-sorted.
//
// Built with -fmad=false (see rz_cluster.cuh).
#include "rz_cluster.cuh"

namespace {

using namespace rz;

constexpr float ALPHA_STOP = 1e-4f;

__global__ void __launch_bounds__(THREADS)
shadow_kernel(const float* __restrict__ origin,
              const float* __restrict__ direction,
              const float* __restrict__ dist_in,
              const float* __restrict__ box,
              const float* __restrict__ frames,
              const float* __restrict__ op_tab, int n_rays, int cp,
              float* __restrict__ rgb_out, float* __restrict__ a_out) {
  __shared__ float fr[FRAME_FLOATS];
  __shared__ float op[4 * CT];
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
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  for (int c = 0; c < cp; ++c) {
    const float cnt = box[7 * cp + c];
    if (cnt <= 0.0f) continue;  // padding lane: the same for every thread
    bool need = false;
    if (active && ma >= ALPHA_STOP) {
      float tmin, tmax;
      slab(box, cp, c, ox, oy, oz, ix, iy, iz, tmin, tmax);
      need = (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
    }
    // also the barrier that retires the previous cluster's shared tables
    if (!__syncthreads_or(need)) continue;
    const float* src = frames + (size_t)c * FRAME_FLOATS;
    for (int k = threadIdx.x; k < FRAME_FLOATS; k += THREADS) fr[k] = src[k];
    const float* osrc = op_tab + (size_t)c * 4 * CT;
    for (int k = threadIdx.x; k < 4 * CT; k += THREADS) op[k] = osrc[k];
    __syncthreads();
    if (need) {
      float px, py, pz;
      local_origin(box, cp, c, ox, oy, oz, px, py, pz);
      const int n = (int)cnt;
      for (int j = 0; j < n; ++j) {
        bool inside;
        const float t = project(fr, j, px, py, pz, dx, dy, dz, inside);
        if (inside && t > 0.0f && t < dist) {
          mr = mr * op[0 * CT + j];
          mg = mg * op[1 * CT + j];
          mb = mb * op[2 * CT + j];
          ma = ma * op[3 * CT + j];
        }
      }
    }
  }
  if (in_range) {
    rgb_out[3 * ray + 0] = mr;
    rgb_out[3 * ray + 1] = mg;
    rgb_out[3 * ray + 2] = mb;
    a_out[ray] = ma;
  }
}

}  // namespace

extern "C" int rz_cluster_shadow(const float* origin, const float* direction,
                                 const float* dist, const float* box_tab,
                                 const float* frames, const float* op_tab,
                                 int n_rays, int cp, float* rgb_out,
                                 float* a_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  shadow_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, dist, box_tab, frames, op_tab, n_rays, cp, rgb_out,
      a_out);
  return (int)cudaGetLastError();
}
