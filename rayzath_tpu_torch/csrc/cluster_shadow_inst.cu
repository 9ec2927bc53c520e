// B4: transmission-filtered shadow traversal of the instanced (two-level)
// cluster tables, one thread per ray.
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_shadow_kernel_inst` (launched by `_cluster_shadow_inst_impl`, entry
// point `cluster_shadow_inst`). What it computes is the same: per ray, the
// product of the rgba opacity over every triangle hit with t in (0, dist),
// over every instance, each triangle tested in its instance's object space
// as in B3. The opacity of slot j of cluster s under instance k is
// op_tab[gid][c][cl_slot[s][j]], op_tab being rebuilt from the live
// materials by the wrapper (`instance_opacity`). A ray stops visiting
// instances and clusters once its alpha is below 1e-4, as B2 does. Left
// out, as TPU workarounds: the rank passes, the ranked/direct split, the
// one-hot matrix resolve of the slot opacity, bf16 limbs and HBM
// streaming. The gradient replay of the JAX custom_vjp is not part of this
// forward kernel.
//
// What bounds it on the H100: as B3, plus a 1 KB opacity row staged per
// instance visit and a 512 B slot row per cluster visit, and up to four
// multiplies per hit. Incoherent shadow rays (every NEE sample of a bounce
// wavefront) make it bound by per-visit barriers and divergence.
//
// What the design does about it: the B3 walk (widened world and object
// gates, `__syncthreads_or` skips, frames and slot row staged once per
// cluster visit in shared memory), the instance's 4x64 opacity row staged
// once per instance visit, and a ray whose alpha has fallen below the cut
// stops asking for instances and clusters, so blocks of blocked rays end
// their walk early.
//
// Built with -fmad=false (see rz_cluster.cuh).
#include "rz_cluster.cuh"

namespace {

using namespace rz;

constexpr float ALPHA_STOP = 1e-4f;

__global__ void __launch_bounds__(THREADS)
shadow_inst_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ dist_in,
                   const float* __restrict__ ti_rows,
                   const float* __restrict__ cl_obox,
                   const float* __restrict__ frames,
                   const float* __restrict__ cl_slot,
                   const float* __restrict__ op_tab, int n_rays, int ip,
                   float* __restrict__ rgb_out, float* __restrict__ a_out) {
  __shared__ float fr[FRAME_FLOATS];
  __shared__ float sl[CT];
  __shared__ float op[4 * SLOTS];
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

  for (int k = 0; k < ip; ++k) {
    const float* row = ti_rows + (size_t)k * TI_W;
    const int ncl = (int)row[TI_NCL];
    if (ncl <= 0) continue;  // padding row: the same for every thread
    bool need = false;
    if (active && ma >= ALPHA_STOP) {
      float tmin, tmax;
      slab_wide(row + TI_MIN, row + TI_MAX, ox, oy, oz, ix, iy, iz, tmin,
                tmax);
      need = (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
    }
    // also the barrier after which no thread reads the previous instance's
    // opacity row
    if (!__syncthreads_or(need)) continue;
    const int gid = (int)row[TI_ID];
    const float* osrc = op_tab + (size_t)gid * 4 * SLOTS;
    for (int q = threadIdx.x; q < 4 * SLOTS; q += THREADS) op[q] = osrc[q];
    float o[3], d[3];
    to_object(row + TI_INV, ox, oy, oz, dx, dy, dz, o, d);
    const float ixl = safe_inv(d[0]), iyl = safe_inv(d[1]),
                izl = safe_inv(d[2]);
    const int cl0 = (int)row[TI_CL0];
    for (int s = cl0; s < cl0 + ncl; ++s) {
      const float* cb = cl_obox + (size_t)s * OBOX_W;
      bool cneed = false;
      if (need && ma >= ALPHA_STOP) {
        float tmin, tmax;
        slab_wide(cb, cb + 3, o[0], o[1], o[2], ixl, iyl, izl, tmin, tmax);
        cneed = (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
      }
      // also the barrier that retires the previous cluster's shared rows
      // and publishes this instance's opacity row
      if (!__syncthreads_or(cneed)) continue;
      const float* src = frames + (size_t)s * FRAME_FLOATS;
      for (int q = threadIdx.x; q < FRAME_FLOATS; q += THREADS) fr[q] = src[q];
      const float* ssrc = cl_slot + (size_t)s * CT;
      for (int q = threadIdx.x; q < CT; q += THREADS) sl[q] = ssrc[q];
      __syncthreads();
      if (cneed) {
        const float px = o[0] - (cb[0] + cb[3]) * 0.5f;
        const float py = o[1] - (cb[1] + cb[4]) * 0.5f;
        const float pz = o[2] - (cb[2] + cb[5]) * 0.5f;
        const int n = (int)cb[7];
        for (int j = 0; j < n; ++j) {
          bool inside;
          const float t = project(fr, j, px, py, pz, d[0], d[1], d[2], inside);
          if (inside && t > 0.0f && t < dist) {
            const int q = (int)sl[j];
            mr = mr * op[0 * SLOTS + q];
            mg = mg * op[1 * SLOTS + q];
            mb = mb * op[2 * SLOTS + q];
            ma = ma * op[3 * SLOTS + q];
          }
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

extern "C" int rz_cluster_shadow_inst(const float* origin,
                                      const float* direction,
                                      const float* dist, const float* ti_rows,
                                      const float* cl_obox,
                                      const float* frames,
                                      const float* cl_slot,
                                      const float* op_tab, int n_rays, int ip,
                                      float* rgb_out, float* a_out,
                                      void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  shadow_inst_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, dist, ti_rows, cl_obox, frames, cl_slot, op_tab,
      n_rays, ip, rgb_out, a_out);
  return (int)cudaGetLastError();
}
