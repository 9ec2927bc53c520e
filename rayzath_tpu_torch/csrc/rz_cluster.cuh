// Shared device helpers of the cluster traversal kernels
// (cluster_closest.cu, cluster_shadow.cu, cluster_closest_inst.cu,
// cluster_shadow_inst.cu).
//
// Table layouts (built on the host by ops/traverse_cluster.py
// build_cluster_tables / build_instance_tables and
// models/device_scene.py, the same tables as the JAX package's):
//   box_tab [8][cp]        rows 0-2 AABB min, 3-5 AABB max, 6 first triangle
//                          (cluster order), 7 triangle count (0 = padding)
//   frames  [cp][4][3*CT]  row k = input component (x, y, z, 1),
//                          column a*CT + j = part a (b1, b2, z) of triangle j
//   op_tab  [cp][4][CT]    rgba opacity per triangle slot (shadow only)
// Instanced (two-level) tables:
//   ti_rows [ip][TI_W]     per instance: world AABB min (0-2) and max (3-5),
//                          world->object 3x4 row-major (6-17), first shared
//                          cluster row (18), cluster count (19, 0 = padding
//                          row), global instance index (20)
//   cl_obox [cm][8]        per shared cluster: object-space AABB min, max,
//                          first triangle (device order), count
//   cl_slot [cm][CT]       mesh-local material slot per triangle (shadow)
//   op_tab  [I][4][SLOTS]  per instance rgba opacity of each slot (shadow)
//
// Numerics: the library is built with -fmad=false, so every product and
// sum below rounds on its own, in the order written, exactly like the plain
// PyTorch versions in ops/traverse_cluster.py; division is IEEE.
#pragma once

#include <cuda_runtime.h>

namespace rz {

constexpr int CT = 128;                   // triangles per cluster
constexpr int PARTS = 3 * CT;             // frame columns per input row
constexpr int FRAME_FLOATS = 4 * PARTS;   // 1536 floats = 6 KB per cluster
constexpr int THREADS = 128;              // rays per block, one per thread
constexpr float DET_EPS = 1e-7f;
constexpr float BIG = 3.402823466e38f;

// instanced tables
constexpr int TI_W = 24;                  // floats per ti_rows row
constexpr int TI_MIN = 0, TI_MAX = 3, TI_INV = 6;
constexpr int TI_CL0 = 18, TI_NCL = 19, TI_ID = 20;
constexpr int OBOX_W = 8;                 // floats per cl_obox row
constexpr int SLOTS = 64;                 // material slots per instance
// Relative widening of the instanced kernels' slab gates. The instance
// boxes are f32 transforms of the cluster boxes and the gates test them
// with other roundings than the object-space triangle test, so an exact
// gate could drop a hit that the plain version (no gates) finds at an
// instance or cluster face. Widening by 1e-5 of |min| + |max| per axis
// only adds visits; it never changes what a visit returns.
constexpr float GATE_PAD = 1e-5f;

__device__ __forceinline__ float safe_inv(float v) {
  const float eps = 1e-12f;
  const float s = fabsf(v) < eps ? (v < 0.0f ? -eps : eps) : v;
  return 1.0f / s;
}

// Slab test of a ray (origin o, inverse direction i) against cluster c's
// AABB; returns the entry and exit distances.
__device__ __forceinline__ void slab(const float* __restrict__ box, int cp,
                                     int c, float ox, float oy, float oz,
                                     float ix, float iy, float iz,
                                     float& tmin, float& tmax) {
  const float tx1 = (box[0 * cp + c] - ox) * ix;
  const float ty1 = (box[1 * cp + c] - oy) * iy;
  const float tz1 = (box[2 * cp + c] - oz) * iz;
  const float tx2 = (box[3 * cp + c] - ox) * ix;
  const float ty2 = (box[4 * cp + c] - oy) * iy;
  const float tz2 = (box[5 * cp + c] - oz) * iz;
  tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
}

// Cluster-local origin: o - (bmin + bmax) * 0.5, as the plain version forms it.
__device__ __forceinline__ void local_origin(const float* __restrict__ box,
                                             int cp, int c, float ox, float oy,
                                             float oz, float& px, float& py,
                                             float& pz) {
  px = ox - (box[0 * cp + c] + box[3 * cp + c]) * 0.5f;
  py = oy - (box[1 * cp + c] + box[4 * cp + c]) * 0.5f;
  pz = oz - (box[2 * cp + c] + box[5 * cp + c]) * 0.5f;
}

// Widened slab test against the box lo[0..2], hi[0..2] (see GATE_PAD).
__device__ __forceinline__ void slab_wide(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float& tmin, float& tmax) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  tmin = -BIG;
  tmax = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pad = GATE_PAD * (fabsf(lo[a]) + fabsf(hi[a]));
    const float t1 = (lo[a] - pad - o[a]) * inv[a];
    const float t2 = (hi[a] + pad - o[a]) * inv[a];
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
  }
}

// World ray -> object space of one instance with the world->object 3x4
// rows a[0..11]: o' = A o + a, d' = A d. d' stays unnormalized, so a hit's
// t is the world t. Same order of operations as the plain version.
__device__ __forceinline__ void to_object(const float* __restrict__ a,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float* o, float* d) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = a[4 * i] * ox + a[4 * i + 1] * oy + a[4 * i + 2] * oz + a[4 * i + 3];
    d[i] = a[4 * i] * dx + a[4 * i + 1] * dy + a[4 * i + 2] * dz;
  }
}

// Projection of one ray onto triangle j of the cluster whose frames sit in
// shared memory. Returns t and sets inside when (b1, b2) lies in the
// triangle.
__device__ __forceinline__ float project(const float* fr, int j, float px,
                                         float py, float pz, float dx,
                                         float dy, float dz, bool& inside) {
  const float f0x = fr[0 * PARTS + j], f1x = fr[1 * PARTS + j];
  const float f2x = fr[2 * PARTS + j], f3x = fr[3 * PARTS + j];
  const float f0y = fr[0 * PARTS + CT + j], f1y = fr[1 * PARTS + CT + j];
  const float f2y = fr[2 * PARTS + CT + j], f3y = fr[3 * PARTS + CT + j];
  const float f0z = fr[0 * PARTS + 2 * CT + j], f1z = fr[1 * PARTS + 2 * CT + j];
  const float f2z = fr[2 * PARTS + 2 * CT + j], f3z = fr[3 * PARTS + 2 * CT + j];
  const float olx = f0x * px + f1x * py + f2x * pz + f3x;
  const float oly = f0y * px + f1y * py + f2y * pz + f3y;
  const float olz = f0z * px + f1z * py + f2z * pz + f3z;
  const float dlx = f0x * dx + f1x * dy + f2x * dz;
  const float dly = f0y * dx + f1y * dy + f2y * dz;
  float dlz = f0z * dx + f1z * dy + f2z * dz;
  dlz = dlz + (fabsf(dlz) < DET_EPS ? DET_EPS : 0.0f);
  const float t = olz / -dlz;
  const float b1 = olx + t * dlx;
  const float b2 = oly + t * dly;
  inside = (b1 >= 0.0f) & (b1 <= 1.0f) & (b2 >= 0.0f) & (b1 + b2 <= 1.0f);
  return t;
}

}  // namespace rz
