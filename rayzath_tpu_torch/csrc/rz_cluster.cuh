// Shared device helpers of the cluster traversal kernels
// (cluster_closest.cu, cluster_shadow.cu, cluster_closest_inst.cu,
// cluster_shadow_inst.cu) and of the shadow backwards
// (cluster_shadow_grad.cu, cluster_shadow_inst_grad.cu).
//
// Table layouts (built on the host by ops/traverse_cluster.py
// build_cluster_tables / build_instance_tables and
// models/device_scene.py, the same tables as the JAX package's):
//   box_tab [8][cp]        rows 0-2 AABB min, 3-5 AABB max, 6 first triangle
//                          (cluster order), 7 triangle count (0 = padding)
//   frames  [cp][4][3*CT]  row k = input component (x, y, z, 1),
//                          column a*CT + j = part a (b1, b2, z) of triangle j
//   op_tab  [cp][4][CT]    rgba opacity per triangle slot (shadow only)
//   grp     [8][gp]        per GROUP consecutive rows of box_tab: rows 0-5
//                          the union AABB of the real ones, 6 the first
//                          row, 7 the real rows, which lead the group (0 =
//                          padding group); B1/B2 above the line
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
//
// The second half of this header is the ranked front-to-back walk of the
// kernels: a block ranks the candidate rows of a table window by a
// lower bound of the entry distance of its rays (interval arithmetic on the
// block's origin and direction bounds), sorts them by (bound, row) in
// shared memory, and walks them in batches of 32 with one block vote per
// batch, staging each visited cluster's frames (and the shadow kernels'
// side rows) into one of two shared buffers with cp.async while the
// previous cluster is tested. A visited cluster's tests are shared out:
// each ray that needs it is tested by a whole warp, one triangle slot per
// lane. The per-ray test is the kernel's: closest hit reduces a (t, slot)
// minimum, shadow a product of rgba opacities. B1 and B2 walk a table of
// more rows than the host's grouped line through its group table
// (walk_grouped): the block ranks and votes on groups of 32 consecutive
// rows first and sweeps the rows of the groups it enters. B3 and B4 walk
// a two-level table per warp of 32 rays below the block's instance rank
// (warp walk, third part): no shared stage and no block barrier inside the
// walk. B4-grad walks both levels block by block.
//
// The shadow backwards (B2-grad, B4-grad) walk the same way twice with no
// alpha stop: the first walk keeps each ray's product of non-zero factors
// and its count of zero factors (grad_test_ray), the second visits the same
// clusters and adds each hit's share of the gradient (scatter_test_ray)
// into a block accumulator in shared memory, which flush_acc adds to the
// gradient table with one atomicAdd per entry per visit.
#pragma once

#include <cuda_pipeline.h>
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
// shared memory. Returns t, sets inside when (b1, b2) lies in the triangle
// and gives (b1, b2), the hit's weights of the triangle's second and third
// vertex.
__device__ __forceinline__ float project(const float* fr, int j, float px,
                                         float py, float pz, float dx,
                                         float dy, float dz, bool& inside,
                                         float& b1, float& b2) {
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
  b1 = olx + t * dlx;
  b2 = oly + t * dly;
  inside = (b1 >= 0.0f) & (b1 <= 1.0f) & (b2 >= 0.0f) & (b1 + b2 <= 1.0f);
  return t;
}

__device__ __forceinline__ float project(const float* fr, int j, float px,
                                         float py, float pz, float dx,
                                         float dy, float dz, bool& inside) {
  float b1, b2;
  return project(fr, j, px, py, pz, dx, dy, dz, inside, b1, b2);
}

// ---------------------------------------------------------------------------
// ranked front-to-back walk (every kernel)
// ---------------------------------------------------------------------------

typedef unsigned long long u64;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BATCH = 32;            // candidates per block vote (one mask bit each)
constexpr int RANK_MAX = 4096;       // table rows per ranked window (8 B each)
constexpr int B2_GRAD = 5;           // kernel_smem's number of B2-grad
constexpr int B4_GRAD = 6;           // and of B4-grad
constexpr int SWEEP_MAX = 8;         // B3/B4/B4-grad: meshes of <= 8 clusters are swept in order
constexpr int CL_WINDOW = 512;       // B4-grad: cluster rows per ranked window of one mesh
constexpr u64 NO_CAND = ~0ull;       // empty slot of a candidate list
constexpr int FRAME_BYTES = FRAME_FLOATS * 4;
constexpr float ALPHA_STOP = 1e-4f;  // B2/B4: a ray whose alpha is below it is blocked
// floats staged beside each visited cluster's frames by the shadow kernels
constexpr int B2_SIDE = 4 * CT;      // B2: the cluster's rgba opacity block op_tab[c]
constexpr int B4_SIDE = CT;          // B4-grad: the cluster's slot row cl_slot[s]
constexpr int OP_ROW = 4 * SLOTS;    // B4, B4-grad: an instance's opacity row
// the backwards' region: each ray's two coefficient rows [2][4][THREADS]
// and the block accumulator of one visit (B2-grad: [4][CT]; B4-grad:
// [4][SLOTS] of the visited instance)
constexpr int GRAD_ACC = 4 * CT;
constexpr int GRAD_BYTES = 2 * 4 * THREADS * 4 + GRAD_ACC * 4;

// The closest-hit gate's t limit: a box is entered no later than best_t,
// widened by GATE_PAD of |best_t|. The slack only adds visits; it keeps a
// cluster whose hit ties best_t within rounding of the slab's entry (a flat
// box, a shared edge) from being skipped when a ranked walk reached the
// tied hit of a later row first.
__device__ __forceinline__ float gate_t(float best_t) {
  return best_t + GATE_PAD * fabsf(best_t);
}

// Float bits mapped so that unsigned order is numeric order, and back.
__device__ __forceinline__ unsigned ord_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float ord_float(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A candidate is (entry distance, table row) in one 64-bit sort key.
__device__ __forceinline__ u64 cand_key(float pd, int row) {
  return ((u64)ord_bits(pd) << 32) | (unsigned)row;
}
__device__ __forceinline__ int cand_row(u64 key) { return (int)(unsigned)key; }
__device__ __forceinline__ float cand_pd(u64 key) {
  return ord_float((unsigned)(key >> 32));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = BATCH;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory of a block: two frame buffers, the vote words, the
// feasible-candidate counter, the block's rays and their per-visit results
// for the cooperative tests; for a shadow kernel two side-row buffers, the
// per-visit products and (B4-grad) the instance's opacity row; for a shadow
// backward the coefficients and the accumulator (GRAD_BYTES); then the
// candidate lists (8 B per row).
struct Shared {
  float* ring;          // [2][FRAME_FLOATS]
  unsigned* votes;      // [2][2 * WARPS]: per warp the batch mask and the go vote
  int* count;           // [1]
  unsigned* mask;       // [WARPS]: the rays that test the visited cluster
  float* rays;          // [7][THREADS]: origin xyz, direction xyz, and near
                        // (closest hit) or dist (shadow)
  u64* res;             // [THREADS]: each tested ray's (t, slot) key
  float* scratch;       // [16][WARPS]: per-warp partials of block_bounds
  float* side;          // shadow: [2][side floats], beside the two frame buffers
  float4* prod;         // shadow: [THREADS]: each tested ray's rgba product
  float* op_row;        // B4-grad: [OP_ROW]: the visited instance's opacity row
  float* coef;          // backward: [2][4][THREADS]: each ray's A and B rows
  float* acc;           // backward: [GRAD_ACC]: one visit's gradient sums
  u64* keys;            // candidate lists
};

constexpr int OFF_VOTES = 2 * FRAME_BYTES;
constexpr int OFF_COUNT = OFF_VOTES + 2 * 2 * WARPS * 4;
constexpr int OFF_MASK = OFF_COUNT + 16;
constexpr int OFF_RAYS = OFF_MASK + 16;
constexpr int OFF_RES = OFF_RAYS + 7 * THREADS * 4;
constexpr int OFF_SCRATCH = OFF_RES + THREADS * 8;
constexpr int SHARED_HEAD = OFF_SCRATCH + 16 * WARPS * 4;

// Bytes of the shadow regions of a kernel whose side rows are side floats
// and whose instance opacity row is op_row floats (0, 0: closest hit).
__host__ __device__ constexpr int shadow_bytes(int side, int op_row) {
  return side == 0 ? 0 : 2 * side * 4 + THREADS * 16 + op_row * 4;
}

// grad_bytes: GRAD_BYTES for a shadow backward, else 0.
__device__ __forceinline__ Shared shared_layout(unsigned char* smem,
                                                int side = 0, int op_row = 0,
                                                int grad_bytes = 0) {
  Shared s;
  s.ring = reinterpret_cast<float*>(smem);
  s.votes = reinterpret_cast<unsigned*>(smem + OFF_VOTES);
  s.count = reinterpret_cast<int*>(smem + OFF_COUNT);
  s.mask = reinterpret_cast<unsigned*>(smem + OFF_MASK);
  s.rays = reinterpret_cast<float*>(smem + OFF_RAYS);
  s.res = reinterpret_cast<u64*>(smem + OFF_RES);
  s.scratch = reinterpret_cast<float*>(smem + OFF_SCRATCH);
  s.side = reinterpret_cast<float*>(smem + SHARED_HEAD);
  s.prod = reinterpret_cast<float4*>(smem + SHARED_HEAD + 2 * side * 4);
  s.op_row = reinterpret_cast<float*>(smem + SHARED_HEAD + 2 * side * 4 +
                                      THREADS * 16);
  unsigned char* grad = smem + SHARED_HEAD + shadow_bytes(side, op_row);
  s.coef = reinterpret_cast<float*>(grad);
  s.acc = reinterpret_cast<float*>(grad + 2 * 4 * THREADS * 4);
  s.keys = reinterpret_cast<u64*>(grad + grad_bytes);
  return s;
}

// This thread's ray into its slot of the block's rays (origin and direction
// in the space the clusters are tested in; near for closest hit, dist for
// shadow). Read after the next barrier.
__device__ __forceinline__ void store_ray(const Shared& sh, const float* o,
                                          const float* d, float near) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sh.rays[a * THREADS + threadIdx.x] = o[a];
    sh.rays[(3 + a) * THREADS + threadIdx.x] = d[a];
  }
  sh.rays[6 * THREADS + threadIdx.x] = near;
}

// Per-thread walk state that every block-uniform step keeps in step.
struct Walk {
  int ring_next;   // frame buffer the next staged cluster goes into
  int vote_par;    // which half of the vote words the next vote uses
};

// The block's rays as boxes, for the rank: the bounds of the active rays'
// origins and directions, their smallest near (nlo), and cap = the largest
// gate_t(reach) (-inf when no ray is active). A ray's reach is how far a
// hit can still change its result: best_t for closest hit, dist for a
// shadow ray that is not yet blocked.
struct Bounds {
  float olo[3], ohi[3], dlo[3], dhi[3], nlo, cap;
};

constexpr int N_BOUNDS = 14;  // minima that block_bounds reduces

// The 14 minima of the bounds (maxima as minima of negations) over the
// rays of this warp whose lane has active set, with shuffles: every lane
// of the warp calls it and gets them in v.
__device__ __forceinline__ void warp_minima(bool active, const float* o,
                                            const float* d, float near,
                                            float reach, float* v) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = active ? o[a] : INFINITY;
    v[3 + a] = active ? -o[a] : INFINITY;
    v[6 + a] = active ? d[a] : INFINITY;
    v[9 + a] = active ? -d[a] : INFINITY;
  }
  v[12] = active ? -reach : INFINITY;
  v[13] = active ? near : INFINITY;
#pragma unroll
  for (int i = 0; i < N_BOUNDS; ++i)
    for (int s = 16; s > 0; s >>= 1)
      v[i] = fminf(v[i], __shfl_xor_sync(FULL, v[i], s));
}

// The Bounds of the minima v (warp_minima).
__device__ __forceinline__ Bounds bounds_of(const float* v) {
  Bounds b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.olo[a] = v[a];
    b.ohi[a] = -v[3 + a];
    b.dlo[a] = v[6 + a];
    b.dhi[a] = -v[9 + a];
  }
  b.nlo = v[13];
  b.cap = v[12] == INFINITY ? -INFINITY : gate_t(-v[12]);
  return b;
}

// block_bounds of the rays (o, d, near, reach) whose thread has active set:
// the warps' minima (warp_minima), then across the warps through shared
// scratch. Every thread calls it; two barriers. The shadow kernels pass
// near = 0 (they take hits at t > 0).
__device__ __forceinline__ Bounds block_bounds(const Shared& sh, bool active,
                                               const float* o, const float* d,
                                               float near, float reach) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[N_BOUNDS];
  warp_minima(active, o, d, near, reach, v);
  __syncthreads();  // the previous call's readers are done with the scratch
  if (lane == 0)
    for (int i = 0; i < N_BOUNDS; ++i) sh.scratch[i * WARPS + warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N_BOUNDS; ++i) {
    v[i] = sh.scratch[i * WARPS];
    for (int k = 1; k < WARPS; ++k) v[i] = fminf(v[i], sh.scratch[i * WARPS + k]);
  }
  return bounds_of(v);
}

// The same bounds over this warp's rays alone: no shared memory and no
// barrier; every lane of the warp calls it.
__device__ __forceinline__ Bounds warp_bounds(bool active, const float* o,
                                              const float* d, float near,
                                              float reach) {
  float v[N_BOUNDS];
  warp_minima(active, o, d, near, reach, v);
  return bounds_of(v);
}

// Conservative lower bound of the distance t >= 0 at which some ray of the
// block (origin in [olo, ohi], direction in [dlo, dhi]) can enter the box
// lo..hi widened by GATE_PAD, as slab_wide widens it: per axis, the t-range
// in which some d of the range reaches some offset of [lo - ohi, hi - olo]
// (the TPU kernel's _axis_interval), the ranges intersected, and the lower
// end rounded down by 2^-20 (the upper one up) against f32 rounding.
// INFINITY when no ray of the block can enter it by the block's cap. The
// bound covers t >= 0 only, so a block with a ray of near < 0 (whose hits
// behind its origin count) gets -INFINITY for every row: it walks the
// window in table order without the stop, and the per-ray gate and the tie
// key keep its result exact.
__device__ __forceinline__ float entry_bound(const Bounds& b, const float* lo,
                                             const float* hi) {
  if (b.nlo < 0.0f) return -INFINITY;
  float tl = 0.0f, th = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pad = GATE_PAD * (fabsf(lo[a]) + fabsf(hi[a]));
    const float vl = (lo[a] - pad) - b.ohi[a];
    const float vh = (hi[a] + pad) - b.olo[a];
    const float dl = b.dlo[a], dh = b.dhi[a];
    float l, h;
    if (dl > 0.0f) {          // every direction positive on this axis
      l = vl / dh;
      h = vh / dl;
    } else if (dh < 0.0f) {   // every direction negative
      l = vh / dl;
      h = vl / dh;
    } else {                  // the range spans 0: only a one-sided miss
      l = vl > 0.0f ? vl / fmaxf(dh, 1e-30f)
                    : (vh < 0.0f ? vh / fminf(dl, -1e-30f) : 0.0f);
      h = ((vl > 0.0f && dh <= 0.0f) || (vh < 0.0f && dl >= 0.0f))
              ? -1.0f : INFINITY;
    }
    tl = fmaxf(tl, l);
    th = fminf(th, h);
  }
  tl = tl * (1.0f - 1.0f / 1048576.0f);
  th = th > 0.0f ? th * (1.0f + 1.0f / 1048576.0f) : th;
  return (tl <= th && tl <= b.cap) ? tl : INFINITY;
}

// The 32 keys of a warp, one a lane, sorted ascending across the lanes (a
// bitonic network with shuffles): lane l gets the l-th smallest. Every lane
// of the warp calls it.
__device__ __forceinline__ u64 warp_sort(u64 v, int lane) {
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(FULL, v, stride);
      const bool up = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = (lower == up) ? (v < o ? v : o) : (v < o ? o : v);
    }
  }
  return v;
}

// Sort keys[0 .. n) ascending, n a power of two >= 32: warp 0 with shuffles
// for n == 32, else a block-wide bitonic network. Ends with a barrier.
__device__ __forceinline__ void sort_keys(u64* keys, int n) {
  if (n == BATCH) {
    if (threadIdx.x < 32) keys[threadIdx.x] = warp_sort(keys[threadIdx.x], threadIdx.x);
    __syncthreads();
    return;
  }
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const u64 a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Rank rows r0 .. r0+n-1 by entry_bound against the block's bounds b:
// threads take the rows in turn, row_box(row, lo, hi) gives a row's box
// (false: a padding row), the feasible rows become (bound, row) keys and
// the rest NO_CAND; then sort. Returns the number of feasible candidates,
// which lead the sorted list.
template <class RowBox>
__device__ __forceinline__ int rank_window(const Shared& sh, u64* keys, int r0,
                                           int n, const Bounds& b,
                                           RowBox row_box) {
  const int np2 = pow2_at_least(n);
  __syncthreads();  // the previous list's readers are done with it
  if (threadIdx.x == 0) *sh.count = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < np2; i += THREADS) {
    u64 key = NO_CAND;
    float lo[3], hi[3];
    if (i < n && row_box(r0 + i, lo, hi)) {
      const float pd = entry_bound(b, lo, hi);
      if (pd != INFINITY) {
        key = cand_key(pd, r0 + i);
        ++mine;
      }
    }
    keys[i] = key;
  }
  if (mine) atomicAdd(sh.count, mine);
  __syncthreads();
  sort_keys(keys, np2);
  return *sh.count;
}

// A sweep in table order: rows r0 .. r0+n-1 (n <= BATCH) with entry -inf,
// so that the walk's stop vote never ends it.
__device__ __forceinline__ int sweep_window(u64* keys, int r0, int n) {
  __syncthreads();
  if ((int)threadIdx.x < n) keys[threadIdx.x] = cand_key(-INFINITY, r0 + threadIdx.x);
  __syncthreads();
  return n;
}

// Start copying floats (a multiple of 4, from 16-byte aligned addresses)
// from src into shared dst with 16-byte cp.async copies, the block's
// threads in turn; the caller commits the group.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int floats) {
  for (int q = threadIdx.x; q < floats / 4; q += THREADS)
    __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
}

// Block vote on the batch of candidates keys[k0 .. k0 + m), m = min(BATCH,
// n - k0): each active thread votes go when the batch's first entry is
// within its gate (gate_t(reach())) and then marks the candidates its ray
// still needs (need(row)); the block ORs both, in one barrier. Returns the
// block's go (false: no ray can still be changed, since every later entry
// is farther) and the marked candidates in todo. A blocked shadow ray's
// reach is -1, below every ranked entry (>= 0), so it votes no more.
template <class Need, class Reach>
__device__ __forceinline__ bool vote_batch(const Shared& sh, Walk& w,
                                           const u64* keys, int k0, int n,
                                           bool active, Need need,
                                           Reach reach, unsigned& todo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = min(BATCH, n - k0);
  unsigned mask = 0;
  bool go = false;
  if (active) {
    go = cand_pd(keys[k0]) <= gate_t(reach());
    if (go) {
      for (int i = 0; i < m; ++i)
        if (need(cand_row(keys[k0 + i]))) mask |= 1u << i;
    }
  }
  mask = __reduce_or_sync(FULL, mask);
  const unsigned g = __any_sync(FULL, go) ? 1u : 0u;
  unsigned* v = sh.votes + w.vote_par * 2 * WARPS;
  if (lane == 0) {
    v[warp] = mask;
    v[WARPS + warp] = g;
  }
  __syncthreads();
  todo = 0;
  unsigned bg = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    todo |= v[i];
    bg |= v[WARPS + i];
  }
  w.vote_par ^= 1;
  return bg != 0;
}

// Ray r of the block's rays for a test against a cluster centred at ctr:
// the cluster-local origin p = o - ctr, ctr = (bmin + bmax) * 0.5 (as the
// plain version forms it), and the direction d; returns the ray's seventh row (near or dist).
__device__ __forceinline__ float ray_slot(const Shared& sh, const float* ctr,
                                          int r, float* p, float* d) {
  const float* R = sh.rays;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = R[a * THREADS + r] - ctr[a];
    d[a] = R[(3 + a) * THREADS + r];
  }
  return R[6 * THREADS + r];
}

// One ray's closest-hit tests against a cluster's frames fr, by one warp
// (origin p relative to the cluster's centre, direction d): lane l takes
// slots l, l + 32, l + 64, l + 96, and the warp reduces the smallest (t,
// slot) key of the hits with t > near (NO_CAND: none), which every lane
// returns.
__device__ __forceinline__ u64 closest_slots(const float* fr, int cnt,
                                             const float* p, const float* d,
                                             float near) {
  const int lane = threadIdx.x & 31;
  u64 best = NO_CAND;
#pragma unroll
  for (int q = 0; q < CT / 32; ++q) {
    const int j = lane + 32 * q;
    if (j < cnt) {
      bool inside;
      const float t = project(fr, j, p[0], p[1], p[2], d[0], d[1], d[2], inside);
      if (inside && t > near) {
        const u64 key = ((u64)ord_bits(t) << 32) | (unsigned)j;
        best = key < best ? key : best;
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const u64 o = __shfl_xor_sync(FULL, best, s);
    best = o < best ? o : best;
  }
  return best;
}

// closest_slots of ray r of the block's rays against the staged cluster;
// lane 0 writes the key to res[r].
__device__ __forceinline__ void test_ray(const Shared& sh, const float* fr,
                                         const float* ctr, int cnt, int r) {
  float p[3], d[3];
  const float near = ray_slot(sh, ctr, r, p, d);
  const u64 best = closest_slots(fr, cnt, p, d, near);
  if ((threadIdx.x & 31) == 0) sh.res[r] = best;
}

// One ray's shadow tests against a cluster's frames fr, by one warp (p, d
// as for closest_slots): lane l takes slots l, l + 32, l + 64, l + 96 and
// multiplies the rgba factors factor(j, b1, b2, f) of its hits with t in
// (0, dist), (b1, b2) the hit's barycentrics; the warp multiplies the lanes' four partial products by shuffles
// into m, the same bits on every lane (each step multiplies a pair of
// lanes' values, which commute). (The plain version also takes one product
// per cluster; the order inside it differs, by rounding only.)
template <class Factor>
__device__ __forceinline__ void shadow_slots(const float* fr, int cnt,
                                             const float* p, const float* d,
                                             float dist, Factor factor,
                                             float* m) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = 1.0f;
#pragma unroll
  for (int q = 0; q < CT / 32; ++q) {
    const int j = lane + 32 * q;
    if (j < cnt) {
      bool inside;
      float b1, b2;
      const float t = project(fr, j, p[0], p[1], p[2], d[0], d[1], d[2],
                              inside, b1, b2);
      if (inside && t > 0.0f && t < dist) {
        float f[4];
        factor(j, b1, b2, f);
#pragma unroll
        for (int k = 0; k < 4; ++k) m[k] = m[k] * f[k];
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = m[k] * __shfl_xor_sync(FULL, m[k], s);
}

// shadow_slots of ray r of the block's rays against the staged cluster;
// lane 0 writes the ray's product over this cluster to prod[r].
template <class Factor>
__device__ __forceinline__ void shadow_test_ray(const Shared& sh,
                                                const float* fr,
                                                const float* ctr, int cnt,
                                                int r, Factor factor) {
  float p[3], d[3], m[4];
  const float dist = ray_slot(sh, ctr, r, p, d);
  shadow_slots(fr, cnt, p, d, dist, factor, m);
  if ((threadIdx.x & 31) == 0) sh.prod[r] = make_float4(m[0], m[1], m[2], m[3]);
}

// The first walk of a shadow backward: one ray's tests against the staged
// cluster, by one warp, as shadow_test_ray, with no alpha stop and zeros
// kept apart: per channel the product of the non-zero factors of its hits
// with t in (0, dist) and the number of zero factors. Lane 0 writes the
// product to prod[r] and the four counts, 16 bits each, to res[r] (at most
// 128 a cluster).
template <class Factor>
__device__ __forceinline__ void grad_test_ray(const Shared& sh,
                                              const float* fr,
                                              const float* ctr, int cnt,
                                              int r, Factor factor) {
  const int lane = threadIdx.x & 31;
  float p[3], d[3];
  const float dist = ray_slot(sh, ctr, r, p, d);
  float m[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  unsigned z[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < CT / 32; ++q) {
    const int j = lane + 32 * q;
    if (j < cnt) {
      bool inside;
      const float t = project(fr, j, p[0], p[1], p[2], d[0], d[1], d[2], inside);
      if (inside && t > 0.0f && t < dist) {
        float f[4];
        factor(j, f);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (f[k] == 0.0f)
            ++z[k];
          else
            m[k] = m[k] * f[k];
        }
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = m[k] * __shfl_xor_sync(FULL, m[k], s);
#pragma unroll
  for (int k = 0; k < 4; ++k) z[k] = __reduce_add_sync(FULL, z[k]);
  if (lane == 0) {
    sh.prod[r] = make_float4(m[0], m[1], m[2], m[3]);
    sh.res[r] = (u64)z[0] | ((u64)z[1] << 16) | ((u64)z[2] << 32) |
                ((u64)z[3] << 48);
  }
}

// Count k (0-3) of a ray's packed zero counts (grad_test_ray).
__device__ __forceinline__ unsigned zero_count(u64 packed, int k) {
  return (unsigned)(packed >> (16 * k)) & 0xffffu;
}

// The coefficients of a ray with cotangent g, product of non-zero factors
// P and zero count z (per channel k), published in coef for the second
// walk: A = g P when the ray has no zero factor (a hit of factor f != 0
// then gets A / f, the product of the other factors times g), B = g P when
// it has exactly one (that zero factor gets B, the others nothing), else
// 0. Returns whether either is non-zero on some channel.
__device__ __forceinline__ bool store_coef(const Shared& sh, const float* g,
                                           const float* P, const unsigned* z) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gp = g[k] * P[k];
    const float a = z[k] == 0u ? gp : 0.0f;
    const float b = z[k] == 1u ? gp : 0.0f;
    sh.coef[k * THREADS + threadIdx.x] = a;
    sh.coef[(4 + k) * THREADS + threadIdx.x] = b;
    any = any || a != 0.0f || b != 0.0f;
  }
  return any;
}

// The second walk of a shadow backward: one ray's tests against the staged
// cluster, by one warp; for each hit j with t in (0, dist), per channel k
// of factor f, the lane adds A / f (f != 0) or B (f == 0) of the ray's
// coefficients (store_coef), where non-zero, with add(j, k, value) into
// the block accumulator (a shared-memory atomicAdd: other warps test other
// rays against the same slots).
template <class Factor, class Add>
__device__ __forceinline__ void scatter_test_ray(const Shared& sh,
                                                 const float* fr,
                                                 const float* ctr, int cnt,
                                                 int r, Factor factor,
                                                 Add add) {
  const int lane = threadIdx.x & 31;
  float p[3], d[3];
  const float dist = ray_slot(sh, ctr, r, p, d);
  float a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = sh.coef[k * THREADS + r];
    b[k] = sh.coef[(4 + k) * THREADS + r];
  }
#pragma unroll
  for (int q = 0; q < CT / 32; ++q) {
    const int j = lane + 32 * q;
    if (j < cnt) {
      bool inside;
      const float t = project(fr, j, p[0], p[1], p[2], d[0], d[1], d[2], inside);
      if (inside && t > 0.0f && t < dist) {
        float f[4];
        factor(j, f);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = f[k] != 0.0f ? a[k] / f[k] : b[k];
          if (v != 0.0f) add(j, k, v);
        }
      }
    }
  }
}

// Add the block accumulator's n floats to dst, one atomicAdd per non-zero
// entry, and clear them, the block's threads in turn. Every thread calls
// it after the barrier that ends a visit's tests (the next visit's tests
// start after their own barrier); thread i owns entries i, i + THREADS, ...
__device__ __forceinline__ void flush_acc(float* acc, float* __restrict__ dst,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float v = acc[i];
    if (v != 0.0f) {
      atomicAdd(dst + i, v);
      acc[i] = 0.0f;
    }
  }
}

// The cooperative tests of one visit: the rays marked in mask[] are dealt
// to the warps in turn (the i-th marked ray to warp i % WARPS), and the
// warp runs test_one(r) for each of its rays.
template <class TestOne>
__device__ __forceinline__ void test_rays(const Shared& sh, TestOne test_one) {
  const int warp = threadIdx.x >> 5;
  int i = 0;
#pragma unroll
  for (int wq = 0; wq < WARPS; ++wq) {
    unsigned m = sh.mask[wq];
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      if ((i++ % WARPS) == warp) test_one(wq * 32 + b);
    }
  }
}

// The closest-hit kernels' visit: no side rows, and test_ray.
struct NoSide {
  __device__ void operator()(int, int) const {}
};
// No block-wide step after a visit (every kernel but the backwards' second
// walk).
struct NoAfter {
  __device__ void operator()(int) const {}
};
struct ClosestTest {
  const Shared& sh;
  __device__ void operator()(const float* fr, int, const float* ctr, int cnt,
                             int r) const {
    test_ray(sh, fr, ctr, cnt, r);
  }
};

// Walk the candidates keys[0 .. n) in rank order, a batch of 32 per block
// vote (vote_batch), until the vote stops the block. The block visits each
// marked candidate in order: its frames, and the side rows that
// side(buf, row) starts copying, went into ring buffer buf as one commit
// group during the previous visit (the first of a batch is staged on the
// spot); the rays that need it (need(row) at their current reach) publish
// a mask, one barrier makes the staged rows and the mask visible and
// retires the other buffer, the warps test the marked rays cooperatively
// (test(frames, buf, ctr, cnt, r), against the rays' slots of store_ray
// and the box centre center(row, ctr)), and after a second barrier each
// marked thread takes its result with apply(row) and every thread runs
// after(row). Every thread calls this with the same n and list
// (block-uniform).
template <class Need, class Reach, class Center, class Side, class Test,
          class Apply, class After = NoAfter>
__device__ __forceinline__ void walk_clusters(const Shared& sh, Walk& w,
                                              const u64* keys, int n,
                                              bool active,
                                              const float* __restrict__ frames,
                                              int* block_visits, Need need,
                                              Reach reach, Center center,
                                              Side side, Test test,
                                              Apply apply,
                                              After after = After()) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto stage = [&](int buf, int row) {
    stage_rows(sh.ring + buf * FRAME_FLOATS, frames + (size_t)row * FRAME_FLOATS,
               FRAME_FLOATS);
    side(buf, row);
    __pipeline_commit();
  };
  for (int k0 = 0; k0 < n; k0 += BATCH) {
    unsigned todo;
    if (!vote_batch(sh, w, keys, k0, n, active, need, reach, todo)) return;
    if (todo == 0) continue;
    int row = cand_row(keys[k0 + __ffs(todo) - 1]);
    stage(w.ring_next, row);
    while (todo) {
      todo &= todo - 1;
      const int cur = row;
      const bool mine = active && need(cur);
      const unsigned ballot = __ballot_sync(FULL, mine);
      if (lane == 0) sh.mask[warp] = ballot;
      const int buf = w.ring_next;
      const float* fr = sh.ring + buf * FRAME_FLOATS;
      __pipeline_wait_prior(0);
      __syncthreads();  // staged rows and mask visible; the other buffer is done
      w.ring_next ^= 1;
      if (todo) {
        row = cand_row(keys[k0 + __ffs(todo) - 1]);
        stage(w.ring_next, row);
      }
      if (block_visits != nullptr && threadIdx.x == 0) ++*block_visits;
      float ctr[3];
      const int cnt = center(cur, ctr);
      test_rays(sh, [&](int r) { test(fr, buf, ctr, cnt, r); });
      __syncthreads();  // results visible
      if (mine) apply(cur);
      after(cur);
    }
  }
}

// Walk the candidates keys[0 .. n) of the instance level (B4-grad) in rank
// order, batches and stop vote as walk_clusters; visit(row) runs the
// instance's whole cluster walk, block-uniformly.
template <class Need, class Reach, class Visit>
__device__ __forceinline__ void walk_rows(const Shared& sh, Walk& w,
                                          const u64* keys, int n, bool active,
                                          Need need, Reach reach,
                                          Visit visit) {
  for (int k0 = 0; k0 < n; k0 += BATCH) {
    unsigned todo;
    if (!vote_batch(sh, w, keys, k0, n, active, need, reach, todo)) return;
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      visit(cand_row(keys[k0 + i]));
    }
  }
}

// The walks' work counters: add the block's counts to work[0], work[1],
// ..., a warp sum each, then one atomicAdd per counter from thread 0.
// B3/B4 count instance visits (their rays' calls of to_object) and
// (instance, cluster) tests; B1/B2 cluster tests, the real triangles of
// the clusters tested, and slab tests; B2 and B4 then their live rays
// (dist > 0: the rays that walk at all). Every thread calls it once, after
// its walk; the per-warp partials reuse the scratch of block_bounds, whose
// last readers are done once the first barrier passes.
template <class... Counts>
__device__ __forceinline__ void add_walk_counts(const Shared& sh,
                                                unsigned long long* work,
                                                Counts... counts) {
  constexpr int N = sizeof...(Counts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c[N] = {counts...};
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = __reduce_add_sync(FULL, c[i]);
  int* part = reinterpret_cast<int*>(sh.scratch);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[i * WARPS + warp] = c[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      unsigned long long v = 0;
      for (int k = 0; k < WARPS; ++k) v += (unsigned)part[i * WARPS + k];
      if (v) atomicAdd(work + i, v);
    }
  }
}

// ---------------------------------------------------------------------------
// grouped walk of a large flat table (B1, B2)
// ---------------------------------------------------------------------------

// The group table grp [8][gp] of a flat table box_tab [8][cp] (built on the
// host by ops/traverse_cluster.py group_table): column g covers the GROUP
// cluster rows g * GROUP .. g * GROUP + GROUP - 1, consecutive BVH leaves;
// rows 0-5 hold the union AABB of its real rows, row 6 its first row and
// row 7 its count of real rows, which come first in the group (0 = padding
// group, inverted box).
constexpr int GROUP = 32;             // cluster rows per group row (one BATCH)
static_assert(GROUP == BATCH, "a group's rows are swept as one vote batch");

// Walk a flat table of cp cluster rows through its group table grp [8][gp],
// in windows of list_g group rows: rank the group rows by entry_bound
// against bounds() (the block's bounds of its active rays), walk them in
// batches of 32 under the block vote, each active ray marking the groups
// that its exact slab gate gneed(g) passes (a group's box holds its rows'
// boxes, so its f32 slab interval holds theirs: a ray that needs a row
// needs its group), and stop when the next group lies beyond every live
// ray's reach. Each marked group's real rows (the first grp[7][g] of its
// GROUP rows) are swept in table order as one batch of walk_clusters
// (need, reach, center, side, test, apply as there), the rays that marked
// the group voting on each row. The group keys lead sh.keys; a group's row
// keys follow them. block_groups: null, or the block's count of groups
// entered (thread 0 adds). Every thread calls it (block-uniform).
template <class BoundsOf, class GNeed, class Need, class Reach, class Center,
          class Side, class Test, class Apply>
__device__ __forceinline__ void walk_grouped(
    const Shared& sh, Walk& w, const float* __restrict__ grp, int gp,
    int list_g, bool active, const float* __restrict__ frames,
    int* block_visits, int* block_groups, BoundsOf bounds, GNeed gneed,
    Need need, Reach reach, Center center, Side side, Test test,
    Apply apply) {
  u64* keys_g = sh.keys;
  u64* keys_c = sh.keys + list_g;
  auto group_box = [&](int g, float* lo, float* hi) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = grp[a * gp + g];
      hi[a] = grp[(3 + a) * gp + g];
    }
    return grp[7 * gp + g] > 0.0f;
  };
  auto visit_group = [&](int g) {
    const bool in_g = active && gneed(g);
    if (block_groups != nullptr && threadIdx.x == 0) ++*block_groups;
    const int n = sweep_window(keys_c, (int)grp[6 * gp + g],
                               (int)grp[7 * gp + g]);
    walk_clusters(sh, w, keys_c, n, in_g, frames, block_visits, need, reach,
                  center, side, test, apply);
  };
  for (int g0 = 0; g0 < gp; g0 += list_g) {
    const int nf = rank_window(sh, keys_g, g0, min(list_g, gp - g0), bounds(),
                               group_box);
    walk_rows(sh, w, keys_g, nf, active, gneed, reach, visit_group);
  }
}

// ---------------------------------------------------------------------------
// warp walk of the two-level tables (B3, B4)
// ---------------------------------------------------------------------------

// B3 and B4 rank the instance rows per block as above and then let each
// warp walk that list, and every mesh it enters, for its own 32 rays
// alone. A block instance visit served few of its 128 rays, yet every one
// cost all of them the object transform, a block rank of the mesh's
// clusters and a vote, and every cluster visit two block barriers. In the
// warp walk a visit costs only the warp whose rays need it: the lanes that
// need the instance move into object space, the warp takes its own bounds
// with shuffles (warp_bounds), ranks the mesh's clusters one a lane,
// BATCH at a time (warp_rank; meshes of at most SWEEP_MAX clusters are
// swept in table order), and visits them in rank order under its own vote
// (warp_walk). Each needing ray of a visited cluster is tested by the
// whole warp, a slot a lane, its origin and direction taken from its lane
// by shuffles and the cluster's frames read straight from global memory
// (a mesh's frames stay in L1 and L2: instanced_field's whole object table
// is 25 clusters of 6 KB), so no shared memory is staged and no barrier
// waits. The block's instance bounds hold each warp's rays, so every entry
// bound of the block's list stays a lower bound for each warp and the
// warp's stop is exact; the per-ray gates and the tie key make B3's hits
// independent of the walk's order, so they are the plain version's bits.

// The warp walk's shared memory: the candidate counter, block_bounds'
// scratch and the instance list; nothing a visit.
constexpr int WARP_OFF_SCRATCH = 16;
constexpr int WARP_HEAD = WARP_OFF_SCRATCH + 16 * WARPS * 4;

__device__ __forceinline__ Shared warp_layout(unsigned char* smem) {
  Shared s{};
  s.count = reinterpret_cast<int*>(smem);
  s.scratch = reinterpret_cast<float*>(smem + WARP_OFF_SCRATCH);
  s.keys = reinterpret_cast<u64*>(smem + WARP_HEAD);
  return s;
}

// The warp's candidates among rows r0 .. r0+n-1 (n <= BATCH), one key a
// lane in rank order: each lane l < n takes row r0 + l, row_box gives its
// box (false: a padding row), a feasible row becomes its (entry_bound
// against the warp's bounds b, row) key and the rest NO_CAND, and the warp
// sorts them (warp_sort). Sets nf to the feasible candidates, which lead.
template <class RowBox>
__device__ __forceinline__ u64 warp_rank(const Bounds& b, int r0, int n,
                                         RowBox row_box, int& nf) {
  const int lane = threadIdx.x & 31;
  u64 key = NO_CAND;
  float lo[3], hi[3];
  if (lane < n && row_box(r0 + lane, lo, hi)) {
    const float pd = entry_bound(b, lo, hi);
    if (pd != INFINITY) key = cand_key(pd, r0 + lane);
  }
  key = warp_sort(key, lane);
  nf = __popc(__ballot_sync(FULL, key != NO_CAND));
  return key;
}

// sweep_window for a warp: rows r0 .. r0+n-1 (n <= BATCH) in table order,
// entry -inf, one key a lane.
__device__ __forceinline__ u64 warp_sweep(int r0, int n) {
  const int lane = threadIdx.x & 31;
  return lane < n ? cand_key(-INFINITY, r0 + lane) : NO_CAND;
}

// Walk a warp's candidates in rank order, key_at(i) being candidate i (the
// same on every lane). Before each, the warp stops when no active lane's
// gate, gate_t(reach()), reaches its entry (every later entry is farther;
// a blocked shadow ray's reach of -1 is below every ranked entry); the
// lanes whose ray needs it (need(row) at their current reach) form a
// mask, and a candidate with a non-empty mask is visited: visit(row,
// mask). Every lane of the warp calls it with the same n (warp-uniform).
template <class KeyAt, class Need, class Reach, class Visit>
__device__ __forceinline__ void warp_walk(KeyAt key_at, int n, bool active,
                                          Need need, Reach reach,
                                          Visit visit) {
  for (int i = 0; i < n; ++i) {
    const u64 key = key_at(i);
    if (!__any_sync(FULL, active && cand_pd(key) <= gate_t(reach()))) return;
    const int row = cand_row(key);
    const unsigned mask = __ballot_sync(FULL, active && need(row));
    if (mask) visit(row, mask);
  }
}

// A visited mesh's clusters cl0 .. cl0+ncl-1 for the warp, in windows of
// BATCH: ranked by the warp's bounds of its rays that entered the mesh
// (bounds()), or swept when ncl <= SWEEP_MAX, and walked by warp_walk
// (active: this lane's ray entered the mesh; need, reach, visit as
// there).
template <class BoundsOf, class RowBox, class Need, class Reach, class Visit>
__device__ __forceinline__ void warp_walk_mesh(int cl0, int ncl, bool active,
                                               BoundsOf bounds, RowBox row_box,
                                               Need need, Reach reach,
                                               Visit visit) {
  for (int s0 = 0; s0 < ncl; s0 += BATCH) {
    const int n = min(BATCH, ncl - s0);
    int nf = n;
    const u64 key = ncl <= SWEEP_MAX
                        ? warp_sweep(cl0 + s0, n)
                        : warp_rank(bounds(), cl0 + s0, n, row_box, nf);
    warp_walk([&](int i) { return __shfl_sync(FULL, key, i); }, nf, active,
              need, reach, visit);
  }
}

// Ray r of the warp for a test against a cluster centred at ctr: the lane
// r's object-space origin o and direction d by shuffles, p = o - ctr as
// ray_slot forms it; returns lane r's v (near or dist).
__device__ __forceinline__ float warp_ray(const float* o, const float* d,
                                          float v, const float* ctr, int r,
                                          float* p, float* dr) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = __shfl_sync(FULL, o[a], r) - ctr[a];
    dr[a] = __shfl_sync(FULL, d[a], r);
  }
  return __shfl_sync(FULL, v, r);
}

inline int rank_rows_for(int table_rows) {
  int p = BATCH;
  while (p < table_rows && p < RANK_MAX) p <<= 1;
  return p;
}

// Host: dynamic shared memory of kernel B<kernel> (1-4; 5: B2-grad, 6:
// B4-grad) over table_rows rows: the candidate list of one window of them
// (B1/B2: cluster rows; B3/B4, B4-grad: instance rows, B4-grad's plus one
// window of a mesh's clusters) after the warp walk's head (B3/B4,
// warp_layout) or the block walk's and its shadow and backward regions.
inline size_t kernel_smem(int kernel, int table_rows) {
  if (kernel == 3 || kernel == 4)
    return (size_t)WARP_HEAD + (size_t)rank_rows_for(table_rows) * sizeof(u64);
  const int rows =
      rank_rows_for(table_rows) + (kernel == B4_GRAD ? CL_WINDOW : 0);
  const int shadow = (kernel == 2 || kernel == B2_GRAD)
                         ? shadow_bytes(B2_SIDE, 0)
                     : kernel == B4_GRAD ? shadow_bytes(B4_SIDE, OP_ROW)
                                         : 0;
  const int grad = (kernel == B2_GRAD || kernel == B4_GRAD) ? GRAD_BYTES : 0;
  return (size_t)SHARED_HEAD + (size_t)shadow + (size_t)grad +
         (size_t)rows * sizeof(u64);
}

// Host: dynamic shared memory of B1 or B2 (kernel 1, 2) on the grouped
// path over gp group rows: one window of group keys and one group's row
// keys (walk_grouped).
inline size_t grouped_smem(int kernel, int gp) {
  return kernel_smem(kernel, gp) + (size_t)GROUP * sizeof(u64);
}

// Host: the resources of a launch of kernel with smem bytes of dynamic
// shared memory: out[0] registers per thread, out[1] the shared bytes,
// out[2] resident blocks per SM, out[3] local (spilled) bytes per thread
// (for reports).
template <class Kernel>
inline int walk_resources(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, smem);
  out[0] = err == cudaSuccess ? attr.numRegs : 0;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = err == cudaSuccess ? (int)attr.localSizeBytes : 0;
  return (int)err;
}

// Host: attribute a of the current device (0 where it cannot be read).
inline int device_attribute(cudaDeviceAttr a) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, a, dev) != cudaSuccess)
    return 0;
  return v;
}

// Host: whether `blocks` resident blocks of `smem` dynamic shared bytes
// each (and no static ones) fit in one SM's shared memory.
inline bool smem_fits(size_t smem, int blocks) {
  static const long long per_sm =
      device_attribute(cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  static const long long reserved =
      device_attribute(cudaDevAttrReservedSharedMemoryPerBlock);
  return blocks * ((long long)smem + reserved) <= per_sm;
}

// Host: launch-side opt-in above the default 48 KB of shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rz
