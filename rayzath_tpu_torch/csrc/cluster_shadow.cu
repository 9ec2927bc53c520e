// B2: transmission-filtered shadow traversal of the flat cluster table,
// ranked front to back per block of 128 rays (one ray's product per
// thread).
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_shadow_kernel` (launched by `_cluster_shadow_impl`, entry point
// `cluster_shadow`). What it computes is the same: per ray, the product of
// the rgba opacity (op_tab, rebuilt from the live materials by the wrapper)
// over every triangle hit with t in (0, dist), one product per cluster
// folded into the ray's running product; a ray is blocked, and visits no
// more clusters, once its alpha is below ALPHA_STOP (1e-4; the reference's
// any-hit early out, cuda_bvh.cuh:172-232). Left out, as TPU workarounds:
// bf16 limbs, the one-hot matrix transposes of the opacity rows, [8,128]
// relayouts, bf16-rounded rank distances, SMEM/VMEM staging and DMA
// streaming, the tiny/ranked size classes and `_clamp_c`. The gradient
// replay of the JAX custom_vjp is not part of this forward kernel.
//
// What bounds it on the H100: per ray, the clusters whose slab interval
// meets (0, dist) up to the first opaque hit, each 128 ray-triangle tests
// of 49 f32 operations, against one 6 KB frame block and one 2 KB opacity
// block per cluster some ray needs. On mesh_heavy's 262,144 bounce-like
// rays with dist = BIG that is ~1.5 clusters per ray, the same set as B1's:
// 0.026 ms of operations at the 67 TFLOP/s f32 peak, more than the bytes.
// With -fmad=false the ALU reaches at most half that peak. The first port
// walked every row in table order with a barrier per row, tested each ray
// on its own thread and copied frames and opacities synchronously.
//
// What the design does about it, per block of 128 coherence-ordered rays:
// B1's walk (rz_cluster.cuh), with the product in place of the minimum.
// - Rank the cluster rows by the interval bound of the block's live rays'
//   entry (t >= 0), capped at the largest live dist, sort by (bound, row),
//   and walk them in batches of 32 under the block vote: a ray votes while
//   it is live and its dist reaches the batch's nearest bound, and marks the
//   candidates its exact slab gate (tmax >= 0, tmin <= tmax, tmin <= dist)
//   still needs. A blocked ray's reach is -1, so it votes no more, and the
//   block stops when no live ray can reach the next candidate (the TPU
//   kernel's `stop_s`). Front to back meets the opaque hits first: a ray of
//   an opaque scene is blocked after the clusters before its first hit.
// - Cooperative products: each needing ray of a visited cluster is tested
//   by a whole warp, a slot per lane; each lane multiplies the factors of
//   its hits, the warp multiplies the lanes' products by shuffles, and the
//   ray's own thread takes m = m * product, one multiply per channel.
// - Double-buffered staging: the next marked cluster's frames and opacity
//   block stream into the other shared buffers as one cp.async group while
//   the current one is tested.
// - A table above the host's grouped line is walked through its group
//   table as B1 walks it (walk_grouped): rank and vote on groups of 32
//   rows, then sweep the rows of each group entered; a live ray marks a
//   group when its exact slab gate on (0, dist) passes the group's box,
//   which holds every row's. A shadow ray that is not blocked has
//   reach = dist = BIG for a direct light, so the flat walk's live rays
//   slab-tested every row of the table.
// - Tables larger than RANK_MAX rows are ranked and walked in consecutive
//   windows of rows. A product needs no tie key: every hit in (0, dist)
//   counts, whatever the order. The order moves only rounding, and the
//   alpha stop only where the plain product is below ALPHA_STOP too.
//
// Texture-alpha cutouts (CUTOUT, soup scenes with a cutout set): the
// reference filters a shadow ray through each hit's colour-map texel
// (cuda_instance.cuh:92-164; per-hit factor (rgb * tex_rgb, (1 - alpha) *
// (1 - tex_alpha)), cuda_material.cuh:86-95). Where a dense pass over every
// cutout triangle for every ray (engine/integrator.py
// texture_shadow_factor) costs R x C projections a call, this variant
// fetches the texel at the walk's own hits: at each hit in (0, dist) of a
// slot whose cutout map id (cut.map, in the cluster table's slot order) is
// >= 0, it interpolates the texture coordinates from the barycentrics the
// test already has, fetches the texel through rz_texture.cuh's fetch<true>
// (the bounce's fetch) and multiplies (tex_rgb, 1 - tex_alpha) into the
// hit's factor beside the slot's constant opacity. The walk, its stop and
// its shared memory are B2's: the tables are read from global memory at
// the hits only (L1/L2), and a ray stops once its combined alpha is below
// ALPHA_STOP, where the dense pass multiplies every texel (a departure of
// less than ALPHA_STOP in alpha).
//
// Built with -fmad=false (see rz_cluster.cuh).
#include "rz_cluster.cuh"
#include "rz_texture.cuh"

namespace {

using namespace rz;

// B2's cutout tables: per cluster slot (row * CT + j) the colour map id of
// its triangle (-1: not in the cutout set) and the triangle's texture
// coordinates t0, t1 - t0, t2 - t0; and the colour atlas the ids name.
struct Cutouts {
  const int* map;                  // [cp * CT]
  const float* uv;                 // [cp * CT][6]
  unsigned long long* fetched;     // [1]: texels fetched (null: not counted)
  Maps maps;                       // colour fields only
};

// The texel factor of a hit at (b1, b2) in cutout slot `slot` multiplied
// into f, as the dense pass takes it: uv = t0 + b1 (t1 - t0) + b2 (t2 -
// t0), f *= (tex_rgb, 1 - tex_alpha); a slot off the cutout set leaves f.
// n_fetch counts the fetches. Called, not inlined: inlined into each of
// the four unrolled slots of shadow_slots, the fetch took the grouped walk
// to 128 registers and 4 blocks an SM, and B2 on the leaf canopy's 720p
// shadow rays to twice the time of its walk without cutouts; called, 96
// registers, 5 blocks and 6-12% over that walk (PERF.md, Findings).
__device__ __noinline__ void cutout_factor(const Cutouts& cut, int slot,
                                              float b1, float b2, float* f,
                                              int& n_fetch) {
  const int mid = __ldg(cut.map + slot);
  if (mid < 0) return;
  const float* t = cut.uv + 6 * (size_t)slot;
  const float u = __ldg(t + 0) + b1 * __ldg(t + 2) + b2 * __ldg(t + 4);
  const float v = __ldg(t + 1) + b1 * __ldg(t + 3) + b2 * __ldg(t + 5);
  const float4 tex = fetch<true>(cut.maps, mid, u, v);
  f[0] = f[0] * tex.x;
  f[1] = f[1] * tex.y;
  f[2] = f[2] * tex.z;
  f[3] = f[3] * (1.0f - tex.w);
  ++n_fetch;
}

// Resident blocks per SM on the flat walk where shared memory leaves room
// for them, as closest_kernel's MIN_BLOCKS: counting left to the compiler
// takes 86 registers, room for 5 blocks, where the uncounted walk had 64
// and 8, and B2 ran 7% slower on cornell_box_nee (PERF.md, Findings).
// Above 512 table rows shared memory holds B2 to 7 blocks, so there the
// walk keeps the compiler's registers (shadow_for).
constexpr int MIN_BLOCKS = 8;

// GROUPED: the walk through the group table grp (walk_grouped), else the
// flat walk of box_tab in windows; registers for MIN resident blocks an SM;
// CUTOUT: each hit's texel factor from cut (cutout_factor).
template <bool GROUPED, int MIN, bool CUTOUT>
__global__ void __launch_bounds__(THREADS, MIN)
shadow_kernel(const float* __restrict__ origin,
              const float* __restrict__ direction,
              const float* __restrict__ dist_in,
              const float* __restrict__ box,
              const float* __restrict__ frames,
              const float* __restrict__ op_tab,
              const float* __restrict__ grp, int n_rays, int cp, int gp,
              int list_rows, float* __restrict__ rgb_out,
              float* __restrict__ a_out, int* __restrict__ visits,
              int* __restrict__ stats,
              unsigned long long* __restrict__ work, const Cutouts cut) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = shared_layout(smem, B2_SIDE);
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
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Walk w{0, 0};
  int* block_visits = visits ? visits + n_rays + blockIdx.x : nullptr;

  auto live = [&]() { return active && ma >= ALPHA_STOP; };
  auto reach = [&]() { return live() ? dist : -1.0f; };
  int n_tris = 0;   // the real triangles of the clusters it tested
  int n_slabs = 0;  // its slab tests
  int n_fetch = 0;  // CUTOUT: the texels its lanes fetched
  int visited = 0;  // CUTOUT: the cluster row under test (center sets it)

  // the exact slab gate on (0, dist) of row `row` of an [8][n] table
  // (clusters or groups), for a live ray
  auto gate = [&](const float* tab, int n, int row) {
    if (!live()) return false;
    ++n_slabs;
    float tmin, tmax;
    slab(tab, n, row, ox, oy, oz, ix, iy, iz, tmin, tmax);
    return (tmax >= 0.0f) && (tmin <= tmax) && (tmin <= dist);
  };
  auto need = [&](int c) { return gate(box, cp, c); };
  auto center = [&](int c, float* ctr) {
    if constexpr (CUTOUT) visited = c;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ctr[a] = (box[a * cp + c] + box[(3 + a) * cp + c]) * 0.5f;
    return (int)box[7 * cp + c];
  };
  auto side = [&](int buf, int c) {
    stage_rows(sh.side + buf * B2_SIDE, op_tab + (size_t)c * B2_SIDE, B2_SIDE);
  };
  auto test = [&](const float* fr, int buf, const float* ctr, int cnt, int r) {
    const float* op = sh.side + buf * B2_SIDE;
    shadow_test_ray(sh, fr, ctr, cnt, r, [&](int j, float b1, float b2,
                                             float* f) {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = op[k * CT + j];
      if constexpr (CUTOUT)
        cutout_factor(cut, visited * CT + j, b1, b2, f, n_fetch);
    });
  };
  auto apply = [&](int c) {
    ++n_tests;
    n_tris += (int)box[7 * cp + c];
    const float4 p = sh.prod[threadIdx.x];
    mr = mr * p.x;
    mg = mg * p.y;
    mb = mb * p.z;
    ma = ma * p.w;
  };
  auto row_box = [&](int c, float* lo, float* hi) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = box[a * cp + c];
      hi[a] = box[(3 + a) * cp + c];
    }
    return box[7 * cp + c] > 0.0f;
  };
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
  store_ray(sh, o, d, dist);

  if (__syncthreads_or(active)) {
    if constexpr (GROUPED) {
      walk_grouped(
          sh, w, grp, gp, list_rows, active, frames, block_visits,
          stats ? stats + blockIdx.x : nullptr,
          [&] { return block_bounds(sh, live(), o, d, 0.0f, dist); },
          [&](int g) { return gate(grp, gp, g); }, need, reach, center, side,
          test, apply);
    } else {
      for (int w0 = 0; w0 < cp; w0 += list_rows) {
        const int n = min(list_rows, cp - w0);
        const Bounds b = block_bounds(sh, live(), o, d, 0.0f, dist);
        const int nf = rank_window(sh, sh.keys, w0, n, b, row_box);
        walk_clusters(sh, w, sh.keys, nf, active, frames, block_visits, need,
                      reach, center, side, test, apply);
      }
    }
  }
  if (in_range) {
    rgb_out[3 * ray + 0] = mr;
    rgb_out[3 * ray + 1] = mg;
    rgb_out[3 * ray + 2] = mb;
    a_out[ray] = ma;
    if (visits) visits[ray] = n_tests;
  }
  if (work) add_walk_counts(sh, work, n_tests, n_tris, n_slabs, (int)active);
  if constexpr (CUTOUT)
    if (cut.fetched) add_walk_counts(sh, cut.fetched, n_fetch);
}

// The kernel of a launch, as closest_for; the cutout variants keep the
// compiler's registers (the fetch's code would spill under the flat walk's
// cap of 64).
auto shadow_for(size_t smem, int gp, bool cutout) {
  if (cutout)
    return gp > 0 ? shadow_kernel<true, 0, true> : shadow_kernel<false, 0, true>;
  return gp > 0                        ? shadow_kernel<true, 0, false>
         : smem_fits(smem, MIN_BLOCKS) ? shadow_kernel<false, MIN_BLOCKS, false>
                                       : shadow_kernel<false, 0, false>;
}

}  // namespace

// grp, visits, stats: as rz_cluster_closest's; work: null, or int64[4] that
// the launch adds its cluster, triangle and slab tests and its live rays
// (dist > 0) to. cut_map: null, or the
// cutout tables [cp * 128] i32 and cut_uv [cp * 128][6] f32 with the count
// of texels fetched (fetched, int64[1], added to once per block; null: not
// counted), the colour atlas [n_col][4] f32, its block table col_blk
// [n_col][4] i32 and the map tables rect [n_maps][4] i32, flags
// [n_maps][3] i32, map_uv [n_maps][5] f32 (an atlas wc texels wide): the
// cutout variant.
extern "C" int rz_cluster_shadow(const float* origin, const float* direction,
                                 const float* dist, const float* box_tab,
                                 const float* frames, const float* op_tab,
                                 const float* grp, int n_rays, int cp, int gp,
                                 float* rgb_out, float* a_out, int* visits,
                                 int* stats, unsigned long long* work,
                                 const int* cut_map, const float* cut_uv,
                                 unsigned long long* fetched,
                                 const float* color, const int* col_blk,
                                 const int* rect, const int* flags,
                                 const float* map_uv, int n_maps, int wc,
                                 int n_col, void* stream) {
  if (n_rays <= 0) return 0;
  if (grp == nullptr) gp = 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const int list_rows = rank_rows_for(gp > 0 ? gp : cp);
  const size_t smem = gp > 0 ? grouped_smem(2, gp) : kernel_smem(2, cp);
  const auto kernel = shadow_for(smem, gp, cut_map != nullptr);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  Cutouts cut{};
  if (cut_map != nullptr) {
    cut.map = cut_map;
    cut.uv = cut_uv;
    cut.fetched = fetched;
    cut.maps.color = color;
    cut.maps.col_blk = col_blk;
    cut.maps.rect = rect;
    cut.maps.flags = flags;
    cut.maps.uv = map_uv;
    cut.maps.n_maps = n_maps;
    cut.maps.wc = wc;
    cut.maps.n_col = n_col;
  }
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, dist, box_tab, frames, op_tab, grp, n_rays, cp, gp,
      list_rows, rgb_out, a_out, visits, stats, work, cut);
  return (int)cudaGetLastError();
}

// Resources of a launch over cp cluster rows, flat (gp = 0) or grouped over
// gp group rows, of the cutout variant when cutout != 0: out[0] registers
// per thread, out[1] dynamic shared bytes, out[2] resident blocks per SM.
extern "C" int rz_shadow_resources(int cp, int gp, int cutout, int* out) {
  const size_t smem = gp > 0 ? grouped_smem(2, gp) : kernel_smem(2, cp);
  const auto kernel = shadow_for(smem, gp, cutout != 0);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return walk_resources(kernel, smem, out);
}
