// B1: closest-hit traversal of the flat cluster table, ranked front to back
// per block of 128 rays (one ray's walk state per thread).
//
// Replaces the TPU kernel rayzath_tpu/ops/traverse_cluster.py
// `_closest_kernel` (launched by `_cluster_closest_impl`, entry point
// `cluster_closest`). What it computes is the same: per ray, the nearest
// triangle with t in (near, min(far, BIG)), -1 for a miss or for a ray with
// far <= 0; ids are in cluster order (box_tab row 6 + slot) and the wrapper
// maps them through `order`. Ties resolve as in the plain version's table
// order, whatever order the walk takes: a hit replaces the best when it is
// nearer, or equally near with a smaller (cluster row, slot). What the TPU
// kernel needed for its matrix unit and memories is left out: bf16 limbs,
// [8,128] relayouts, bf16-rounded rank distances, SMEM/VMEM staging, the
// tiny/ranked size classes and the occupancy clip.
//
// What bounds it on the H100: the needed work is, per ray, the clusters
// whose slab interval meets [near, t_final], each 128 ray-triangle tests of
// 49 f32 operations (`project` and its compares), against one 6 KB frame
// block per cluster some ray needs. On mesh_heavy's 262,144 bounce-like
// rays that is ~1.5 clusters per ray: 0.026 ms of operations at the 67
// TFLOP/s f32 peak, more than the bytes (rays in, hits out, frames once).
// Built with -fmad=false, every multiply and add issues on its own, so the
// ALU reaches at most half that peak. What kept the first port from it:
// a walk of every row in table order (a block barrier per row), a warp
// that ran the full 128-test loop for the few of its rays that needed a
// cluster, and frame copies that no test overlapped.
//
// What the design does about it, per block of 128 coherence-ordered rays
// (the walk is in rz_cluster.cuh):
// - Rank: the block reduces its active rays to origin and direction
//   bounds; the threads take the cluster rows in turn and bound each row's
//   entry distance from below by interval arithmetic (the TPU kernel's
//   `_axis_interval` / `_cluster_dists`, in f32 with the box widened by
//   GATE_PAD and the bound rounded down); rows no ray can enter before the
//   block's largest best_t drop out, and the rest are sorted by
//   (bound, row), bitonic in shared memory. (The block-min of the rays'
//   exact slab entries ranks tighter but costs every thread a slab test
//   and a warp reduction per row: on an H100 it ran mesh_heavy's bounce
//   rays in 1.24 ms where this rank runs them in 0.65 ms; PERF.md.)
// - Walk in rank order, 32 candidates per block vote: each thread marks
//   the candidates its ray still needs (its exact slab at its current
//   best_t) and votes whether the batch's nearest bound is within reach;
//   when no ray's vote holds the block stops, since every later candidate
//   is farther. One barrier per batch replaces the barrier per table row.
// - Cooperative tests: a visited cluster's needing rays are dealt to the
//   warps, one ray per warp at a time, one triangle slot per lane, and a
//   64-bit (t, slot) minimum across the warp; the ray's own thread takes
//   the result. Lanes no longer idle through another ray's 128 tests.
// - Double-buffered frames: while one cluster is tested, the next marked
//   cluster's frames stream into the other shared buffer with 16-byte
//   cp.async copies; the barrier that publishes them also retires the
//   buffer just tested.
// - Tables larger than RANK_MAX rows are ranked and walked in consecutive
//   windows of rows; the tie key keeps the result exact across windows.
// - Grouped walk (a table above the host's line, ops/traverse_cluster.py
//   GROUPED_ROWS): on mesh_massive's 5,632 rows the flat rank computed
//   5,632 bounds and sorted 4,096 + 2,048 keys per block, and a block with
//   an escaping ray (reach = far) voted on every row: each live ray slab-
//   tested all of them. The block now ranks and votes on the group table
//   (one row per 32 consecutive cluster rows, their union box: 176 rows),
//   and sweeps the real rows of each group it enters in table order as
//   one batch: the rays that need the group vote on each row with their
//   exact gate and the marked rows are visited as above. (Ranking a
//   group's rows by the bounds of the rays that need it, a warp sort, took
//   28% longer on mesh_massive's bounce rays: its barriers cost more than
//   the order saved; PERF.md.) A group's f32 slab interval holds each of its
//   rows', so a ray that needs a row needs its group, and the stop vote
//   holds at the group level; the tie key keeps the table-order answer.
// The gate keeps `tmin <= best_t` with equality and a GATE_PAD slack
// (rz_cluster.cuh gate_t), so a tied cluster is still visited. The rank
// bounds entries at t >= 0 only: a block with a ray of near < 0 (a camera
// whose near is negative) walks its rows in table order without the stop,
// still exact.
//
// Built with -fmad=false (see rz_cluster.cuh): the projection rounds like
// the plain PyTorch version, so every t is the plain version's bits.
#include "rz_cluster.cuh"

namespace {

using namespace rz;

// Resident blocks per SM that the flat walk's registers leave room for
// where shared memory does too (closest_for; on every flat table up to
// GROUPED_ROWS): left to itself the compiler gives the counted walk 84
// registers, room for 5 blocks, where the uncounted walk had 78 and 6, and
// B1 ran 8% slower on cornell_box_nee and 6% on mesh_heavy; at 80
// registers and 32 bytes of spills it runs as the uncounted walk did
// (PERF.md, Findings). A minimum of 0 blocks gives the compiler's own
// choice; a minimum of 1 ran mesh_massive's grouped walk 7% slower.
constexpr int MIN_BLOCKS = 6;

// GROUPED: the walk through the group table grp (walk_grouped), else the
// flat walk of box_tab in windows; registers for MIN resident blocks an SM.
template <bool GROUPED, int MIN>
__global__ void __launch_bounds__(THREADS, MIN)
closest_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ near_in,
               const float* __restrict__ far_in,
               const float* __restrict__ box,
               const float* __restrict__ frames,
               const float* __restrict__ grp, int n_rays, int cp, int gp,
               int list_rows, float* __restrict__ t_out,
               int* __restrict__ id_out, int* __restrict__ visits,
               int* __restrict__ stats,
               unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = shared_layout(smem);
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
  unsigned best_key = 0;  // (row, slot) of the best hit; 0 also for none
  int best_id = -1;
  int n_tests = 0;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Walk w{0, 0};
  int* block_visits = visits ? visits + n_rays + blockIdx.x : nullptr;

  int n_tris = 0;   // the real triangles of the clusters it tested
  int n_slabs = 0;  // its slab tests

  // the exact slab gate of row `row` of an [8][n] table (clusters or groups)
  auto gate = [&](const float* tab, int n, int row) {
    ++n_slabs;
    float tmin, tmax;
    slab(tab, n, row, ox, oy, oz, ix, iy, iz, tmin, tmax);
    return (tmax >= near) && (tmin <= tmax) && (tmin <= gate_t(best_t));
  };
  auto need = [&](int c) { return gate(box, cp, c); };
  auto cur_best = [&]() { return best_t; };
  auto center = [&](int c, float* ctr) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ctr[a] = (box[a * cp + c] + box[(3 + a) * cp + c]) * 0.5f;
    return (int)box[7 * cp + c];
  };
  auto apply = [&](int c) {
    ++n_tests;
    n_tris += (int)box[7 * cp + c];
    const u64 hit = sh.res[threadIdx.x];
    if (hit == NO_CAND) return;
    const float t = ord_float((unsigned)(hit >> 32));
    const int j = (int)(unsigned)hit;
    const unsigned key = (unsigned)c * CT + j;
    if (t < best_t || (t == best_t && key < best_key)) {
      best_t = t;
      best_key = key;
      best_id = (int)box[6 * cp + c] + j;
    }
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
  store_ray(sh, o, d, near);

  if (__syncthreads_or(active)) {
    if constexpr (GROUPED) {
      walk_grouped(
          sh, w, grp, gp, list_rows, active, frames, block_visits,
          stats ? stats + blockIdx.x : nullptr,
          [&] { return block_bounds(sh, active, o, d, near, best_t); },
          [&](int g) { return gate(grp, gp, g); }, need, cur_best, center,
          NoSide{}, ClosestTest{sh}, apply);
    } else {
      for (int w0 = 0; w0 < cp; w0 += list_rows) {
        const int n = min(list_rows, cp - w0);
        const Bounds b = block_bounds(sh, active, o, d, near, best_t);
        const int nf = rank_window(sh, sh.keys, w0, n, b, row_box);
        walk_clusters(sh, w, sh.keys, nf, active, frames, block_visits, need,
                      cur_best, center, NoSide{}, ClosestTest{sh}, apply);
      }
    }
  }
  if (in_range) {
    t_out[ray] = best_t;
    id_out[ray] = best_id;
    if (visits) visits[ray] = n_tests;
  }
  if (work) add_walk_counts(sh, work, n_tests, n_tris, n_slabs);
}

// The kernel of a launch with smem dynamic shared bytes: the grouped walk
// (gp > 0), else the flat walk at MIN_BLOCKS where shared memory leaves
// room for them, else at the compiler's own registers.
auto closest_for(size_t smem, int gp) {
  return gp > 0                        ? closest_kernel<true, 0>
         : smem_fits(smem, MIN_BLOCKS) ? closest_kernel<false, MIN_BLOCKS>
                                       : closest_kernel<false, 0>;
}

}  // namespace

// grp: null for the flat walk; else the group table [8][gp] of box_tab,
// walked with walk_grouped. visits: null on the render path; else
// int[n_rays + blocks] that receives each ray's cluster tests and each
// block's staged clusters. stats: null on the render path; else
// int[blocks] that receives each block's group rows entered, on the
// grouped walk only (the flat walk leaves them 0). work: null, or int64[3]
// that the launch adds to (add_walk_counts), on either walk: its cluster
// tests (each ray's tests of a cluster, as visits counts them), the real
// triangles of those clusters (the ray-triangle tests whose slot j < cnt),
// and its rays' slab tests (the box and group gates).
extern "C" int rz_cluster_closest(const float* origin, const float* direction,
                                  const float* near, const float* far,
                                  const float* box_tab, const float* frames,
                                  const float* grp, int n_rays, int cp,
                                  int gp, float* t_out, int* id_out,
                                  int* visits, int* stats,
                                  unsigned long long* work, void* stream) {
  if (n_rays <= 0) return 0;
  if (grp == nullptr) gp = 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const int list_rows = rank_rows_for(gp > 0 ? gp : cp);
  const size_t smem = gp > 0 ? grouped_smem(1, gp) : kernel_smem(1, cp);
  const auto kernel = closest_for(smem, gp);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      origin, direction, near, far, box_tab, frames, grp, n_rays, cp, gp,
      list_rows, t_out, id_out, visits, stats, work);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch of kernel B<kernel> (1-4) over
// table_rows rows: B1's and B2's cluster rows, B3's and B4's instance rows.
extern "C" int rz_ranked_smem(int table_rows, int kernel) {
  return (int)rz::kernel_smem(kernel, table_rows);
}

// Dynamic shared memory of B1 or B2 (kernel 1, 2) on the grouped walk over
// gp group rows.
extern "C" int rz_grouped_smem(int gp, int kernel) {
  return (int)rz::grouped_smem(kernel, gp);
}

extern "C" const char* rz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Resources of a launch over cp cluster rows, flat (gp = 0) or grouped over
// gp group rows: out[0] registers per thread, out[1] dynamic shared bytes,
// out[2] resident blocks per SM.
extern "C" int rz_closest_resources(int cp, int gp, int* out) {
  const size_t smem = gp > 0 ? grouped_smem(1, gp) : kernel_smem(1, cp);
  const auto kernel = closest_for(smem, gp);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return walk_resources(kernel, smem, out);
}
