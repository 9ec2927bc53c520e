// The bounce's elementwise layer: the arithmetic of one wavefront bounce
// (engine/integrator.py `bounce_step`) in three kernels, cut where the
// traversal walks run:
//
//   bounce_head_kernel     before the closest-hit walk (`_head`): the
//                          segment's near/far and the medium's free flight;
//   bounce_surface_kernel  between it and the shadow walks (`_surface`):
//                          the hit row, the instance transforms, the
//                          surface frame, the material and its maps,
//                          normal mapping, Beer's law, the emission, the
//                          next direction, the hit point and each light
//                          sample's shadow ray and unshadowed weight;
//   bounce_tail_kernel     after the shadow walks (`_tail`): the samples
//                          under their visibility, the accumulation, the
//                          depth and space buffers and the next state, with
//                          terminated paths regenerated through the camera.
//
// Replaces no TPU kernel: the JAX package leaves this arithmetic to XLA,
// which fuses it. The plain torch stages run it as ~800 separate kernels a
// pass at 921,600 rays; here it is one thread per ray in the state's pixel
// order.
//
// What bounds it on the H100: bytes. A bounce reads the ray's state, its
// uniforms, its hit's 32-float `tri_pack` row, two material rows, up to
// five maps' 2x2 texels and the light rows, and writes the shadow rays and
// the next state: about 0.55 KB a ray over the three kernels, 0.15 ms at
// 3.35 TB/s for 921,600 rays (chip_smoke.py's `phase_bounce` counts each
// stage's bytes; there the head takes 2.9x its bound, the surface 2.1-3.6x,
// the tail 1.4x). The design does the one thing a bound by bytes asks:
// every intermediate of a stage stays in registers, and a stage reads the
// scene's tables where they lie instead of gathered copies.
//
// The arithmetic is the plain stages' as torch computes them on the card,
// op for op and in their order, each op rounded on its own (-fmad=false,
// IEEE division and square root, the same libm functions): a division by a
// Python float is a multiplication by its float reciprocal (torch's CUDA
// division by a CPU scalar), `1.0 / x` a reciprocal, `torch.remainder` an
// fmod moved to the divisor's sign, `torch.round` to nearest even, a clamp
// keeps a NaN. Where the plain version computes a value for every ray and
// selects with `torch.where`, the kernel computes only the selected one
// (texture fetches of absent maps, the branches of the next direction, the
// geometry of a miss, the camera ray of a path that goes on).
//
// Variants: `bounce_surface_kernel` is a template on whether the scene has
// maps, whether it is two-level and whether it has lights, so that code a
// scene cannot run costs it no registers.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "rz_texture.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float BIG = 3.402823466e38f;
constexpr int PATH_LIMIT = 255;
constexpr double TWO_PI = 6.283185307179586;
constexpr double PI = 3.141592653589793;
constexpr int MP_W = 14;          // integrator.mat_pack's row width
constexpr int TP_W = 32;          // TorchScene.tri_pack's row width

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

// ops/vec.py `dot`: summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp: a NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// torch.minimum: a NaN in either wins
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// ops/vec.py `normalize`: v * (1 / sqrt(clamp(v.v, 1e-20)))
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, 1.0f / sqrtf(clamp_min(dot(v, v), (float)1e-20)));
}

// ops/vec.py `lerp`: a + (b - a) * t
__device__ __forceinline__ float lerp(float a, float b, float t) { return a + (b - a) * t; }
__device__ __forceinline__ V3 lerp3(V3 a, V3 b, float t) {
  return {lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t)};
}

__device__ __forceinline__ V3 ld3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ void st3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

// ---------------------------------------------------------------------------
// ops/vec.py
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 reflect(V3 vi, V3 vn) { return sub(vi, scale(vn, 2.0f * dot(vn, vi))); }

__device__ __forceinline__ V3 halfway(V3 vi, V3 vr) { return normalize(sub(vr, vi)); }

__device__ __forceinline__ void local_frame(V3 vn, V3& vx, V3& vy) {
  const float b = fabsf(vn.x) > fabsf(vn.y) ? 1.0f : 0.0f;
  const V3 vx0 = {1.0f - b, b, 0.0f};
  vy = cross(vn, vx0);
  vx = cross(vn, vy);
}

__device__ __forceinline__ V3 cosine_sample_hemisphere(float r1, float r2, V3 vn) {
  V3 vx, vy;
  local_frame(vn, vx, vy);
  const float phi = r1 * (float)TWO_PI;
  const float sq = sqrtf(r2);
  return add(add(scale(vx, sq * cosf(phi)), scale(vy, sq * sinf(phi))),
             scale(vn, sqrtf(clamp_min(1.0f - r2, (float)1e-12))));
}

__device__ __forceinline__ V3 sample_sphere(float r1, float r2, V3 vn) {
  V3 vx, vy;
  local_frame(vn, vx, vy);
  const float phi = r1 * (float)TWO_PI;
  const float cos_theta = 1.0f - 2.0f * r2;
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, (float)1e-12));
  return add(add(scale(vx, sin_theta * cosf(phi)), scale(vy, sin_theta * sinf(phi))),
             scale(vn, cos_theta));
}

__device__ __forceinline__ V3 sample_disk(float r1, float r2, V3 vn, float radius) {
  V3 vx, vy;
  local_frame(vn, vx, vy);
  const float ang = r1 * (float)TWO_PI;
  const float rad = sqrtf(r2) * radius;
  return add(scale(vx, sinf(ang) * rad), scale(vy, cosf(ang) * rad));
}

// ops/vec.py `fresnel_specular_ratio`, its value: f_relaxed + (f_hard -
// f_relaxed), the relaxed blend's sigmoid as torch's 1 / (1 + exp(-x))
__device__ __forceinline__ void fresnel_specular_ratio(V3 vn, V3 vi, float n1, float n2,
                                                       float& f, float& ratio, float& refr_b) {
  ratio = n1 / clamp_min(n2, (float)1e-20);
  const float cosi = fabsf(dot(vi, vn));
  const float sin2_t = ratio * ratio * (1.0f - cosi * cosi);
  const bool tir = sin2_t >= 1.0f;
  const float cost = sqrtf(clamp_min(1.0f - sin2_t, (float)1e-12));
  const float rp = (n1 * cosi - n2 * cost) / clamp_min(n1 * cosi + n2 * cost, (float)1e-20);
  const float rs = (n2 * cosi - n1 * cost) / clamp_min(n2 * cosi + n1 * cost, (float)1e-20);
  const float f_fresnel = 0.5f * (rs * rs + rp * rp);
  const float f_hard = tir ? 1.0f : f_fresnel;
  const float x = (sin2_t - 1.0f) * (1.0f / (float)0.05);     // / TIR_TAU
  const float w_tir = 1.0f / (1.0f + expf(-x));
  const float f_relaxed = f_fresnel + (1.0f - f_fresnel) * w_tir;
  f = f_relaxed + (f_hard - f_relaxed);
  refr_b = ratio * cosi - cost;
}

// ---------------------------------------------------------------------------
// ops/camera.py
// ---------------------------------------------------------------------------

struct Camera {
  const float* position;     // [3]
  const float* rot;          // [3,3], columns the axes
  const float* fov;
  const float* near_far;     // [2]
  const float* focal_distance;
  const float* aperture;
  int width, height;         // the camera's (the pinhole's aspect)
};

// `_rotate`: v @ rot.T, summed over the axes in order
__device__ __forceinline__ V3 rotate(V3 v, const float* rot) {
  return {v.x * __ldg(rot + 0) + v.y * __ldg(rot + 1) + v.z * __ldg(rot + 2),
          v.x * __ldg(rot + 3) + v.y * __ldg(rot + 4) + v.z * __ldg(rot + 5),
          v.x * __ldg(rot + 6) + v.y * __ldg(rot + 7) + v.z * __ldg(rot + 8)};
}

// `generate_rays` for the pixel (px, py) with uniforms u[0:4]
__device__ __forceinline__ void generate_ray(const Camera& cam, float px, float py,
                                             const float* u, V3& origin, V3& direction) {
  const float w = (float)cam.width, h = (float)cam.height;
  const float aspect = w / h;
  const float tana = tanf(__ldg(cam.fov) * 0.5f);
  float dx = ((px + 0.5f) / w - 0.5f) * tana;
  float dy = ((py + 0.5f) / h - 0.5f) * (-tana / aspect);
  const float jit = (1.0f / w) * 0.5f;                  // 0.5 / w
  dx = dx + jit * (u[0] * 2.0f - 1.0f);
  dy = dy + jit * (u[1] * 2.0f - 1.0f);
  const float fd = __ldg(cam.focal_distance);
  const V3 focal = {dx * fd, dy * fd, 1.0f * fd};
  const float ap_angle = u[2] * (float)TWO_PI;
  const float ap_radius = sqrtf(u[3]) * __ldg(cam.aperture);
  const V3 o = {ap_radius * sinf(ap_angle), ap_radius * cosf(ap_angle), 0.0f};
  origin = add(rotate(o, cam.rot), ld3(cam.position));
  direction = normalize(rotate(sub(focal, o), cam.rot));
}

// `sky_texcrd`
__device__ __forceinline__ void sky_texcrd(V3 d, float& tu, float& tv) {
  tu = -(0.5f + atan2f(d.z, d.x) * (1.0f / (float)TWO_PI));
  tv = 0.5f + asinf(clamp(d.y, -1.0f, 1.0f)) * (1.0f / (float)PI);
}

// ---------------------------------------------------------------------------
// engine/integrator.py: material, BSDF, next direction, light samples
// ---------------------------------------------------------------------------

struct Mat {
  V3 rgb;
  float alpha_op, metal, rough, emis, ior, scat;
  int normal_map;
};

// `material_fetch` of material row `mat_id` at (tu, tv)
template <bool MAPS>
__device__ __forceinline__ Mat material_fetch(const float* mp, int mp_rows, int n_mat, const Maps& m,
                                              int mat_id, float tu, float tv) {
  const int row = clampi(clampi(mat_id, 0, n_mat - 1), 0, mp_rows - 1);
  const float* r = mp + MP_W * row;
  Mat out;
  out.rgb = ld3(r);
  out.alpha_op = 1.0f - __ldg(r + 3);
  out.metal = __ldg(r + 4);
  out.rough = __ldg(r + 5);
  out.emis = __ldg(r + 6);
  out.ior = __ldg(r + 7);
  out.scat = __ldg(r + 8);
  out.normal_map = -1;
  if (MAPS) {
    const int tex_id = (int)rintf(__ldg(r + 9)), nrm_id = (int)rintf(__ldg(r + 10));
    const int met_id = (int)rintf(__ldg(r + 11)), rgh_id = (int)rintf(__ldg(r + 12));
    const int emi_id = (int)rintf(__ldg(r + 13));
    if ((m.used & 1) && tex_id >= 0) {
      const float4 t = fetch<true>(m, tex_id, tu, tv);
      out.rgb = {out.rgb.x * t.x, out.rgb.y * t.y, out.rgb.z * t.z};
      out.alpha_op = out.alpha_op * (1.0f - t.w);
    }
    if ((m.used & 4) && met_id >= 0) out.metal = fetch<false>(m, met_id, tu, tv).x;
    if ((m.used & 8) && rgh_id >= 0) out.rough = fetch<false>(m, rgh_id, tu, tv).x;
    if ((m.used & 16) && emi_id >= 0) out.emis = out.emis * fetch<false>(m, emi_id, tu, tv).x;
    if (m.used & 2) out.normal_map = nrm_id;
  }
  return out;
}

__device__ __forceinline__ float att(float c, float rough) {
  c = clamp_min(c, 0.0f);
  return c / (c * (1.0f - rough) + rough + (float)1e-7);
}

// `brdf_eval`
__device__ __forceinline__ float brdf_eval(V3 d_in, V3 mn, float surf_scat, float rough,
                                           float alpha_op, float reflectance, V3 vpl) {
  const float n_dot_o = dot(mn, vpl);
  const float n_dot_i = dot(mn, neg(d_in));
  const V3 vh = halfway(d_in, vpl);
  const float n_dot_h = clamp(dot(mn, vh), -1.0f, 1.0f);
  const float b = n_dot_h * n_dot_h * (rough - 1.0f) + (float)1.0001;
  const float ndf = (rough + (float)1e-5) / (b * b);
  const float attenuation = att(n_dot_i, rough) * att(n_dot_o, rough);
  const float diffuse = n_dot_o * (alpha_op == 0.0f ? 1.0f : 0.0f);
  const float specular = ndf * attenuation / clamp_min(n_dot_i * n_dot_o, (float)1e-7);
  float val = lerp(diffuse, specular * n_dot_o, reflectance);
  val = (n_dot_o <= 0.0f || n_dot_i <= 0.0f) ? 0.0f : val;
  return surf_scat > 0.0f ? 1.0f : val;
}

__device__ __forceinline__ V3 flip_above(V3 v, V3 n) {
  const float c = dot(n, v);
  return c < 0.0f ? sub(v, scale(n, 2.0f * c)) : v;
}

struct Lights {
  const float *spot_pos, *spot_dir, *spot_color, *spot_size, *spot_emission, *spot_cos;
  const float *dir_dir, *dir_color, *dir_emission, *dir_cos;
  int n_spot, spot_samples, n_dir, dir_samples;
};

// `_spot_sample`: the shadow ray (vpl_n, d_pl) and the weight (w, rad)
__device__ __forceinline__ void spot_sample(const Lights& L, V3 point, V3 next_dir, V3 d, V3 mn,
                                            float surf_scat, float rough, float alpha_op,
                                            float refl, V3 brdf_color, float vs_pdf,
                                            float med_scatter, const float* us, V3& vpl_n,
                                            float& d_pl, V3& w, float& radiance) {
  const int n = L.n_spot;
  const int li = max(min((int)(us[0] * (float)n), n - 1), 0);
  const V3 lpos = ld3(L.spot_pos + 3 * li), ldir = ld3(L.spot_dir + 3 * li);
  const V3 lcol = ld3(L.spot_color + 3 * li);
  const float lsize = __ldg(L.spot_size + li), lemit = __ldg(L.spot_emission + li);
  const float lcos = __ldg(L.spot_cos + li);
  const V3 v_pl0 = sub(lpos, point);
  const float d_pl0 = sqrtf(clamp_min(dot(v_pl0, v_pl0), (float)1e-20));
  const float vop_dot = dot(v_pl0, next_dir);
  const float d_pq = sqrtf(clamp_min(d_pl0 * d_pl0 - vop_dot * vop_dot, (float)1e-20));
  const bool would_hit = d_pq < lsize && vop_dot > 0.0f;
  V3 vpl;
  if (would_hit) {
    const float d_oq = sqrtf(clamp_min(d_pl0 * d_pl0 - d_pq * d_pq, (float)1e-20));
    vpl = scale(next_dir, clamp_min(d_oq, (float)1e-4));
  } else {
    vpl = add(sample_disk(us[1], us[2], divs(v_pl0, d_pl0), lsize), v_pl0);
  }
  const float se = would_hit ? lemit : 0.0f;
  d_pl = sqrtf(clamp_min(dot(vpl, vpl), (float)1e-20));
  vpl_n = divs(vpl, d_pl);
  const float brdf = brdf_eval(d, mn, surf_scat, rough, alpha_op, refl, vpl_n);
  const float solid_angle = (lsize * lsize * (float)PI) / ((d_pl + 1.0f) * (d_pl + 1.0f));
  const float sctr = expf(-d_pl * med_scatter);
  const float beam = lcos < dot(neg(vpl_n), ldir) ? 1.0f : 0.0f;
  const float l_pdf = 1.0f / clamp_min(solid_angle, (float)1e-20);
  const float vsw = vs_pdf / (vs_pdf + l_pdf);
  const float lw = 1.0f - vsw;
  const float le = lemit * solid_angle * brdf;
  float rad = (le * lw + se * vsw) * sctr * beam;
  rad = rad < (float)1e-4 ? 0.0f : rad;
  radiance = brdf < (float)1e-4 ? 0.0f : rad;
  w = mul(lcol, brdf_color);
}

// `_direct_sample`
__device__ __forceinline__ void direct_sample(const Lights& L, V3 next_dir, V3 d, V3 mn,
                                              float surf_scat, float rough, float alpha_op,
                                              float refl, V3 brdf_color, float vs_pdf,
                                              const float* us, V3& vpl_n, V3& w,
                                              float& radiance) {
  const int n = L.n_dir;
  const int li = max(min((int)(us[0] * (float)n), n - 1), 0);
  const V3 ldir = ld3(L.dir_dir + 3 * li), lcol = ld3(L.dir_color + 3 * li);
  const float lemit = __ldg(L.dir_emission + li), lcos = __ldg(L.dir_cos + li);
  const V3 nl = neg(ldir);
  const bool would_hit = dot(next_dir, nl) > lcos;
  const V3 vpl = would_hit ? next_dir : sample_sphere(us[1], us[2] * 0.5f * (1.0f - lcos), nl);
  const float se = would_hit ? lemit : 0.0f;
  vpl_n = normalize(vpl);
  const float brdf = brdf_eval(d, mn, surf_scat, rough, alpha_op, refl, vpl_n);
  const float solid_angle = (float)(2.0 * PI) * (1.0f - lcos);
  const float l_pdf = 1.0f / clamp_min(solid_angle, (float)1e-20);
  const float vsw = vs_pdf / (vs_pdf + l_pdf);
  const float lw = 1.0f - vsw;
  const float le = lemit * solid_angle * brdf;
  const float rad = le * lw + se * vsw;
  radiance = rad < (float)1e-4 ? 0.0f : rad;
  w = mul(lcol, brdf_color);
}

// `_live_dist`: a light sample's shadow distance, or 0 where the sample
// weighs exactly zero whatever its visibility: a lane that hit nothing (the
// tail drops its NEE) or a radiance of exactly 0 (a NaN stays traced). A
// walk takes a ray of dist 0 as inactive (visibility 1, no vote, no test),
// and the tail's product with the radiance is the same +0.
__device__ __forceinline__ float live_dist(float dist, bool any_hit, float rad) {
  return any_hit && rad != 0.0f ? dist : 0.0f;
}

// ---------------------------------------------------------------------------
// the three kernels
// ---------------------------------------------------------------------------

struct HeadArgs {
  const int* path_depth;
  const float* near_in;
  const float* far_in;
  const int* medium;
  const float* u;
  const float* mp;
  const float* near_far;     // the camera's [2]
  float* out;                // [4, n]: near, far, far_eff, scat_dist
  bool* has_scatter;
  int* med;
  long long n;
  int ns, mp_rows, n_mat;
};

__global__ void __launch_bounds__(THREADS)
bounce_head_kernel(const HeadArgs a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const bool cam_seg = a.path_depth[i] == 0;
  const float near = cam_seg ? __ldg(a.near_far) : a.near_in[i];
  const float far = cam_seg ? __ldg(a.near_far + 1) : a.far_in[i];
  const int med = clampi(a.medium[i], 0, a.n_mat - 1);
  const float med_scatter = __ldg(a.mp + MP_W * clampi(med, 0, a.mp_rows - 1) + 8);
  const float sigma = clamp_min(med_scatter, (float)1e-20);
  const float scat_dist = -logf(a.u[i * a.ns] + (float)1e-4) / sigma;
  const bool has_scatter = med_scatter > (float)1e-4;
  a.out[i] = near;
  a.out[a.n + i] = far;
  a.out[2 * a.n + i] = has_scatter ? minimum(far, scat_dist) : far;
  a.out[3 * a.n + i] = scat_dist;
  a.has_scatter[i] = has_scatter;
  a.med[i] = med;
}

struct SurfaceArgs {
  // the state, the uniforms, the head and the walk
  const float *origin, *direction, *throughput, *score;
  const int* path_depth;
  const float* u;
  const float *far, *far_eff, *scat_dist;
  const bool* has_scatter;
  const int* med;
  const int *tid, *inst;
  // the scene
  const float* mp;
  const float* tri_pack;
  const float *inst_fwd, *inst_nrm;
  const int* slot_map;
  Maps maps;
  Lights lights;
  // outputs
  float *t_final, *point, *next_dir, *thr, *thr_next, *contrib, *metallic_tint, *score_out;
  bool* any_hit;
  int *new_medium, *new_depth;
  float *shadow_o, *shadow_d, *shadow_dist, *shadow_w, *shadow_rad;   // per sample [S, n, .]
  long long n;
  int ns, mp_rows, n_mat, tri_rows, inst_rows, slots;
};

// refine_tri (ops/intersect.py) of the ray against (v0, e1, e2)
__device__ __forceinline__ void refine_tri(V3 o, V3 d, V3 v0, V3 e1, V3 e2, float& t, float& b1,
                                           float& b2, float& det) {
  const V3 pvec = cross(d, e2);
  det = dot(e1, pvec);
  det = det + (fabsf(det) < (float)1e-7 ? 1.0f : 0.0f) * (float)1e-7;
  const float inv_det = 1.0f / det;
  const V3 tvec = sub(o, v0);
  b1 = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  b2 = dot(d, qvec) * inv_det;
  t = dot(e2, qvec) * inv_det;
}

// `_apply_fwd` of a [12] row-major 3x4 row; `_apply_nrm` of a [9] 3x3 row
__device__ __forceinline__ V3 apply_fwd(const float* a, V3 v, bool translate) {
  V3 out = {__ldg(a + 0) * v.x + __ldg(a + 1) * v.y + __ldg(a + 2) * v.z,
            __ldg(a + 4) * v.x + __ldg(a + 5) * v.y + __ldg(a + 6) * v.z,
            __ldg(a + 8) * v.x + __ldg(a + 9) * v.y + __ldg(a + 10) * v.z};
  if (translate) out = add(out, {__ldg(a + 3), __ldg(a + 7), __ldg(a + 11)});
  return out;
}

__device__ __forceinline__ V3 apply_nrm_unit(const float* a, V3 v) {
  const V3 n = {__ldg(a + 0) * v.x + __ldg(a + 1) * v.y + __ldg(a + 2) * v.z,
                __ldg(a + 3) * v.x + __ldg(a + 4) * v.y + __ldg(a + 5) * v.z,
                __ldg(a + 6) * v.x + __ldg(a + 7) * v.y + __ldg(a + 8) * v.z};
  // n / clamp(torch.linalg.norm(n), 1e-20): torch's reduction on the card
  // adds the squares as (x^2 + z^2) + y^2
  return divs(n, clamp_min(sqrtf(n.x * n.x + n.z * n.z + n.y * n.y), (float)1e-20));
}

template <bool MAPS, bool TWO_LEVEL, bool NEE>
__global__ void __launch_bounds__(THREADS)
bounce_surface_kernel(const SurfaceArgs a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const V3 o = ld3(a.origin + 3 * i), d = ld3(a.direction + 3 * i);
  const float* u = a.u + i * a.ns;
  const int med = a.med[i];
  const float* mrow = a.mp + MP_W * clampi(med, 0, a.mp_rows - 1);
  const V3 med_rgb = ld3(mrow);
  const float med_alpha = __ldg(mrow + 3), med_ior = __ldg(mrow + 7);
  const float med_scatter = __ldg(mrow + 8);
  const float sigma = clamp_min(med_scatter, (float)1e-20);
  const bool has_scatter = a.has_scatter[i];
  const float scat_dist = a.scat_dist[i];

  const int tid = a.tid[i];
  const bool hit_obj = tid >= 0;
  const bool scatter_evt = has_scatter && !hit_obj && scat_dist < a.far[i];
  const bool any_hit = hit_obj || scatter_evt;

  // the hit's row, in world space, and its refine
  V3 e1 = {0.0f, 0.0f, 0.0f}, e2 = e1, n0 = e1, n1 = e1, n2 = e1;
  float tt[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t_hit = 0.0f, b1 = 0.0f, b2 = 0.0f;
  bool external = false;
  int tri_mat_hit = 0;
  if (hit_obj) {
    const float4* row = reinterpret_cast<const float4*>(
        a.tri_pack + (long long)TP_W * min(tid, a.tri_rows - 1));
    float tp[28];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float4 q = __ldg(row + k);
      tp[4 * k] = q.x;
      tp[4 * k + 1] = q.y;
      tp[4 * k + 2] = q.z;
      tp[4 * k + 3] = q.w;
    }
    V3 v0 = {tp[0], tp[1], tp[2]};
    e1 = {tp[3], tp[4], tp[5]};
    e2 = {tp[6], tp[7], tp[8]};
    n0 = {tp[9], tp[10], tp[11]};
    n1 = {tp[12], tp[13], tp[14]};
    n2 = {tp[15], tp[16], tp[17]};
    const int slot = (int)rintf(tp[24]);
    if (TWO_LEVEL) {
      const int ii = clampi(a.inst[i], 0, a.inst_rows - 1);
      const float* fwd = a.inst_fwd + 12 * ii;
      const float* nrm = a.inst_nrm + 9 * ii;
      v0 = apply_fwd(fwd, v0, true);
      e1 = apply_fwd(fwd, e1, false);
      e2 = apply_fwd(fwd, e2, false);
      n0 = apply_nrm_unit(nrm, n0);
      n1 = apply_nrm_unit(nrm, n1);
      n2 = apply_nrm_unit(nrm, n2);
      long long flat = (long long)max(a.inst[i], 0) * a.slots + slot;
      const long long top = (long long)a.inst_rows * a.slots - 1;
      flat = flat < 0 ? 0 : (flat > top ? top : flat);
      tri_mat_hit = __ldg(a.slot_map + flat);
    } else {
      tri_mat_hit = slot;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) tt[k] = tp[18 + k];
    float det;
    refine_tri(o, d, v0, e1, e2, t_hit, b1, b2, det);
    external = det > 0.0f;
  }
  const float t_final = hit_obj ? t_hit : (scatter_evt ? scat_dist : a.far_eff[i]);
  const float logp = scatter_evt ? logf(sigma) - sigma * t_final
                                 : (has_scatter ? -sigma * t_final : 0.0f);
  const float score = a.score[i] + logp;

  const int surf_mat = hit_obj ? tri_mat_hit : (scatter_evt ? med : 0);
  const int behind_mat = (hit_obj && external) ? surf_mat : (scatter_evt ? med : 0);

  // surface frame
  const float b0 = 1.0f - b1 - b2;
  float tu = 0.0f, tv = 0.0f;
  if (MAPS) {
    if (hit_obj) {
      tu = tt[0] * b0 + tt[2] * b1 + tt[4] * b2;
      tv = tt[1] * b0 + tt[3] * b1 + tt[5] * b2;
    } else if (!scatter_evt) {
      sky_texcrd(d, tu, tv);
    }
  }
  const Mat mat = material_fetch<MAPS>(a.mp, a.mp_rows, a.n_mat, a.maps, surf_mat, tu, tv);

  V3 normal = d, mapped_normal = d;
  if (hit_obj) {
    const float ext_f = external ? 1.0f : -1.0f;
    normal = scale(normalize(cross(e1, e2)), ext_f);
    V3 mapped = normalize(add(add(scale(n0, b0), scale(n1, b1)), scale(n2, b2)));
    if (MAPS && mat.normal_map >= 0) {
      // normal mapping (reference Triangle::mapNormal), the uv
      // determinant floored at 1e-12
      const float4 nm = fetch<true>(a.maps, mat.normal_map, tu, tv);
      const float du1 = tt[2] - tt[0], dv1 = tt[3] - tt[1];
      const float du2 = tt[4] - tt[0], dv2 = tt[5] - tt[1];
      const float det_uv = du1 * dv2 - du2 * dv1;
      const float f = 1.0f / (fabsf(det_uv) < (float)1e-12 ? (float)1e-12 : det_uv);
      V3 tangent = normalize(scale(sub(scale(e1, dv2), scale(e2, dv1)), f));
      tangent = normalize(sub(tangent, scale(mapped, dot(tangent, mapped))));
      const V3 bitangent = cross(tangent, mapped);
      const V3 mn = {nm.x * 2.0f - 1.0f, nm.y * 2.0f - 1.0f, nm.z * 2.0f - 1.0f};
      mapped = normalize(add(add(scale(mapped, mn.z), scale(tangent, mn.x)),
                             scale(bitangent, mn.y)));
    }
    mapped_normal = scale(mapped, ext_f);
  }

  // Beer's law, base floored at 1e-6
  const float beer = powf(clamp_min(1.0f - med_alpha, (float)1e-6), t_final);
  const V3 thr = scale(mul(ld3(a.throughput + 3 * i), med_rgb), beer);
  const V3 contrib = mat.emis > 0.0f ? scale(mul(thr, mat.rgb), mat.emis) : V3{0.0f, 0.0f, 0.0f};
  const int new_depth = any_hit ? a.path_depth[i] + 1 : PATH_LIMIT;

  // fresnel / reflectance
  const float n2_ior = __ldg(a.mp + MP_W * clampi(clampi(behind_mat, 0, a.n_mat - 1), 0,
                                                   a.mp_rows - 1) + 7);
  float fresnel, refr_ratio, refr_b;
  fresnel_specular_ratio(mapped_normal, d, med_ior, n2_ior, fresnel, refr_ratio, refr_b);
  const float reflectance = lerp(fresnel, 1.0f, mat.metal);

  // `sample_direction`: the branch the plain version selects
  const float u1 = u[1], u2 = u[2], u3 = u[3];
  const bool is_trans = mat.alpha_op > 0.0f;
  const bool is_scat = is_trans && mat.scat > 0.0f;
  const bool take_refr = fresnel < u3;
  const bool is_diffuse = !is_trans && u3 > reflectance;
  V3 dir;
  float tint;
  if (is_scat) {
    dir = sample_sphere(u1, u2, d);
    tint = mat.metal;
  } else if (is_trans) {
    dir = take_refr ? add(scale(d, refr_ratio), scale(mapped_normal, refr_b))
                    : flip_above(reflect(d, mapped_normal), normal);
    tint = take_refr ? 1.0f : mat.metal;
  } else if (is_diffuse) {
    dir = flip_above(cosine_sample_hemisphere(u1, u2, mapped_normal), normal);
    tint = 1.0f;
  } else {
    const V3 vh = sample_sphere(u1, (1.0f - powf(u2 + (float)1e-5, mat.rough)) * 0.5f,
                                mapped_normal);
    dir = flip_above(reflect(d, vh), normal);
    tint = mat.metal;
  }
  const bool refracted = is_trans && !is_scat && take_refr;
  const V3 next_dir = normalize(dir);

  // hit point with its normal nudge, flipped when refracting
  const V3 nudge_n = refracted ? neg(normal) : normal;
  const V3 point = add(add(o, scale(d, t_final)), scale(nudge_n, (float)1e-4 * t_final));

  if (NEE) {
    const V3 point_nee = any_hit ? point : V3{0.0f, 0.0f, 0.0f};
    const float vs_pdf = brdf_eval(d, mapped_normal, mat.scat, mat.rough, mat.alpha_op,
                                   reflectance, next_dir);
    const V3 brdf_color = lerp3(mat.rgb, {1.0f, 1.0f, 1.0f}, reflectance);
    st3(a.shadow_o + 3 * i, point_nee);
    const Lights& L = a.lights;
    int k = 0;
    for (int s = 0; s < L.spot_samples; ++s, ++k) {
      V3 vpl_n, w;
      float d_pl, rad;
      spot_sample(L, point_nee, next_dir, d, mapped_normal, mat.scat, mat.rough, mat.alpha_op,
                  reflectance, brdf_color, vs_pdf, med_scatter, u + 8 + 3 * s, vpl_n, d_pl, w,
                  rad);
      st3(a.shadow_d + 3 * (k * a.n + i), vpl_n);
      a.shadow_dist[k * a.n + i] = live_dist(d_pl, any_hit, rad);
      st3(a.shadow_w + 3 * (k * a.n + i), w);
      a.shadow_rad[k * a.n + i] = rad;
    }
    const float* ud = u + 8 + 3 * L.spot_samples;
    for (int s = 0; s < L.dir_samples; ++s, ++k) {
      V3 vpl_n, w;
      float rad;
      direct_sample(L, next_dir, d, mapped_normal, mat.scat, mat.rough, mat.alpha_op,
                    reflectance, brdf_color, vs_pdf, ud + 3 * s, vpl_n, w, rad);
      st3(a.shadow_d + 3 * (k * a.n + i), vpl_n);
      a.shadow_dist[k * a.n + i] = live_dist(BIG, any_hit, rad);
      st3(a.shadow_w + 3 * (k * a.n + i), w);
      a.shadow_rad[k * a.n + i] = rad;
    }
    st3(a.metallic_tint + 3 * i, lerp3({1.0f, 1.0f, 1.0f}, mat.rgb, mat.metal));
  }

  a.t_final[i] = t_final;
  a.any_hit[i] = any_hit;
  st3(a.point + 3 * i, point);
  st3(a.next_dir + 3 * i, next_dir);
  st3(a.thr + 3 * i, thr);
  st3(a.thr_next + 3 * i, lerp3(thr, mul(thr, mat.rgb), tint));
  st3(a.contrib + 3 * i, contrib);
  a.new_medium[i] = refracted ? behind_mat : med;
  a.new_depth[i] = new_depth;
  a.score_out[i] = score;
}

struct TailArgs {
  // the state in
  const float *accum, *depth_buf, *space_buf, *origin, *direction;
  const int* path_depth;
  const float* u;
  // the surface
  const float *t_final, *point, *next_dir, *thr, *thr_next, *contrib, *metallic_tint, *score;
  const bool* any_hit;
  const int *new_medium, *new_depth;
  const float *shadow_w, *shadow_rad;   // [S, n, 3], [S, n]
  const float *vis_rgb, *vis_a;         // [S, n, 3], [S, n]
  Camera cam;
  // the state out
  float *accum_out, *depth_out, *space_out, *origin_out, *direction_out, *thr_out;
  int *medium_out, *depth_idx_out;
  float *near_out, *far_out, *score_out;
  long long n;
  int ns, width, row0, max_depth;
  bool nee;                  // the scene has lights
  int n_spot, spot_samples, n_dir, dir_samples;
};

__global__ void __launch_bounds__(THREADS)
bounce_tail_kernel(const TailArgs a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  V3 contrib = ld3(a.contrib + 3 * i);
  if (a.nee) {
    V3 direct = {0.0f, 0.0f, 0.0f};
    int k = 0;
    for (int kind = 0; kind < 2; ++kind) {
      const int n_lights = kind == 0 ? a.n_spot : a.n_dir;
      const int n_samples = kind == 0 ? a.spot_samples : a.dir_samples;
      if (n_lights == 0) continue;
      V3 total = {0.0f, 0.0f, 0.0f};
      for (int s = 0; s < n_samples; ++s, ++k) {
        const long long j = k * a.n + i;
        const float va = a.vis_a[j];
        const float ra = a.shadow_rad[j] * va;
        total = add(total, mul(scale(ld3(a.shadow_w + 3 * j), ra), ld3(a.vis_rgb + 3 * j)));
      }
      // total / pdf, pdf a Python float: times its float reciprocal
      const float pdf = (float)((double)n_samples / (double)n_lights);
      direct = add(direct, scale(total, 1.0f / pdf));
    }
    const V3 nee = mul(mul(direct, ld3(a.thr + 3 * i)), ld3(a.metallic_tint + 3 * i));
    contrib = add(contrib, a.any_hit[i] ? nee : V3{0.0f, 0.0f, 0.0f});
  }
  const int new_depth = a.new_depth[i];
  const bool terminated = !(new_depth < a.max_depth);
  const float4 acc = __ldg(reinterpret_cast<const float4*>(a.accum) + i);
  reinterpret_cast<float4*>(a.accum_out)[i] =
      make_float4(acc.x + contrib.x, acc.y + contrib.y, acc.z + contrib.z,
                  acc.w + (terminated ? 1.0f : 0.0f));

  const V3 o = ld3(a.origin + 3 * i), d = ld3(a.direction + 3 * i);
  const float t_final = a.t_final[i];
  if (a.path_depth[i] == 0) {
    a.depth_out[i] = t_final;
    st3(a.space_out + 3 * i, add(o, scale(d, t_final)));
  } else {
    a.depth_out[i] = a.depth_buf[i];
    st3(a.space_out + 3 * i, ld3(a.space_buf + 3 * i));
  }

  if (terminated) {
    const float px = (float)(i % a.width);
    const float py = (float)(i / a.width) + (float)a.row0;
    const float* u = a.u + i * a.ns + 4;
    const float uu[4] = {u[0], u[1], u[2], u[3]};
    V3 cam_o, cam_d;
    generate_ray(a.cam, px, py, uu, cam_o, cam_d);
    st3(a.origin_out + 3 * i, cam_o);
    st3(a.direction_out + 3 * i, cam_d);
    st3(a.thr_out + 3 * i, {1.0f, 1.0f, 1.0f});
    a.medium_out[i] = 0;
    a.depth_idx_out[i] = 0;
    a.near_out[i] = __ldg(a.cam.near_far);
    a.far_out[i] = __ldg(a.cam.near_far + 1);
    a.score_out[i] = 0.0f;
  } else {
    st3(a.origin_out + 3 * i, ld3(a.point + 3 * i));
    st3(a.direction_out + 3 * i, ld3(a.next_dir + 3 * i));
    st3(a.thr_out + 3 * i, ld3(a.thr_next + 3 * i));
    a.medium_out[i] = a.new_medium[i];
    a.depth_idx_out[i] = new_depth;
    a.near_out[i] = 0.0f;
    a.far_out[i] = BIG;
    a.score_out[i] = a.score[i];
  }
}

int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

// The wrappers (ops/bounce.py) pass the arguments as two arrays in a fixed
// order: `p`, the tensors' data pointers (null where the scene has no such
// table or the bounce no such output), and `v`, the integers; `np` and `nv`
// are their lengths, checked against what each entry reads.
struct Reader {
  void* const* p;
  const long long* v;
  int ip = 0, iv = 0;
  template <typename T>
  T* ptr() { return static_cast<T*>(p[ip++]); }
  int i32() { return (int)v[iv++]; }
  long long i64() { return v[iv++]; }
};

constexpr int BAD_ARGS = (int)cudaErrorInvalidValue;

template <bool MAPS, bool TWO_LEVEL, bool NEE>
void launch_surface(const SurfaceArgs& a, cudaStream_t s) {
  bounce_surface_kernel<MAPS, TWO_LEVEL, NEE><<<blocks(a.n), THREADS, 0, s>>>(a);
}

}  // namespace

extern "C" int rz_bounce_head(void* const* p, int np, const long long* v, int nv, void* stream) {
  if (np != 10 || nv != 4) return BAD_ARGS;
  Reader r{p, v};
  HeadArgs a;
  a.path_depth = r.ptr<const int>();
  a.near_in = r.ptr<const float>();
  a.far_in = r.ptr<const float>();
  a.medium = r.ptr<const int>();
  a.u = r.ptr<const float>();
  a.mp = r.ptr<const float>();
  a.near_far = r.ptr<const float>();
  a.out = r.ptr<float>();
  a.has_scatter = r.ptr<bool>();
  a.med = r.ptr<int>();
  a.n = r.i64();
  a.ns = r.i32();
  a.mp_rows = r.i32();
  a.n_mat = r.i32();
  if (a.n <= 0) return 0;
  bounce_head_kernel<<<blocks(a.n), THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int rz_bounce_surface(void* const* p, int np, const long long* v, int nv,
                                 void* stream) {
  if (np != 51 || nv != 20) return BAD_ARGS;
  Reader r{p, v};
  SurfaceArgs a;
  a.origin = r.ptr<const float>();
  a.direction = r.ptr<const float>();
  a.throughput = r.ptr<const float>();
  a.score = r.ptr<const float>();
  a.path_depth = r.ptr<const int>();
  a.u = r.ptr<const float>();
  a.far = r.ptr<const float>();
  a.far_eff = r.ptr<const float>();
  a.scat_dist = r.ptr<const float>();
  a.has_scatter = r.ptr<const bool>();
  a.med = r.ptr<const int>();
  a.tid = r.ptr<const int>();
  a.inst = r.ptr<const int>();
  a.mp = r.ptr<const float>();
  a.tri_pack = r.ptr<const float>();
  a.inst_fwd = r.ptr<const float>();
  a.inst_nrm = r.ptr<const float>();
  a.slot_map = r.ptr<const int>();
  a.maps.color = r.ptr<const float>();
  a.maps.scalar = r.ptr<const float>();
  a.maps.col_blk = r.ptr<const int>();
  a.maps.sc_blk = r.ptr<const int>();
  a.maps.rect = r.ptr<const int>();
  a.maps.flags = r.ptr<const int>();
  a.maps.uv = r.ptr<const float>();
  a.lights.spot_pos = r.ptr<const float>();
  a.lights.spot_dir = r.ptr<const float>();
  a.lights.spot_color = r.ptr<const float>();
  a.lights.spot_size = r.ptr<const float>();
  a.lights.spot_emission = r.ptr<const float>();
  a.lights.spot_cos = r.ptr<const float>();
  a.lights.dir_dir = r.ptr<const float>();
  a.lights.dir_color = r.ptr<const float>();
  a.lights.dir_emission = r.ptr<const float>();
  a.lights.dir_cos = r.ptr<const float>();
  a.t_final = r.ptr<float>();
  a.point = r.ptr<float>();
  a.next_dir = r.ptr<float>();
  a.thr = r.ptr<float>();
  a.thr_next = r.ptr<float>();
  a.contrib = r.ptr<float>();
  a.metallic_tint = r.ptr<float>();
  a.score_out = r.ptr<float>();
  a.any_hit = r.ptr<bool>();
  a.new_medium = r.ptr<int>();
  a.new_depth = r.ptr<int>();
  a.shadow_o = r.ptr<float>();
  a.shadow_d = r.ptr<float>();
  a.shadow_dist = r.ptr<float>();
  a.shadow_w = r.ptr<float>();
  a.shadow_rad = r.ptr<float>();
  a.n = r.i64();
  a.ns = r.i32();
  a.mp_rows = r.i32();
  a.n_mat = r.i32();
  a.tri_rows = r.i32();
  a.inst_rows = r.i32();
  a.slots = r.i32();
  const bool two_level = r.i32() != 0;
  const bool maps = r.i32() != 0;
  const bool nee = r.i32() != 0;
  a.maps.used = r.i32();
  a.maps.n_maps = r.i32();
  a.maps.wc = r.i32();
  a.maps.n_col = r.i32();
  a.maps.ws = r.i32();
  a.maps.n_sc = r.i32();
  a.lights.n_spot = r.i32();
  a.lights.spot_samples = r.i32();
  a.lights.n_dir = r.i32();
  a.lights.dir_samples = r.i32();
  if (a.n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int variant = (maps ? 4 : 0) | (two_level ? 2 : 0) | (nee ? 1 : 0);
  switch (variant) {
    case 0: launch_surface<false, false, false>(a, s); break;
    case 1: launch_surface<false, false, true>(a, s); break;
    case 2: launch_surface<false, true, false>(a, s); break;
    case 3: launch_surface<false, true, true>(a, s); break;
    case 4: launch_surface<true, false, false>(a, s); break;
    case 5: launch_surface<true, false, true>(a, s); break;
    case 6: launch_surface<true, true, false>(a, s); break;
    default: launch_surface<true, true, true>(a, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int rz_bounce_tail(void* const* p, int np, const long long* v, int nv, void* stream) {
  if (np != 39 || nv != 12) return BAD_ARGS;
  Reader r{p, v};
  TailArgs a;
  a.accum = r.ptr<const float>();
  a.depth_buf = r.ptr<const float>();
  a.space_buf = r.ptr<const float>();
  a.origin = r.ptr<const float>();
  a.direction = r.ptr<const float>();
  a.path_depth = r.ptr<const int>();
  a.u = r.ptr<const float>();
  a.t_final = r.ptr<const float>();
  a.point = r.ptr<const float>();
  a.next_dir = r.ptr<const float>();
  a.thr = r.ptr<const float>();
  a.thr_next = r.ptr<const float>();
  a.contrib = r.ptr<const float>();
  a.metallic_tint = r.ptr<const float>();
  a.score = r.ptr<const float>();
  a.any_hit = r.ptr<const bool>();
  a.new_medium = r.ptr<const int>();
  a.new_depth = r.ptr<const int>();
  a.shadow_w = r.ptr<const float>();
  a.shadow_rad = r.ptr<const float>();
  a.vis_rgb = r.ptr<const float>();
  a.vis_a = r.ptr<const float>();
  a.cam.position = r.ptr<const float>();
  a.cam.rot = r.ptr<const float>();
  a.cam.fov = r.ptr<const float>();
  a.cam.near_far = r.ptr<const float>();
  a.cam.focal_distance = r.ptr<const float>();
  a.cam.aperture = r.ptr<const float>();
  a.accum_out = r.ptr<float>();
  a.depth_out = r.ptr<float>();
  a.space_out = r.ptr<float>();
  a.origin_out = r.ptr<float>();
  a.direction_out = r.ptr<float>();
  a.thr_out = r.ptr<float>();
  a.medium_out = r.ptr<int>();
  a.depth_idx_out = r.ptr<int>();
  a.near_out = r.ptr<float>();
  a.far_out = r.ptr<float>();
  a.score_out = r.ptr<float>();
  a.n = r.i64();
  a.ns = r.i32();
  a.width = r.i32();
  a.row0 = r.i32();
  a.max_depth = r.i32();
  a.cam.width = r.i32();
  a.cam.height = r.i32();
  a.nee = r.i32() != 0;
  a.n_spot = r.i32();
  a.spot_samples = r.i32();
  a.n_dir = r.i32();
  a.dir_samples = r.i32();
  if (a.n <= 0) return 0;
  bounce_tail_kernel<<<blocks(a.n), THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
