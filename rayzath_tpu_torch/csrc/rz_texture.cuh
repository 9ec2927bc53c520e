// The texture fetch of ops/texture.py `fetch` on the packed atlases, shared
// by the bounce's surface kernel (bounce.cu: every map kind at a hit) and
// B2's cutout variant (cluster_shadow.cu: the colour map's texel at each
// hit of a cutout slot), so that both read a texel with the same
// arithmetic, op for op as the plain version on the card (-fmad=false).
#pragma once

#include <cmath>

#include <cuda_runtime.h>

namespace {

// torch.clamp: a NaN stays
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// torch.remainder: fmod moved to the divisor's sign
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

struct Maps {
  const float* color;        // [Hc*Wc, 4]
  const float* scalar;       // [Hs*Ws]
  const int* col_blk;        // [Hc*Wc, 4]
  const int* sc_blk;         // [Hs*Ws, 4]
  const int* rect;           // [K, 4]: y0, x0, h, w
  const int* flags;          // [K, 3]: filter, address, atlas
  const float* uv;           // [K, 5]: sx, sy, rotation, tx, ty
  int n_maps, wc, n_col, ws, n_sc;
  int used;                  // bit k: a material references map kind k
};

__device__ __forceinline__ void apply_address(float x, int mode, float& coord, bool& border) {
  const float top = (float)(1.0 - 1e-6);
  if (mode == 0) {
    coord = remainder(x, 1.0f);
  } else if (mode == 2) {
    const float period = remainder(x, 2.0f);
    coord = clamp(period > 1.0f ? 2.0f - period : period, 0.0f, top);
  } else {
    coord = clamp(x, 0.0f, top);
  }
  border = mode == 3 && (x < 0.0f || x >= 1.0f);
}

// the map `map_id` at (tu, tv): RGBA from the color atlas, or the scalar
// in .x; the caller passes map_id >= 0
template <bool COLOR>
__device__ float4 fetch(const Maps& m, int map_id, float tu, float tv) {
  const int mid = clampi(map_id, 0, m.n_maps - 1);
  const float* prm = m.uv + 5 * mid;
  const float u0 = tu + __ldg(prm + 3), v0 = tv + __ldg(prm + 4);
  const float rot = __ldg(prm + 2);
  const float c = cosf(rot), s = sinf(rot);
  const float u = (u0 * c - v0 * s) * __ldg(prm + 0);
  const float v = (u0 * s + v0 * c) * __ldg(prm + 1);
  const int filt = __ldg(m.flags + 3 * mid), addr = __ldg(m.flags + 3 * mid + 1);
  const long long y0 = __ldg(m.rect + 4 * mid), x0 = __ldg(m.rect + 4 * mid + 1);
  const long long h = __ldg(m.rect + 4 * mid + 2), w = __ldg(m.rect + 4 * mid + 3);
  float un, vn;
  bool ub, vb;
  apply_address(u, addr, un, ub);
  apply_address(v, addr, vn, vb);
  vn = 1.0f - vn;
  const float fx = un * (float)w - 0.5f;
  const float fy = vn * (float)h - 0.5f;
  const float x_lo = floorf(fx), y_lo = floorf(fy);
  const float ax = x_lo < 0.0f ? 0.0f : fx - x_lo;
  const float ay = y_lo < 0.0f ? 0.0f : fy - y_lo;
  const long long xl = (long long)x_lo, yl = (long long)y_lo;
  const long long xc = min(xl > 0 ? xl : 0LL, w - 1) + x0;
  const long long yc = min(yl > 0 ? yl : 0LL, h - 1) + y0;
  const int n = COLOR ? m.n_col : m.n_sc;
  long long cell = yc * (COLOR ? m.wc : m.ws) + xc;
  cell = cell < 0 ? 0 : (cell > n - 1 ? n - 1 : cell);
  const int4 corners = __ldg(reinterpret_cast<const int4*>(COLOR ? m.col_blk : m.sc_blk) + cell);
  float4 out;
  if (ub || vb) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int c00 = clampi(corners.x, 0, n - 1), c10 = clampi(corners.y, 0, n - 1);
  const int c01 = clampi(corners.z, 0, n - 1), c11 = clampi(corners.w, 0, n - 1);
  if (COLOR) {
    const float4* t = reinterpret_cast<const float4*>(m.color);
    const float4 v00 = __ldg(t + c00), v10 = __ldg(t + c10);
    const float4 v01 = __ldg(t + c01), v11 = __ldg(t + c11);
    if (filt == 0) {
      const bool sx = ax >= 0.5f, sy = ay >= 0.5f;
      return sy ? (sx ? v11 : v01) : (sx ? v10 : v00);
    }
    const float bx = 1.0f - ax, by = 1.0f - ay;
    out.x = (v00.x * bx + v10.x * ax) * by + (v01.x * bx + v11.x * ax) * ay;
    out.y = (v00.y * bx + v10.y * ax) * by + (v01.y * bx + v11.y * ax) * ay;
    out.z = (v00.z * bx + v10.z * ax) * by + (v01.z * bx + v11.z * ax) * ay;
    out.w = (v00.w * bx + v10.w * ax) * by + (v01.w * bx + v11.w * ax) * ay;
    return out;
  }
  const float v00 = __ldg(m.scalar + c00), v10 = __ldg(m.scalar + c10);
  const float v01 = __ldg(m.scalar + c01), v11 = __ldg(m.scalar + c11);
  float r;
  if (filt == 0) {
    const bool sx = ax >= 0.5f, sy = ay >= 0.5f;
    r = sy ? (sx ? v11 : v01) : (sx ? v10 : v00);
  } else {
    const float bx = 1.0f - ax, by = 1.0f - ay;
    r = (v00 * bx + v10 * ax) * by + (v01 * bx + v11 * ax) * ay;
  }
  return make_float4(r, r, r, r);
}

}  // namespace
