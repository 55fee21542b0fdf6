// Device functions shared by the gathers, K1, K5, K6, K7
// (patch_gather.cu) and K9 (patch_prefetch.cu), which must equal K1 bit
// for bit and therefore runs K1's own arithmetic on its staged copies,
// and by the NCC scorer K4 (ncc3.cu), whose patch pixels are K5's.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace icgn {

constexpr float kFar = 1073741824.0f;  // 2^30, image/taps.py::_FAR

// A start moved inside [0, extent - size], as image/taps.py::clamp_to_fit
// moves it (the dynamic_slice rule).
__device__ __forceinline__ int clamp_start(int s, int size, int extent) {
  return min(max(s, 0), extent - size);
}

// halo[a][b] = img[r0 - 1 + a][c0 - 1 + b] for the (psz+3)^2 halo of the
// support at (r0, c0); reads are clamped into the plane, and a clamped
// read only ever feeds a masked-out difference.
__device__ __forceinline__ void load_halo(const float* __restrict__ img, int Hp,
                                          int Wp, int r0, int c0, int psz,
                                          float* halo, int lane) {
  const int hs = psz + 3;
  for (int k = lane; k < hs * hs; k += 32) {
    const int a = k / hs, b = k - a * hs;
    const int y = min(max(r0 - 1 + a, 0), Hp - 1);
    const int x = min(max(c0 - 1 + b, 0), Wp - 1);
    halo[k] = img[(size_t)y * Wp + x];
  }
  __syncwarp();
}

// The patch and its two gradient patches from a staged halo.
__device__ __forceinline__ void patch_grad_from_halo(
    const float* halo, int Hp, int Wp, int r0, int c0, int psz, int pad,
    float4 w, float* __restrict__ p_img, float* __restrict__ p_dx,
    float* __restrict__ p_dy, int lane) {
  const int hs = psz + 3;
  for (int p = lane; p < psz * psz; p += 32) {
    const int i = p / psz, j = p - i * psz;
    float ti[4], tx[4], ty[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // taps in weight order: (1,1), (1,0), (0,1), (0,0)
      const int a = i + ((t < 2) ? 1 : 0);
      const int b = j + ((t & 1) ? 0 : 1);
      const int y = r0 + a, x = c0 + b;  // plane coords
      const float* h = halo + (a + 1) * hs + (b + 1);
      ti[t] = h[0];
      const bool mdx = (y >= pad) && (y <= Hp - pad - 1) &&
                       (x >= pad + 1) && (x <= Wp - pad - 2);
      const bool mdy = (y >= pad + 1) && (y <= Hp - pad - 2) &&
                       (x >= pad) && (x <= Wp - pad - 1);
      tx[t] = mdx ? __fsub_rn(h[1], h[-1]) : 0.0f;
      ty[t] = mdy ? __fsub_rn(h[hs], h[-hs]) : 0.0f;
    }
    p_img[p] = tap(w, ti[0], ti[1], ti[2], ti[3]);
    p_dx[p] = tap(w, tx[0], tx[1], tx[2], tx[3]);
    p_dy[p] = tap(w, ty[0], ty[1], ty[2], ty[3]);
  }
}

// dst[a][b] = src[a][b] for a (wh, ww) window; src rows are Wp apart.
__device__ __forceinline__ void copy_window(const float* __restrict__ src,
                                            int Wp, int wh, int ww,
                                            float* __restrict__ dst, int lane) {
  for (int k = lane; k < wh * ww; k += 32) {
    const int a = k / ww, b = k - a * ww;
    dst[k] = src[(size_t)a * Wp + b];
  }
}

// The plane that point m reads in a contiguous (P, Hp, Wp) stack whose M
// points fall in P equal consecutive groups of `per` = M / P: plane
// m / per (P = 1: the one plane).  The counterpart of jax.vmap over the
// TPU kernels, each stream gathering from its own planes.
__device__ __forceinline__ const float* plane_of(const float* planes, int m,
                                                 int per, int Hp, int Wp) {
  return planes + (size_t)(m / per) * Hp * Wp;
}

// Points per plane of a stack of P planes, or -1 where M is not P equal
// groups (the launchers then refuse the call).
inline int points_per_plane(int M, int P) {
  if (P < 1 || M % P != 0) return -1;
  return M / P > 0 ? M / P : 1;
}

inline int blocks_for(int M) { return (M + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// blocks of kWarpsPerBlock warps for M points at 32/lanes points per warp
inline int group_blocks_for(int M, int lanes) {
  const int per_block = kWarpsPerBlock * (32 / lanes);
  return (M + per_block - 1) / per_block;
}

// f(std::integral_constant<int, psz>{}) where psz is one of Sides; false
// for any other psz
template <int... Sides, class F>
bool with_side(int psz, F&& f) {
  return ((psz == Sides && (f(std::integral_constant<int, Sides>{}), true)) || ...);
}

// A support start from one centre coordinate, as image/taps.py's
// bilinear_base and clamp_to_fit take it: ceil(v + 1e-5), clamped to
// +-2^30 in float before the conversion to int, minus psz/2 + 1, plus
// the padding, then moved inside [0, extent - (psz+1)].  A NaN centre
// takes 0 (the card's conversion of a NaN) and so a start inside the
// plane; its NaN weights make the point's output NaN.
__device__ __forceinline__ int support_start(float v, int psz, int pad,
                                             int extent) {
  float f = ceilf(__fadd_rn(v, 1e-5f));
  f = (f != f) ? 0.0f : fminf(fmaxf(f, -kFar), kFar);
  return clamp_start((int)f - psz / 2 - 1 + pad, psz + 1, extent);
}

// The 4 weights of a centre (x, y), as bilinear_base forms them:
// (rx ry, (1-rx) ry, rx (1-ry), (1-rx)(1-ry)) with rx = x - floor(x).
__device__ __forceinline__ float4 bilinear_weights(float x, float y) {
  const float rx = __fsub_rn(x, floorf(x)), ry = __fsub_rn(y, floorf(y));
  const float gx = __fsub_rn(1.0f, rx), gy = __fsub_rn(1.0f, ry);
  return make_float4(__fmul_rn(rx, ry), __fmul_rn(gx, ry), __fmul_rn(rx, gy),
                     __fmul_rn(gx, gy));
}

// K1's and K9's indices of one point from its centre (x, y) and its
// window origin (row, col): (support row, support col, window row, window
// col), each moved inside the plane as image/taps.py::clamp_to_fit moves
// it.
__device__ __forceinline__ int4 dual_index(float2 c, int2 o, int Hp, int Wp,
                                           int pad) {
  return make_int4(support_start(c.y, kPsz, pad, Hp),
                   support_start(c.x, kPsz, pad, Wp),
                   clamp_start(o.x, kWin, Hp), clamp_start(o.y, kWin, Wp));
}

}  // namespace icgn
