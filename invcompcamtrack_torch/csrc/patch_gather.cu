// K1, K5, K6, K7: the tracker's gathers.
//
// K1 replaces invcompcamtrack_tpu/ops/patch_pallas.py::gather_ref_grad_and_windows
// (body _kernel_grad_window): per point the 8x8 reference patch, its two
// gradient patches and the 16x16 integer-origin window of the query image
// that the GN iterations resample from (K2).
// K5 replaces ::gather_patches (body _kernel_single): the psz x psz
// bilinear patch, for any even psz.
// K6 replaces ::gather_patches_grad (body _kernel_grad_fused): K1 without
// the window, for any even psz <= 16 (no caller goes beyond).
// K7 replaces ::gather_windows (body _kernel_windows): the (wh, ww) window
// at an integer origin.
//
// Inputs:
//   planes        padded level planes (Hp, Wp) f32
//   K1, K7: idx   int32 support (and window) row/col per point, prepared
//                 by ops/patch_gather.py with the plain versions' code and
//                 already moved inside the plane (dynamic_slice rule);
//                 K1's wts (M, 4) f32, the 4 constant bilinear weights
//   K5, K6: centers (M, 2) f32 (x, y), unpadded: each point's support
//                 start and weights are computed here, operation for
//                 operation as image/taps.py computes them
//                 (support_start, bilinear_weights in patch_gather.cuh)
// Outputs: patches (M, psz*psz), windows (M, wh*ww), all f32.
//
// The gradients are not gathered from the pyramid's dx/dy planes but
// computed here from a 1-px halo around the support: those planes are
// central differences of the image, zero on the reflect-101 border
// columns/rows and in the pad band, so the masked difference of the
// image window is the same subtraction of the same floats (the masks of
// _kernel_grad_window).  One plane read per point instead of three.
//
// K1 and K7 on an H100: bytes written.  K1 writes 448 floats per point
// (46 MB at 25,600 points), K7 wh*ww; the reads come from a level plane
// that stays in the 50 MB L2 (the padded 1296x736 level 0 is 3.8 MB).
// Design: one warp per point, eight points per block; K1 stages its halo
// in shared memory, then each lane computes every 32nd output pixel and
// writes it with coalesced stores; windows are copied 32 floats per
// instruction.
//
// K5 and K6 write only psz^2 and 3 psz^2 floats per point, so a fixed
// cost per point bounded their first design (one warp per point as K1):
// a dependent chain of index load, staged copy with an integer division
// per element, __syncwarp and taps with another division, paid by each
// of three waves of warps, behind some 30 torch ops that made the indices
// and weights before the launch.  Now a call is one launch.  A group of
// psz lanes serves one point, so a warp has 32/psz points in flight (4 at
// psz 8, 8 at psz 4); each lane loads the centre, computes the start and
// the weights, reads its support columns through the read-only path and
// writes one output column.  psz is a template parameter (every even side
// up to 16; for K5 also the descriptors' 18 and the flow benchmark's 32,
// one point per warp): the loops unroll into registers, with no division,
// no shared memory, no barrier, and every load of a point issued before
// the first use.  Lanes own columns, not rows: then one load instruction
// of the warp touches one row of each of its 32/psz points, where a row
// per lane would touch 32 rows.  K5 at any other side takes one warp per
// point and a side given at run time.
//
// No per-point VMEM plan, lane alignment or two-phase plane copies of the
// TPU kernels have a counterpart here.
#include <cstdint>
#include <type_traits>

#include "patch_gather.cuh"

namespace icgn {

// ------------------------------------------------------------------ K1
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_ref_grad_windows_kernel(const float* __restrict__ rimg,
                               const float* __restrict__ qimg, int Hp, int Wp,
                               const int4* __restrict__ idx,
                               const float4* __restrict__ wts,
                               float* __restrict__ p_img,
                               float* __restrict__ p_dx,
                               float* __restrict__ p_dy,
                               float* __restrict__ qwin, int M, int pad) {
  __shared__ float halo_all[kWarpsPerBlock][(kPsz + 3) * (kPsz + 3)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;  // warps are independent: no block barrier below

  const int4 id = idx[m];  // (support row, support col, window row, col)
  float* halo = halo_all[warp];
  load_halo(rimg, Hp, Wp, id.x, id.y, kPsz, halo, lane);
  const size_t out0 = (size_t)m * kNpix;
  patch_grad_from_halo(halo, Hp, Wp, id.x, id.y, kPsz, pad, wts[m],
                       p_img + out0, p_dx + out0, p_dy + out0, lane);
  copy_window(qimg + (size_t)id.z * Wp + id.w, Wp, kWin, kWin,
              qwin + (size_t)m * (kWin * kWin), lane);
}

// ------------------------------------------------------------------ K6
// One group of PSZ lanes per point, 32/PSZ points per warp; lane j of a
// group owns output column j.  Plane columns j-1 .. j+2 of the support
// (x0 - 1 .. x0 + 2 below) and halo rows -1 .. PSZ+1 feed it: the image
// taps read support columns j and j+1, the x differences columns j-1 ..
// j+2 on the support rows, the y differences columns j and j+1 on the
// halo rows.  Reads are clamped into the plane as load_halo clamps them;
// a clamped read only ever feeds a masked-out difference.
template <int PSZ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_patches_grad_kernel(const float* __restrict__ img, int Hp, int Wp,
                           const float2* __restrict__ centers,
                           float* __restrict__ p_img, float* __restrict__ p_dx,
                           float* __restrict__ p_dy, int M, int pad) {
  constexpr int G = 32 / PSZ;
  const int lane = threadIdx.x & 31;
  const int g = lane / PSZ, j = lane - g * PSZ;
  const int m = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G + g;
  if (g >= G || m >= M) return;  // lanes are independent: no warp-wide op below

  const float2 c = centers[m];
  const int r0 = support_start(c.y, PSZ, pad, Hp);
  const int x0 = support_start(c.x, PSZ, pad, Wp) + j;
  const float4 w = bilinear_weights(c.x, c.y);
  const int xl = max(x0 - 1, 0), xr = min(x0 + 2, Wp - 1);
  // ha, hb: columns x0, x0+1 on halo rows r0-1 .. r0+PSZ+1; hl, hr:
  // columns x0-1, x0+2 on support rows r0 .. r0+PSZ
  float ha[PSZ + 3], hb[PSZ + 3], hl[PSZ + 1], hr[PSZ + 1];
#pragma unroll
  for (int k = 0; k < PSZ + 3; ++k) {
    const int y = (k == 0) ? max(r0 - 1, 0)
                  : (k == PSZ + 2) ? min(r0 + PSZ + 1, Hp - 1) : r0 + k - 1;
    const float* row = img + (size_t)y * Wp;
    ha[k] = __ldg(row + x0);
    hb[k] = __ldg(row + x0 + 1);
    if (k >= 1 && k <= PSZ + 1) {
      hl[k - 1] = __ldg(row + xl);
      hr[k - 1] = __ldg(row + xr);
    }
  }
  // the masks of patch_grad_from_halo, split into their row and column
  // parts: dx needs pad <= y <= Hp-pad-1 and pad+1 <= x <= Wp-pad-2, dy
  // needs pad+1 <= y <= Hp-pad-2 and pad <= x <= Wp-pad-1
  const bool dx_a = (x0 >= pad + 1) && (x0 <= Wp - pad - 2);
  const bool dx_b = (x0 + 1 >= pad + 1) && (x0 + 1 <= Wp - pad - 2);
  const bool dy_a = (x0 >= pad) && (x0 <= Wp - pad - 1);
  const bool dy_b = (x0 + 1 >= pad) && (x0 + 1 <= Wp - pad - 1);
  // each support row's differences, once for the two output rows using them
  float gxa[PSZ + 1], gxb[PSZ + 1], gya[PSZ + 1], gyb[PSZ + 1];
#pragma unroll
  for (int a = 0; a <= PSZ; ++a) {
    const int y = r0 + a;
    const bool rx = (y >= pad) && (y <= Hp - pad - 1);
    const bool ry = (y >= pad + 1) && (y <= Hp - pad - 2);
    gxa[a] = (rx && dx_a) ? __fsub_rn(hb[a + 1], hl[a]) : 0.0f;
    gxb[a] = (rx && dx_b) ? __fsub_rn(hr[a], ha[a + 1]) : 0.0f;
    gya[a] = (ry && dy_a) ? __fsub_rn(ha[a + 2], ha[a]) : 0.0f;
    gyb[a] = (ry && dy_b) ? __fsub_rn(hb[a + 2], hb[a]) : 0.0f;
  }
  const size_t out0 = (size_t)m * (PSZ * PSZ) + j;
#pragma unroll
  for (int i = 0; i < PSZ; ++i) {
    // taps in weight order: (i+1, j+1), (i+1, j), (i, j+1), (i, j)
    p_img[out0 + i * PSZ] = tap(w, hb[i + 2], ha[i + 2], hb[i + 1], ha[i + 1]);
    p_dx[out0 + i * PSZ] = tap(w, gxb[i + 1], gxa[i + 1], gxb[i], gxa[i]);
    p_dy[out0 + i * PSZ] = tap(w, gyb[i + 1], gya[i + 1], gyb[i], gya[i]);
  }
}

// ------------------------------------------------------------------ K5
// The lane groups of K6: lane j reads support columns j and j+1 of each
// row and writes output column j.  Above 16 (the descriptors' 18, the
// flow benchmark's 32) a group is a whole warp, one point.
template <int PSZ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_patches_kernel(const float* __restrict__ img, int Hp, int Wp,
                      const float2* __restrict__ centers,
                      float* __restrict__ out, int M, int pad) {
  constexpr int G = 32 / PSZ;
  const int lane = threadIdx.x & 31;
  const int g = lane / PSZ, j = lane - g * PSZ;
  const int m = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G + g;
  if (g >= G || m >= M) return;

  const float2 c = centers[m];
  const int r0 = support_start(c.y, PSZ, pad, Hp);
  const int c0 = support_start(c.x, PSZ, pad, Wp);
  const float4 w = bilinear_weights(c.x, c.y);
  const float* s = img + (size_t)r0 * Wp + c0 + j;
  float sa[PSZ + 1], sb[PSZ + 1];  // support columns j and j+1
#pragma unroll
  for (int r = 0; r <= PSZ; ++r) {
    sa[r] = __ldg(s + (size_t)r * Wp);
    sb[r] = __ldg(s + (size_t)r * Wp + 1);
  }
  float* dst = out + (size_t)m * (PSZ * PSZ) + j;
#pragma unroll
  for (int i = 0; i < PSZ; ++i)
    dst[i * PSZ] = tap(w, sb[i + 1], sa[i + 1], sb[i], sa[i]);
}

// K5 at any other even side: one warp per point, no staging.  A lane's
// four taps are neighbours of the next lane's, so the reads of one
// instruction fall on one or two rows of the support and hit in L1; the
// arithmetic is the grouped kernel's.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_patches_direct_kernel(const float* __restrict__ img, int Hp, int Wp,
                             const float2* __restrict__ centers,
                             float* __restrict__ out, int M, int psz, int pad) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;

  const float2 c = centers[m];
  const int r0 = support_start(c.y, psz, pad, Hp);
  const int c0 = support_start(c.x, psz, pad, Wp);
  const float4 w = bilinear_weights(c.x, c.y);
  const float* sup = img + (size_t)r0 * Wp + c0;
  float* dst = out + (size_t)m * (psz * psz);
  for (int p = lane; p < psz * psz; p += 32) {
    const int i = p / psz, j = p - i * psz;
    const float* s = sup + (size_t)i * Wp + j;
    dst[p] = tap(w, __ldg(s + Wp + 1), __ldg(s + Wp), __ldg(s + 1), __ldg(s));
  }
}

// blocks of kWarpsPerBlock warps for M points at 32/psz points per warp
inline int group_blocks_for(int M, int psz) {
  const int per_block = kWarpsPerBlock * (32 / psz);
  return (M + per_block - 1) / per_block;
}

// f(std::integral_constant<int, psz>{}) where psz is one of Sides; false
// for any other psz
template <int... Sides, class F>
bool with_side(int psz, F&& f) {
  return ((psz == Sides && (f(std::integral_constant<int, Sides>{}), true)) || ...);
}

// ------------------------------------------------------------------ K7
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_windows_kernel(const float* __restrict__ img, int Wp,
                      const int2* __restrict__ idx, float* __restrict__ out,
                      int M, int wh, int ww) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;
  const int2 id = idx[m];
  copy_window(img + (size_t)id.x * Wp + id.y, Wp, wh, ww,
              out + (size_t)m * (wh * ww), lane);
}

}  // namespace icgn

extern "C" int icgn_gather_ref_grad_windows(
    const float* rimg, const float* qimg, int Hp, int Wp, const int* idx,
    const float* wts, float* p_img, float* p_dx, float* p_dy, float* qwin,
    int M, int pad, void* stream) {
  icgn::gather_ref_grad_windows_kernel<<<icgn::blocks_for(M),
                                         icgn::kWarpsPerBlock * 32, 0,
                                         (cudaStream_t)stream>>>(
      rimg, qimg, Hp, Wp, reinterpret_cast<const int4*>(idx),
      reinterpret_cast<const float4*>(wts), p_img, p_dx, p_dy, qwin, M, pad);
  return (int)cudaGetLastError();
}

extern "C" int icgn_gather_patches_grad(const float* img, int Hp, int Wp,
                                        const float* centers, float* p_img,
                                        float* p_dx, float* p_dy, int M,
                                        int psz, int pad, void* stream) {
  if (Hp < psz + 1 || Wp < psz + 1) return (int)cudaErrorInvalidValue;
  const auto* c = reinterpret_cast<const float2*>(centers);
  // the even sides up to ops/patch_gather.py::MAX_PSZ (no caller goes beyond)
  const bool ok = icgn::with_side<2, 4, 6, 8, 10, 12, 14, 16>(psz, [&](auto P) {
    constexpr int kP = decltype(P)::value;
    icgn::gather_patches_grad_kernel<kP><<<icgn::group_blocks_for(M, kP),
                                           icgn::kWarpsPerBlock * 32, 0,
                                           (cudaStream_t)stream>>>(
        img, Hp, Wp, c, p_img, p_dx, p_dy, M, pad);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int icgn_gather_patches(const float* img, int Hp, int Wp,
                                   const float* centers, float* out, int M,
                                   int psz, int pad, void* stream) {
  if (psz < 2 || psz % 2 || Hp < psz + 1 || Wp < psz + 1)
    return (int)cudaErrorInvalidValue;
  const auto* c = reinterpret_cast<const float2*>(centers);
  // the even sides up to 16, and those of the descriptors and the flow
  // benchmark
  const bool grouped = icgn::with_side<2, 4, 6, 8, 10, 12, 14, 16, 18, 32>(
      psz, [&](auto P) {
    constexpr int kP = decltype(P)::value;
    icgn::gather_patches_kernel<kP><<<icgn::group_blocks_for(M, kP),
                                      icgn::kWarpsPerBlock * 32, 0,
                                      (cudaStream_t)stream>>>(img, Hp, Wp, c,
                                                              out, M, pad);
  });
  if (!grouped)
    icgn::gather_patches_direct_kernel<<<icgn::blocks_for(M),
                                         icgn::kWarpsPerBlock * 32, 0,
                                         (cudaStream_t)stream>>>(
        img, Hp, Wp, c, out, M, psz, pad);
  return (int)cudaGetLastError();
}

extern "C" int icgn_gather_windows(const float* img, int Wp, const int* idx,
                                   float* out, int M, int wh, int ww,
                                   void* stream) {
  icgn::gather_windows_kernel<<<icgn::blocks_for(M), icgn::kWarpsPerBlock * 32,
                                0, (cudaStream_t)stream>>>(
      img, Wp, reinterpret_cast<const int2*>(idx), out, M, wh, ww);
  return (int)cudaGetLastError();
}
