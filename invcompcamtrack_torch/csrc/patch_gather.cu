// K1: the tracker's per-scale dual gather.
//
// Replaces invcompcamtrack_tpu/ops/patch_pallas.py::gather_ref_grad_and_windows
// (body _kernel_grad_window).  Per point it produces the 8x8 reference
// patch, its two gradient patches and the 16x16 integer-origin window of
// the query image that the GN iterations resample from (K2).
//
// Inputs (prepared by ops/patch_gather.py, with the plain version's code):
//   rimg, qimg   padded level planes (Hp, Wp) f32
//   idx  (M, 4)  int32: patch-support row/col and window row/col, each
//                already moved inside the plane (dynamic_slice rule)
//   wts  (M, 4)  f32: the 4 constant bilinear weights
// Outputs: p_img, p_dx, p_dy (M, 64) and qwin (M, 256), all f32.
//
// The gradients are not gathered from the pyramid's dx/dy planes but
// computed here from a 1-px halo around the support: those planes are
// central differences of the image, zero on the reflect-101 border
// columns/rows and in the pad band, so the masked difference of the
// image window is the same subtraction of the same floats (the masks of
// _kernel_grad_window).  One plane read per point instead of three.
//
// What bounds it on an H100: bytes written, 448 floats per point (46 MB
// at 25,600 points); the reads are ~380 floats per point from a level
// plane that stays in the 50 MB L2 (the padded 1296x736 level 0 is
// 3.8 MB).  Design: one warp per point, eight points per block.  The
// warp stages the 11x11 halo in shared memory, then each lane computes
// two of the 64 output pixels (12 halo reads each) and writes them with
// coalesced stores; the 16x16 window is copied row pairs per
// instruction.  No per-point VMEM plan, lane alignment or two-phase
// plane copies of the TPU kernel have a counterpart here.
#include <cstdint>

#include "common.cuh"

namespace icgn {

constexpr int kHalo = kPsz + 3;  // support (psz+1) + 1-px halo each side

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_ref_grad_windows_kernel(const float* __restrict__ rimg,
                               const float* __restrict__ qimg, int Hp, int Wp,
                               const int4* __restrict__ idx,
                               const float4* __restrict__ wts,
                               float* __restrict__ p_img,
                               float* __restrict__ p_dx,
                               float* __restrict__ p_dy,
                               float* __restrict__ qwin, int M, int pad) {
  __shared__ float halo_all[kWarpsPerBlock][kHalo * kHalo];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;  // warps are independent: no block barrier below

  const int4 id = idx[m];  // (support row, support col, window row, col)
  const float4 w = wts[m];
  float* halo = halo_all[warp];

  // halo[a][b] = rimg[r - 1 + a][c - 1 + b]; reads are clamped into the
  // plane, and a clamped read only ever feeds a masked-out difference
  for (int k = lane; k < kHalo * kHalo; k += 32) {
    const int a = k / kHalo, b = k - a * kHalo;
    const int y = min(max(id.x - 1 + a, 0), Hp - 1);
    const int x = min(max(id.y - 1 + b, 0), Wp - 1);
    halo[k] = rimg[(size_t)y * Wp + x];
  }
  __syncwarp();

  const size_t out0 = (size_t)m * kNpix;
  for (int p = lane; p < kNpix; p += 32) {
    const int i = p / kPsz, j = p - (p / kPsz) * kPsz;
    float ti[4], tx[4], ty[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // taps in weight order: (1,1), (1,0), (0,1), (0,0)
      const int a = i + ((t < 2) ? 1 : 0);
      const int b = j + ((t & 1) ? 0 : 1);
      const int y = id.x + a, x = id.y + b;  // plane coords
      const float* h = halo + (a + 1) * kHalo + (b + 1);
      ti[t] = h[0];
      const bool mdx = (y >= pad) && (y <= Hp - pad - 1) &&
                       (x >= pad + 1) && (x <= Wp - pad - 2);
      const bool mdy = (y >= pad + 1) && (y <= Hp - pad - 2) &&
                       (x >= pad) && (x <= Wp - pad - 1);
      tx[t] = mdx ? __fsub_rn(h[1], h[-1]) : 0.0f;
      ty[t] = mdy ? __fsub_rn(h[kHalo], h[-kHalo]) : 0.0f;
    }
    p_img[out0 + p] = tap(w, ti[0], ti[1], ti[2], ti[3]);
    p_dx[out0 + p] = tap(w, tx[0], tx[1], tx[2], tx[3]);
    p_dy[out0 + p] = tap(w, ty[0], ty[1], ty[2], ty[3]);
  }

  const float* src = qimg + (size_t)id.z * Wp + id.w;
  float* dst = qwin + (size_t)m * (kWin * kWin);
  for (int k = lane; k < kWin * kWin; k += 32) {
    const int a = k / kWin, b = k - a * kWin;
    dst[k] = src[(size_t)a * Wp + b];
  }
}

}  // namespace icgn

extern "C" int icgn_gather_ref_grad_windows(
    const float* rimg, const float* qimg, int Hp, int Wp, const int* idx,
    const float* wts, float* p_img, float* p_dx, float* p_dy, float* qwin,
    int M, int pad, void* stream) {
  const int blocks = (M + icgn::kWarpsPerBlock - 1) / icgn::kWarpsPerBlock;
  icgn::gather_ref_grad_windows_kernel<<<blocks, icgn::kWarpsPerBlock * 32, 0,
                                         (cudaStream_t)stream>>>(
      rimg, qimg, Hp, Wp, reinterpret_cast<const int4*>(idx),
      reinterpret_cast<const float4*>(wts), p_img, p_dx, p_dy, qwin, M, pad);
  return (int)cudaGetLastError();
}
