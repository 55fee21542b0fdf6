// K1, K5, K6, K7: the tracker's gathers.
//
// K1 replaces invcompcamtrack_tpu/ops/patch_pallas.py::gather_ref_grad_and_windows
// (body _kernel_grad_window): per point the 8x8 reference patch, its two
// gradient patches and the 16x16 integer-origin window of the query image
// that the GN iterations resample from (K2).
// K5 replaces ::gather_patches (body _kernel_single): the psz x psz
// bilinear patch, for any even psz: up to 16 the support is staged in
// shared memory, above it (the descriptors' 18, the flow benchmark's 32)
// each pixel reads its four taps straight through L1/L2.
// K6 replaces ::gather_patches_grad (body _kernel_grad_fused): K1 without
// the window, for any even psz <= 16 (no caller goes beyond).
// K7 replaces ::gather_windows (body _kernel_windows): the (wh, ww) window
// at an integer origin.
//
// Inputs (prepared by ops/patch_gather.py, with the plain versions' code):
//   planes       padded level planes (Hp, Wp) f32
//   idx          int32 support (and window) row/col per point, each
//                already moved inside the plane (dynamic_slice rule)
//   wts  (M, 4)  f32: the 4 constant bilinear weights
// Outputs: patches (M, psz*psz), windows (M, wh*ww), all f32.
//
// The gradients are not gathered from the pyramid's dx/dy planes but
// computed here from a 1-px halo around the support: those planes are
// central differences of the image, zero on the reflect-101 border
// columns/rows and in the pad band, so the masked difference of the
// image window is the same subtraction of the same floats (the masks of
// _kernel_grad_window).  One plane read per point instead of three.
//
// What bounds them on an H100: bytes written.  K1 writes 448 floats per
// point (46 MB at 25,600 points), K6 3 psz^2, K5 psz^2, K7 wh*ww; the
// reads come from a level plane that stays in the 50 MB L2 (the padded
// 1296x736 level 0 is 3.8 MB).  Design: one warp per point, eight points
// per block.  The warp stages the support (K5) or its halo (K1, K6) in
// shared memory, then each lane computes every 32nd output pixel and
// writes it with coalesced stores; windows are copied 32 floats per
// instruction.  No per-point VMEM plan, lane alignment or two-phase
// plane copies of the TPU kernels have a counterpart here.
#include <cstdint>

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
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_patches_grad_kernel(const float* __restrict__ img, int Hp, int Wp,
                           const int2* __restrict__ idx,
                           const float4* __restrict__ wts,
                           float* __restrict__ p_img, float* __restrict__ p_dx,
                           float* __restrict__ p_dy, int M, int psz, int pad) {
  __shared__ float halo_all[kWarpsPerBlock][(kMaxPsz + 3) * (kMaxPsz + 3)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;

  const int2 id = idx[m];
  float* halo = halo_all[warp];
  load_halo(img, Hp, Wp, id.x, id.y, psz, halo, lane);
  const size_t out0 = (size_t)m * (psz * psz);
  patch_grad_from_halo(halo, Hp, Wp, id.x, id.y, psz, pad, wts[m],
                       p_img + out0, p_dx + out0, p_dy + out0, lane);
}

// ------------------------------------------------------------------ K5
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_patches_kernel(const float* __restrict__ img, int Wp,
                      const int2* __restrict__ idx,
                      const float4* __restrict__ wts, float* __restrict__ out,
                      int M, int psz) {
  __shared__ float sup_all[kWarpsPerBlock][(kMaxPsz + 1) * (kMaxPsz + 1)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;

  const int2 id = idx[m];  // the support fits the plane: no clamp needed
  const float4 w = wts[m];
  float* sup = sup_all[warp];
  const int ss = psz + 1;
  copy_window(img + (size_t)id.x * Wp + id.y, Wp, ss, ss, sup, lane);
  __syncwarp();
  float* dst = out + (size_t)m * (psz * psz);
  for (int p = lane; p < psz * psz; p += 32) {
    const int i = p / psz, j = p - i * psz;
    const float* s = sup + i * ss + j;
    dst[p] = tap(w, s[ss + 1], s[ss], s[1], s[0]);
  }
}

// K5 above kMaxPsz: no staging.  A lane's four taps are neighbours of the
// next lane's, so the reads of one instruction fall on one or two rows of
// the support and hit in L1; the arithmetic is the staged variant's.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_patches_direct_kernel(const float* __restrict__ img, int Wp,
                             const int2* __restrict__ idx,
                             const float4* __restrict__ wts,
                             float* __restrict__ out, int M, int psz) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;

  const int2 id = idx[m];  // the support fits the plane: no clamp needed
  const float4 w = wts[m];
  const float* sup = img + (size_t)id.x * Wp + id.y;
  float* dst = out + (size_t)m * (psz * psz);
  for (int p = lane; p < psz * psz; p += 32) {
    const int i = p / psz, j = p - i * psz;
    const float* s = sup + (size_t)i * Wp + j;
    dst[p] = tap(w, __ldg(s + Wp + 1), __ldg(s + Wp), __ldg(s + 1), __ldg(s));
  }
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
                                        const int* idx, const float* wts,
                                        float* p_img, float* p_dx, float* p_dy,
                                        int M, int psz, int pad, void* stream) {
  if (psz < 2 || psz > icgn::kMaxPsz) return (int)cudaErrorInvalidValue;
  icgn::gather_patches_grad_kernel<<<icgn::blocks_for(M),
                                     icgn::kWarpsPerBlock * 32, 0,
                                     (cudaStream_t)stream>>>(
      img, Hp, Wp, reinterpret_cast<const int2*>(idx),
      reinterpret_cast<const float4*>(wts), p_img, p_dx, p_dy, M, psz, pad);
  return (int)cudaGetLastError();
}

extern "C" int icgn_gather_patches(const float* img, int Hp, int Wp,
                                   const int* idx, const float* wts, float* out,
                                   int M, int psz, void* stream) {
  if (psz < 2 || Hp < psz + 1 || Wp < psz + 1) return (int)cudaErrorInvalidValue;
  if (psz <= icgn::kMaxPsz)
    icgn::gather_patches_kernel<<<icgn::blocks_for(M), icgn::kWarpsPerBlock * 32,
                                  0, (cudaStream_t)stream>>>(
        img, Wp, reinterpret_cast<const int2*>(idx),
        reinterpret_cast<const float4*>(wts), out, M, psz);
  else
    icgn::gather_patches_direct_kernel<<<icgn::blocks_for(M),
                                         icgn::kWarpsPerBlock * 32, 0,
                                         (cudaStream_t)stream>>>(
        img, Wp, reinterpret_cast<const int2*>(idx),
        reinterpret_cast<const float4*>(wts), out, M, psz);
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
