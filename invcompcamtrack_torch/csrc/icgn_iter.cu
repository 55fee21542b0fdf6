// K2 and K3: the fused GN-iteration body of the tracker.
//
// Replaces invcompcamtrack_tpu/ops/icgn_iter_pallas.py::fused_resample_project
// (K2, body _kernel_project + _resample_pdiff) and ::fused_resample_pdiff
// (K3, body _kernel).  Per point: resample the 8x8 query patch out of the
// cached 16x16 window at integer offset (row_w, col_w) in [0, 7]^2 with
// the 4 constant taps, optionally remove its mean, form the masked
// residual pdiff = (ref - patch) * valid, and either
//   K2: project it onto the two gradient patches, (gx, gy) =
//       (sum p_dx * pdiff, sum p_dy * pdiff) -> out (M, 2), or
//   K3: store pdiff -> out (M, 64).
// The 6-vector rhs = jx * gx + jy * gy stays in the caller.
//
// Layouts are plain: qwin (M, 256), ref/p_dx/p_dy (M, 64), stored f32 or
// bf16 (ICGNParams.bf16_gather); all arithmetic is f32.  The TPU's
// stride-16 lane layout (to_strided) and lane rotations have no
// counterpart.
//
// What bounds it on an H100: reads, 448 stored values per point per
// iteration (1.8 KB in f32, 0.9 KB in bf16) against 8 bytes written.
// Design: one warp per point, eight points per block; the warp stages
// the window in shared memory with coalesced loads, each lane resamples
// two of the 64 pixels, and the mean and the two projections are
// butterfly reductions with __shfl_xor_sync.
#include <cstdint>

#include "common.cuh"

namespace icgn {

static_assert(kNpix == 64, "each lane owns two of the patch's 64 pixels");

template <typename T, bool kProject>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
resample_kernel(const T* __restrict__ qwin, const T* __restrict__ ref,
                const T* __restrict__ pdx, const T* __restrict__ pdy,
                const int* __restrict__ row_w, const int* __restrict__ col_w,
                const float4* __restrict__ wts,
                const float* __restrict__ valid, float* __restrict__ out,
                int M, int patch_norm) {
  __shared__ float win_all[kWarpsPerBlock][kWin * kWin];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;  // whole warp leaves together; no block barrier

  float* win = win_all[warp];
  const T* src = qwin + (size_t)m * (kWin * kWin);
#pragma unroll
  for (int k = lane; k < kWin * kWin; k += 32) win[k] = to_f32(src[k]);
  __syncwarp();

  // ops/window_sample.py::window_taps gives offsets in [0, 7]; clamp
  // anyway, so that no input can read past this warp's staged window
  constexpr int kMaxOff = kWin - kPsz - 1;
  const int rw = min(max(row_w[m], 0), kMaxOff);
  const int cw = min(max(col_w[m], 0), kMaxOff);
  const float4 w = wts[m];
  const float vld = valid[m];

  float q[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int p = lane + 32 * u;
    const float* s = win + (rw + p / kPsz) * kWin + cw + p % kPsz;
    q[u] = tap(w, s[kWin + 1], s[kWin], s[1], s[0]);
  }
  if (patch_norm) {
    const float mean = warp_sum(q[0] + q[1]) * (1.0f / kNpix);
    q[0] = __fsub_rn(q[0], mean);
    q[1] = __fsub_rn(q[1], mean);
  }
  const size_t base = (size_t)m * kNpix;
  float d[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    d[u] = __fmul_rn(__fsub_rn(to_f32(ref[base + lane + 32 * u]), q[u]), vld);

  if constexpr (kProject) {
    float gx = __fmul_rn(to_f32(pdx[base + lane]), d[0]);
    gx = __fadd_rn(gx, __fmul_rn(to_f32(pdx[base + lane + 32]), d[1]));
    float gy = __fmul_rn(to_f32(pdy[base + lane]), d[0]);
    gy = __fadd_rn(gy, __fmul_rn(to_f32(pdy[base + lane + 32]), d[1]));
    gx = warp_sum(gx);
    gy = warp_sum(gy);
    if (lane == 0) {
      out[2 * (size_t)m] = gx;
      out[2 * (size_t)m + 1] = gy;
    }
  } else {
    out[base + lane] = d[0];
    out[base + lane + 32] = d[1];
  }
}

template <bool kProject>
int launch(const void* qwin, const void* ref, const void* pdx, const void* pdy,
           const int* row_w, const int* col_w, const float* wts,
           const float* valid, float* out, int M, int patch_norm, int bf16,
           void* stream) {
  const int blocks = (M + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const float4* w4 = reinterpret_cast<const float4*>(wts);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    resample_kernel<T, kProject><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const T*)qwin, (const T*)ref, (const T*)pdx, (const T*)pdy, row_w,
        col_w, w4, valid, out, M, patch_norm);
  } else {
    resample_kernel<float, kProject><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const float*)qwin, (const float*)ref, (const float*)pdx,
        (const float*)pdy, row_w, col_w, w4, valid, out, M, patch_norm);
  }
  return (int)cudaGetLastError();
}

}  // namespace icgn

extern "C" int icgn_resample_project(const void* qwin, const void* ref,
                                     const void* pdx, const void* pdy,
                                     const int* row_w, const int* col_w,
                                     const float* wts, const float* valid,
                                     float* out, int M, int patch_norm,
                                     int bf16, void* stream) {
  return icgn::launch<true>(qwin, ref, pdx, pdy, row_w, col_w, wts, valid, out,
                            M, patch_norm, bf16, stream);
}

extern "C" int icgn_resample_pdiff(const void* qwin, const void* ref,
                                   const int* row_w, const int* col_w,
                                   const float* wts, const float* valid,
                                   float* out, int M, int patch_norm, int bf16,
                                   void* stream) {
  return icgn::launch<false>(qwin, ref, nullptr, nullptr, row_w, col_w, wts,
                             valid, out, M, patch_norm, bf16, stream);
}

extern "C" const char* icgn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
