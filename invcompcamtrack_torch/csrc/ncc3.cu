// K4: the fused NCC scorer of the odometry verifier.
//
// Replaces invcompcamtrack_tpu/ops/ncc_pallas.py::ncc3_scores (body
// _kernel_ncc3).  Per point: three psz x psz bilinear patches, one from
// each of three planes (back, ref, fwd) at its own sub-pixel center; each
// has its mean removed and its norm taken with a 1e-15 floor; the output
// is max(0, .) of the (back, ref) and (ref, fwd) correlations,
//   corr_ab = sum(p_a p_b) / (n_a n_b).
// Two floats per point leave the kernel; no (M, psz, psz) patch touches
// device memory.
//
// Inputs (prepared by ops/ncc3.py with the plain version's torch code):
//   img_b, img_r, img_f  padded level planes (Hp, Wp) f32 of one shape
//   idx  (M, 6) int32    support row/col per plane, moved inside the plane
//   wts  (M, 12) f32     the 4 bilinear weights per plane
// Output: out (M, 2) f32 = (corr_back_ref, corr_ref_fwd).
//
// What bounds it on an H100: bytes.  Each plane is read once (3.8 MB at
// 1296x736, so the three stay in the 50 MB L2) plus 72 B per point of
// indices and weights in and 8 B out.  Design: one warp per point, eight
// points per block.  For each plane the warp stages the (psz+1)^2 support
// in shared memory, each lane blends its pixels (two at psz <= 8, up to
// eight at psz 16) with the plain version's tap order, and the mean, the
// three sums of squares and the two dot products are __shfl_xor_sync
// butterflies.  The aligned window loads, lane rolls and SMEM tiling of
// the TPU kernel have no counterpart.
#include <cstdint>

#include "common.cuh"

namespace icgn {

constexpr float kNormFloor = 1e-15f;  // match/ncc.py::NORM_FLOOR

template <int kPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ncc3_kernel(const float* __restrict__ img_b, const float* __restrict__ img_r,
            const float* __restrict__ img_f, int Wp,
            const int2* __restrict__ idx, const float4* __restrict__ wts,
            float2* __restrict__ out, int M, int psz) {
  // kPerLane pixels per lane cover patches of up to 32 * kPerLane pixels
  constexpr int kMaxSide = (kPerLane == 2) ? 8 : 16;
  constexpr int kSup = (kMaxSide + 1) * (kMaxSide + 1);
  __shared__ float sup_all[kWarpsPerBlock][kSup];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= M) return;  // whole warp leaves together; no block barrier

  const int ss = psz + 1;
  const int npix = psz * psz;
  float* sup = sup_all[warp];
  const float* planes[3] = {img_b, img_r, img_f};
  float q[3][kPerLane];
  float norm[3];

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int2 id = idx[3 * (size_t)m + k];
    const float4 w = wts[3 * (size_t)m + k];
    const float* src = planes[k] + (size_t)id.x * Wp + id.y;
    __syncwarp();  // the previous plane's support has been consumed
    for (int t = lane; t < ss * ss; t += 32) {
      const int a = t / ss, b = t - a * ss;
      sup[t] = src[(size_t)a * Wp + b];
    }
    __syncwarp();
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int p = lane + 32 * u;
      float v = 0.0f;
      if (p < npix) {
        const int i = p / psz, j = p - i * psz;
        const float* s = sup + i * ss + j;
        v = tap(w, s[ss + 1], s[ss], s[1], s[0]);
      }
      q[k][u] = v;
      acc += v;
    }
    const float mean = __fdiv_rn(warp_sum(acc), (float)npix);
    float sq = 0.0f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const float v = (lane + 32 * u < npix) ? __fsub_rn(q[k][u], mean) : 0.0f;
      q[k][u] = v;
      sq += v * v;
    }
    norm[k] = fmaxf(sqrtf(warp_sum(sq)), kNormFloor);
  }

  float br = 0.0f, rf = 0.0f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    br += q[0][u] * q[1][u];
    rf += q[1][u] * q[2][u];
  }
  br = warp_sum(br);
  rf = warp_sum(rf);
  if (lane == 0) {
    out[m] = make_float2(fmaxf(0.0f, br / (norm[0] * norm[1])),
                         fmaxf(0.0f, rf / (norm[1] * norm[2])));
  }
}

}  // namespace icgn

extern "C" int icgn_ncc3_scores(const float* img_b, const float* img_r,
                                const float* img_f, int Hp, int Wp,
                                const int* idx, const float* wts, float* out,
                                int M, int psz, void* stream) {
  using namespace icgn;
  if (psz < 2 || psz > 16 || Hp < psz + 1 || Wp < psz + 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (M + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int2* id = reinterpret_cast<const int2*>(idx);
  const float4* w4 = reinterpret_cast<const float4*>(wts);
  float2* o2 = reinterpret_cast<float2*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (psz <= 8) {
    ncc3_kernel<2><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        img_b, img_r, img_f, Wp, id, w4, o2, M, psz);
  } else {
    ncc3_kernel<8><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        img_b, img_r, img_f, Wp, id, w4, o2, M, psz);
  }
  return (int)cudaGetLastError();
}
