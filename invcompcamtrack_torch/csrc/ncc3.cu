// K4: the fused NCC scorer of the odometry verifier.
//
// Replaces invcompcamtrack_tpu/ops/ncc_pallas.py::ncc3_scores (body
// _kernel_ncc3).  Per point: three psz x psz bilinear patches, one from
// each of three planes (back, ref, fwd) at its own sub-pixel centre; each
// has its mean removed and its norm taken with a 1e-15 floor; the output
// is max(0, .) of the (back, ref) and (ref, fwd) correlations,
//   corr_ab = sum(p_a p_b) / (n_a n_b).
// Two floats per point leave the kernel; no (M, psz, psz) patch touches
// device memory.
//
// Inputs:
//   img_b, img_r, img_f  padded level planes (Hp, Wp) f32 of one shape
//   uv_b, uv_r, uv_f     (M, 2) f32 centres (x, y), unpadded, one per
//                        plane: each support start and the 4 weights are
//                        computed here with K5's device functions
//                        (support_start, bilinear_weights in
//                        patch_gather.cuh), so every patch pixel equals
//                        K5's and the plain version's bit for bit
// Output: out (M, 2) f32 = (corr_back_ref, corr_ref_fwd).  A centre that
// is not finite gives NaN weights, and NaN in each score it enters, as
// the plain version gives (the floor and the clamp keep a NaN, as
// torch.clamp does).
//
// What bounds it on an H100: bytes.  Each plane is read once (3.8 MB at
// 1296x736, so the three stay in the 50 MB L2) plus 24 B of centres in
// and 8 B out per point.  Two floats out per point leave nothing to hide
// a per-point chain of staged copies and barriers behind, so K5's layout
// carries the reductions: a group of L lanes serves one point, L = psz
// rounded up to a power of two (2, 4, 8 or 16), so a warp holds 32/L
// points.  Lane j of a group owns column j of all three patches; it
// computes the three starts and weights, issues the loads of support
// columns j and j+1 over psz+1 rows of all three planes through the
// read-only path before it forms any tap, so the three planes' latencies
// overlap, and then takes every sum in segmented butterflies:
// __shfl_xor_sync over log2(L) steps with the group's mask, the three
// means in one pass and the three sums of squares and two dot products in
// a second.  At the sides that are no power of two (6, 10, 12, 14) the
// lanes psz .. L-1 of a group load nothing and add zeros to every sum (a
// butterfly over L rather than a masked reduction: one code path for
// every side).  psz is a template parameter, so the loops unroll into
// registers: no shared memory, no barrier, no integer division.  What
// holds it at about 3 x the byte bound (PERF.md) is the number of load
// requests, 6 (psz+1) per lane, each touching one row of each of the
// warp's points.  The aligned window loads, lane rolls and SMEM tiling of
// the TPU kernel have no counterpart.
#include "patch_gather.cuh"

namespace icgn {

constexpr float kNormFloor = 1e-15f;  // match/ncc.py::NORM_FLOOR

// max(v, lo) that keeps a NaN, as torch.clamp(v, min=lo) does
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__host__ __device__ constexpr int lanes_for(int psz) {
  return psz <= 2 ? 2 : psz <= 4 ? 4 : psz <= 8 ? 8 : 16;
}

template <int PSZ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ncc3_kernel(const float* __restrict__ img_b, const float* __restrict__ img_r,
            const float* __restrict__ img_f, int Hp, int Wp,
            const float2* __restrict__ uv_b, const float2* __restrict__ uv_r,
            const float2* __restrict__ uv_f, float2* __restrict__ out, int M,
            int pad) {
  constexpr int L = lanes_for(PSZ);
  constexpr int G = 32 / L;
  constexpr float npix = (float)(PSZ * PSZ);
  const int lane = threadIdx.x & 31;
  const int g = lane / L, j = lane - g * L;
  const int m = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G + g;
  if (m >= M) return;  // the whole group leaves: its mask names only it
  const unsigned mask = ((1u << L) - 1u) << (g * L);
  const bool owns = j < PSZ;  // lane j owns column j of the three patches

  const float* planes[3] = {img_b, img_r, img_f};
  const float2 c[3] = {uv_b[m], uv_r[m], uv_f[m]};
  float sa[3][PSZ + 1], sb[3][PSZ + 1];  // support columns j and j+1
  if (owns) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int r0 = support_start(c[k].y, PSZ, pad, Hp);
      const int c0 = support_start(c[k].x, PSZ, pad, Wp);
      const float* s = planes[k] + (size_t)r0 * Wp + c0 + j;
#pragma unroll
      for (int r = 0; r <= PSZ; ++r) {
        sa[k][r] = __ldg(s + (size_t)r * Wp);
        sb[k][r] = __ldg(s + (size_t)r * Wp + 1);
      }
    }
  }
  // column j of each patch and its sum; zeros on a lane that owns none
  float q[3][PSZ], mean[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 w = bilinear_weights(c[k].x, c[k].y);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < PSZ; ++i) {
      q[k][i] = owns ? tap(w, sb[k][i + 1], sa[k][i + 1], sb[k][i], sa[k][i]) : 0.0f;
      acc += q[k][i];
    }
    mean[k] = acc;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) mean[k] = group_sum<L>(mean[k], mask);
  // mean-removed pixels: the sums of squares and the two dot products
  float sq[3] = {0.0f, 0.0f, 0.0f}, br = 0.0f, rf = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float mu = __fdiv_rn(mean[k], npix);
#pragma unroll
    for (int i = 0; i < PSZ; ++i) {
      q[k][i] = owns ? __fsub_rn(q[k][i], mu) : 0.0f;
      sq[k] += q[k][i] * q[k][i];
    }
  }
#pragma unroll
  for (int i = 0; i < PSZ; ++i) {
    br += q[0][i] * q[1][i];
    rf += q[1][i] * q[2][i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) sq[k] = group_sum<L>(sq[k], mask);
  br = group_sum<L>(br, mask);
  rf = group_sum<L>(rf, mask);
  if (j == 0) {
    const float nb = clamp_min(sqrtf(sq[0]), kNormFloor);
    const float nr = clamp_min(sqrtf(sq[1]), kNormFloor);
    const float nf = clamp_min(sqrtf(sq[2]), kNormFloor);
    out[m] = make_float2(clamp_min(br / (nb * nr), 0.0f),
                         clamp_min(rf / (nr * nf), 0.0f));
  }
}

}  // namespace icgn

extern "C" int icgn_ncc3_scores(const float* img_b, const float* img_r,
                                const float* img_f, int Hp, int Wp,
                                const float* uv_b, const float* uv_r,
                                const float* uv_f, float* out, int M, int psz,
                                int pad, void* stream) {
  if (Hp < psz + 1 || Wp < psz + 1) return (int)cudaErrorInvalidValue;
  const auto* b = reinterpret_cast<const float2*>(uv_b);
  const auto* r = reinterpret_cast<const float2*>(uv_r);
  const auto* f = reinterpret_cast<const float2*>(uv_f);
  float2* o2 = reinterpret_cast<float2*>(out);
  // the even sides up to ops/patch_gather.py::MAX_PSZ
  const bool ok = icgn::with_side<2, 4, 6, 8, 10, 12, 14, 16>(psz, [&](auto P) {
    constexpr int kP = decltype(P)::value;
    icgn::ncc3_kernel<kP><<<icgn::group_blocks_for(M, icgn::lanes_for(kP)),
                            icgn::kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        img_b, img_r, img_f, Hp, Wp, b, r, f, o2, M, pad);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
