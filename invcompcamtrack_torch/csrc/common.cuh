// Helpers shared by the tracker's kernels.
//
// Every multiply and add of a bilinear tap goes through the _rn
// intrinsics: nvcc never contracts them into an FMA, so a tap rounds
// exactly as the plain PyTorch version's separate multiply and add
// kernels do, and the kernels agree with it bit for bit wherever no sum
// over pixels is involved.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace icgn {

constexpr int kPsz = 8;             // patch side (ICGNParams.psz)
constexpr int kWin = kPsz + 8;      // cached query window side
constexpr int kNpix = kPsz * kPsz;  // pixels per patch
constexpr int kWarpsPerBlock = 8;   // one point per warp

// patch[r,c] = w00 S[r+1,c+1] + w01 S[r+1,c] + w10 S[r,c+1] + w11 S[r,c],
// summed left to right as image/taps.py::combine does.
__device__ __forceinline__ float tap(float4 w, float s11, float s10,
                                     float s01, float s00) {
  float acc = __fmul_rn(w.x, s11);
  acc = __fadd_rn(acc, __fmul_rn(w.y, s10));
  acc = __fadd_rn(acc, __fmul_rn(w.z, s01));
  return __fadd_rn(acc, __fmul_rn(w.w, s00));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace icgn
