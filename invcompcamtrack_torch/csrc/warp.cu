// K8: the dense backward warp of the dense LK flow.
//
// Replaces invcompcamtrack_tpu/ops/warp_pallas.py::warp_image_pallas (body
// _kernel): out(x) = img(x + flow(x)), bilinear, edge-clamped; called once
// per LK iteration by match/dense_flow.py::_lk_refine.
//
//   img   (H, W)     f32
//   flow  (H, W, 2)  f32, (dx, dy) per pixel
//   out   (H, W)     f32
//
// The TPU kernel has no per-lane addressing: it loads one aligned window
// per (8, 128) tile at the tile's mean integer flow and resolves each
// pixel's residual offset by a select-shift over +-3 px, clamping beyond
// that.  Here every thread addresses its own four taps, so the slack, the
// per-tile means and the clamp have no counterpart: the kernel is the
// exact per-pixel bilinear of ops/warp.py::warp_image_plain (the JAX
// package's XLA twin match/dense_flow.py::warp_image) at every pixel, for
// any flow.
//
// What bounds it on an H100: bytes.  It reads 12 bytes and writes 4 per
// pixel (14.7 MB at 1280x720) for about 20 float operations.  Design: one
// thread per output pixel, 32x8 blocks, so a warp covers 32 neighbouring
// pixels of one row: the flow and the output move as coalesced 256-byte
// and 128-byte rows, and for a smooth flow the warp's taps fall on two
// neighbouring image rows that stay in L1/L2.  Indices and weights follow
// the plain version's rules operation for operation, through the
// non-contracting _rn intrinsics, so the two agree bit for bit.
#include <cuda_runtime.h>

namespace icgn {

constexpr int kWarpBlockX = 32;
constexpr int kWarpBlockY = 8;

// clamp(v, lo, hi) that lets a NaN through, as torch.clamp does
// (fminf/fmaxf alone would drop it).
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kWarpBlockX * kWarpBlockY)
warp_image_kernel(const float* __restrict__ img, const float2* __restrict__ flow,
                  float* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * kWarpBlockX + threadIdx.x;
  const int y = blockIdx.y * kWarpBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t at = (size_t)y * W + x;
  const float2 f = flow[at];
  const float sx = __fadd_rn((float)x, f.x);
  const float sy = __fadd_rn((float)y, f.y);
  // the clamp is taken in float, before the conversion to int: a huge or
  // infinite flow lands on the border pixel, and a NaN takes index 0 and
  // keeps its NaN in the weight, on the card as on the CPU
  const float x0f = fminf(fmaxf(floorf(sx), 0.0f), (float)(W - 2));
  const float y0f = fminf(fmaxf(floorf(sy), 0.0f), (float)(H - 2));
  const float fx = clamp_keep_nan(__fsub_rn(sx, x0f), 0.0f, 1.0f);
  const float fy = clamp_keep_nan(__fsub_rn(sy, y0f), 0.0f, 1.0f);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float* p = img + (size_t)y0 * W + x0;
  const float t00 = __ldg(p), t01 = __ldg(p + 1);
  const float t10 = __ldg(p + W), t11 = __ldg(p + W + 1);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  // (1-fx)(1-fy) t00 + fx (1-fy) t01 + (1-fx) fy t10 + fx fy t11, each
  // product and the sum taken left to right as the plain version does
  float acc = __fmul_rn(__fmul_rn(gx, gy), t00);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(fx, gy), t01));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(gx, fy), t10));
  out[at] = __fadd_rn(acc, __fmul_rn(__fmul_rn(fx, fy), t11));
}

}  // namespace icgn

extern "C" int icgn_warp_image(const float* img, const float* flow, float* out,
                               int H, int W, void* stream) {
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const dim3 block(icgn::kWarpBlockX, icgn::kWarpBlockY);
  const dim3 grid((W + icgn::kWarpBlockX - 1) / icgn::kWarpBlockX,
                  (H + icgn::kWarpBlockY - 1) / icgn::kWarpBlockY);
  icgn::warp_image_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, reinterpret_cast<const float2*>(flow), out, H, W);
  return (int)cudaGetLastError();
}
