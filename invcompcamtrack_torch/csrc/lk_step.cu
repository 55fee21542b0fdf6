// lk_step: one dense Lucas-Kanade iteration of match/dense_flow.py's
// _lk_refine, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this iteration to XLA
// (its box sums are XLA convolutions, invcompcamtrack_tpu/match/
// dense_flow.py::_box).  It was added because on the card the eager body
// was about 20 launches an iteration plus about 21 a level for the
// structure tensor, and its box sums went to a library convolution that
// ran about 40x over its bound.  K8 (csrc/warp.cu) runs before it and
// gives I1w.
//
//   I0    (H, W)     f32, the level's image 0
//   I1w   (H, W)     f32, image 1 warped by the flow (K8's output)
//   flow  (H, W, 2)  f32, (dx, dy); updated in place
//
// Per pixel, as ops/lk_step.py::lk_step_plain: (Ix, Iy) = central
// gradients of I0 (reflect-101 borders) times 0.5, It = I1w - I0; the
// five products Ix^2, IxIy, Iy^2, IxIt, IyIt, zero outside the image,
// summed over the (2r+1)^2 window; det = a11 a22 - a12^2; where
// det > min_det, flow -= ((a22 b1 - a12 b2) / det, (a11 b2 - a12 b1) / det),
// elsewhere the flow is not written at all and keeps its bits.
//
// What bounds it on an H100: bytes, barely.  Done with every intermediate
// on chip it reads I0, I1w and the flow and writes the flow: 24 bytes a
// pixel, 6.6 us at 1280x720; its 428 float operations a pixel at radius 4
// (5 x 81 of them additions) take 5.9 us at the float32 peak, which counts
// an FMA as two.  Each window is summed in the plain version's order: its
// box convolution (PyTorch's on the CPU, at radius 2, 4 and 8; cuDNN's,
// which the eager port ran on the card, gave the same flows at radius 4)
// starts each output at 0 and adds the window's (2r+1)^2 products one at
// a time, row by row, left to right.  The kernel does the same, so it
// gives the plain version's floats bit for bit, and the dense flow on the
// card is the CPU's.  (A separable sum, 2r+1 horizontal then 2r+1
// vertical taps, takes about a fifth of the additions but parts from the
// plain version's floats: through five levels of four iterations the flow
// of a pixel where LK has not converged then moved by up to 0.7 px.)
//
// Design: a block owns a 32x64 output tile.  It forms Ix, Iy, It over the
// tile and its halo of R pixels in shared memory (the halo's gradients
// read I0's neighbours through L1).  Each thread owns a column of 8
// output pixels and keeps their 5 x 8 sums in registers.  It walks the
// 8 + 2R shared rows those windows cover, top to bottom, and each row's
// 2R+1 columns left to right, forms the five products of each position
// once and adds them to every one of its sums whose window holds that
// row.  Every sum so sees its own window row by row, left to right.  A
// warp spans 32 neighbouring columns, so every shared access is one row
// of 32 words and every flow access one 256-byte row.  The structure
// tensor is recomputed in every iteration: it costs arithmetic and no
// device memory bytes, where storing it would read 16 bytes a pixel back
// in every iteration.  Every product, sum and quotient goes through the
// non-contracting _rn intrinsics, as the plain version's tensor ops round
// each one.  R is a template argument (0-8), so the walk is unrolled and
// each sum's adds are fixed when the kernel is compiled.
#include <cuda_runtime.h>

namespace icgn {

constexpr int kLkTileX = 32;       // output tile: one warp wide
constexpr int kLkThreadsY = 8;     // 32x8 threads
constexpr int kLkRows = 8;         // output rows of one thread
constexpr int kLkTileY = kLkThreadsY * kLkRows;
constexpr int kLkThreads = kLkTileX * kLkThreadsY;
constexpr int kLkMaxRadius = 8;    // the widest halo the launcher takes

template <int R>
__global__ void __launch_bounds__(kLkThreads)
lk_step_kernel(const float* __restrict__ I0, const float* __restrict__ I1w,
               float2* __restrict__ flow, int H, int W, float min_det) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kRw = kLkTileX + 2 * R, kRh = kLkTileY + 2 * R;
  constexpr int kRegion = kRw * kRh;
  // Ix, Iy, It over the tile and its halo: 46,080 bytes at R = 8
  __shared__ float s_ix[kRegion], s_iy[kRegion], s_it[kRegion];
  const int tid = threadIdx.y * kLkTileX + threadIdx.x;
  const int tx0 = blockIdx.x * kLkTileX, ty0 = blockIdx.y * kLkTileY;

  // 1. gradients and the temporal difference over tile and halo; zero
  // outside the image, as the convolution pads the products
  for (int i = tid; i < kRegion; i += kLkThreads) {
    const int gy = ty0 - R + i / kRw, gx = tx0 - R + i % kRw;
    float ix = 0.0f, iy = 0.0f, it = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      // reflect-101: the neighbour of the first column is the second
      const int xl = gx > 0 ? gx - 1 : 1, xr = gx < W - 1 ? gx + 1 : W - 2;
      const int yu = gy > 0 ? gy - 1 : 1, yd = gy < H - 1 ? gy + 1 : H - 2;
      const float* row = I0 + (size_t)gy * W;
      ix = __fmul_rn(__fsub_rn(__ldg(row + xr), __ldg(row + xl)), 0.5f);
      iy = __fmul_rn(__fsub_rn(__ldg(I0 + (size_t)yd * W + gx),
                               __ldg(I0 + (size_t)yu * W + gx)), 0.5f);
      it = __fsub_rn(__ldg(I1w + (size_t)gy * W + gx), __ldg(row + gx));
    }
    s_ix[i] = ix;
    s_iy[i] = iy;
    s_it[i] = it;
  }
  __syncthreads();

  const int gx = tx0 + threadIdx.x;
  const int oy0 = threadIdx.y * kLkRows;   // the column's first row in the tile
  if (gx >= W || ty0 + oy0 >= H) return;

  // 2. the window sums of the column's 8 pixels: shared row oy0 + k holds
  // row k - t of pixel t's window
  float a11[kLkRows], a12[kLkRows], a22[kLkRows], b1[kLkRows], b2[kLkRows];
#pragma unroll
  for (int t = 0; t < kLkRows; ++t) a11[t] = a12[t] = a22[t] = b1[t] = b2[t] = 0.0f;
#pragma unroll
  for (int k = 0; k < kLkRows + 2 * R; ++k) {
    const int at = (oy0 + k) * kRw + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const float ix = s_ix[at + j], iy = s_iy[at + j], it = s_it[at + j];
      const float pxx = __fmul_rn(ix, ix), pxy = __fmul_rn(ix, iy);
      const float pyy = __fmul_rn(iy, iy), pxt = __fmul_rn(ix, it);
      const float pyt = __fmul_rn(iy, it);
#pragma unroll
      for (int t = 0; t < kLkRows; ++t) {
        if (k - t >= 0 && k - t < kTaps) {   // resolved when compiled
          a11[t] = __fadd_rn(a11[t], pxx);
          a12[t] = __fadd_rn(a12[t], pxy);
          a22[t] = __fadd_rn(a22[t], pyy);
          b1[t] = __fadd_rn(b1[t], pxt);
          b2[t] = __fadd_rn(b2[t], pyt);
        }
      }
    }
  }

  // 3. the guarded 2x2 solve and the update
#pragma unroll
  for (int t = 0; t < kLkRows; ++t) {
    const int gy = ty0 + oy0 + t;
    if (gy >= H) break;
    const float det = __fsub_rn(__fmul_rn(a11[t], a22[t]), __fmul_rn(a12[t], a12[t]));
    if (!(det > min_det)) continue;   // NaN fails the guard too
    const float du =
        __fdiv_rn(__fsub_rn(__fmul_rn(a22[t], b1[t]), __fmul_rn(a12[t], b2[t])), det);
    const float dv =
        __fdiv_rn(__fsub_rn(__fmul_rn(a11[t], b2[t]), __fmul_rn(a12[t], b1[t])), det);
    float2* f = flow + (size_t)gy * W + gx;
    float2 v = *f;
    v.x = __fsub_rn(v.x, du);
    v.y = __fsub_rn(v.y, dv);
    *f = v;
  }
}

template <int R>
cudaError_t lk_step_launch(const float* I0, const float* I1w, float* flow, int H, int W,
                           float min_det, cudaStream_t stream) {
  const dim3 block(kLkTileX, kLkThreadsY);
  const dim3 grid((W + kLkTileX - 1) / kLkTileX, (H + kLkTileY - 1) / kLkTileY);
  lk_step_kernel<R><<<grid, block, 0, stream>>>(I0, I1w, reinterpret_cast<float2*>(flow),
                                                H, W, min_det);
  return cudaGetLastError();
}

}  // namespace icgn

extern "C" int icgn_lk_step(const float* I0, const float* I1w, float* flow, int H,
                            int W, int radius, float min_det, void* stream) {
  if (H < 2 || W < 2 || radius < 0 || radius > icgn::kLkMaxRadius)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radius) {
    case 0: return (int)icgn::lk_step_launch<0>(I0, I1w, flow, H, W, min_det, st);
    case 1: return (int)icgn::lk_step_launch<1>(I0, I1w, flow, H, W, min_det, st);
    case 2: return (int)icgn::lk_step_launch<2>(I0, I1w, flow, H, W, min_det, st);
    case 3: return (int)icgn::lk_step_launch<3>(I0, I1w, flow, H, W, min_det, st);
    case 4: return (int)icgn::lk_step_launch<4>(I0, I1w, flow, H, W, min_det, st);
    case 5: return (int)icgn::lk_step_launch<5>(I0, I1w, flow, H, W, min_det, st);
    case 6: return (int)icgn::lk_step_launch<6>(I0, I1w, flow, H, W, min_det, st);
    case 7: return (int)icgn::lk_step_launch<7>(I0, I1w, flow, H, W, min_det, st);
    case 8: return (int)icgn::lk_step_launch<8>(I0, I1w, flow, H, W, min_det, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
