// K9: the prefetch-pipelined dual gather.
//
// Replaces invcompcamtrack_tpu/ops/patch_prefetch.py::
// gather_ref_grad_and_windows_prefetch (body _make_kernel, plan _plan,
// post-pass _postpass): K1's four outputs per point (the 8x8 reference
// patch, its two gradient patches, the 16x16 query window), bit for bit,
// reached another way: each point's two blocks are copied ahead of the
// arithmetic that consumes them.
//
// On the TPU the copies are block DMAs named by scalar-prefetched index
// words into 24 row-shifted copies of each plane, and the taps, gradients
// and masks run as a post-pass.  None of that has a counterpart here (a
// block loads its own indices and addresses any row).  What is kept is the
// idea: a persistent grid in which each warp walks a strip of points with
// a two-stage ring in shared memory.  While the warp computes the taps,
// the gradients and the window copy of point i from stage i mod 2, the
// asynchronous copies (cp.async) of point i+1's 11x11 halo of the
// reference plane and 16x16 window of the query plane are in flight into
// the other stage.  The arithmetic after the copy is K1's own device
// functions (patch_gather.cuh) on the same floats, so the outputs equal
// K1's exactly.
//
// Inputs and outputs are K1's: a (P, Hp, Wp) stack of each plane whose
// point m reads plane m / (M / P), centers (M, 2) f32 (x, y), unpadded,
// and origins (M, 2) int32 window origins in the padded plane.  Each point's
// support start, weights and window origin come from K1's own device
// functions (dual_index, bilinear_weights in patch_gather.cuh), with the
// support and the window moved inside the plane (the dynamic_slice rule
// of the XLA twin; not the TPU kernel's clip).  A warp computes point
// i+1's indices just before it starts that point's copies, one point
// ahead of the arithmetic, as the copies are.
//
// What bounds it on an H100: bytes written, as K1 (448 floats per point).
// The copies are 4 bytes each: a window starts at an arbitrary column, so
// the 16-byte cp.async and the bulk (TMA) copies, which need 16-byte
// aligned addresses and sizes, do not apply to a raw window row.
#include <algorithm>
#include <cstdint>

#include "patch_gather.cuh"

namespace icgn {

constexpr int kHalo = (kPsz + 3) * (kPsz + 3);   // 121 floats
constexpr int kWinPix = kWin * kWin;             // 256 floats
constexpr int kStages = 2;
constexpr int kPrefetchBlocksPerSM = 4;          // persistent grid

__device__ __forceinline__ void cp_async_f32(float* smem_dst, const float* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Start the copies of one point's halo and window into one stage, from
// the point's own planes (plane_of); the halo's addresses are clamped
// into the plane exactly as load_halo's are.
__device__ __forceinline__ void start_copies(const float* __restrict__ rimg,
                                            const float* __restrict__ qimg,
                                            int Hp, int Wp, int4 id, float* halo,
                                            float* window, int lane) {
  constexpr int hs = kPsz + 3;
  for (int k = lane; k < kHalo; k += 32) {
    const int a = k / hs, b = k - a * hs;
    const int y = min(max(id.x - 1 + a, 0), Hp - 1);
    const int x = min(max(id.y - 1 + b, 0), Wp - 1);
    cp_async_f32(halo + k, rimg + (size_t)y * Wp + x);
  }
  const float* src = qimg + (size_t)id.z * Wp + id.w;
  for (int k = lane; k < kWinPix; k += 32) {
    const int a = k / kWin, b = k - a * kWin;
    cp_async_f32(window + k, src + (size_t)a * Wp + b);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_prefetch_kernel(const float* __restrict__ rimg,
                       const float* __restrict__ qimg, int Hp, int Wp,
                       const float2* __restrict__ centers,
                       const int2* __restrict__ origins, float* __restrict__ p_img,
                       float* __restrict__ p_dx, float* __restrict__ p_dy,
                       float* __restrict__ qwin, int M, int per, int pad) {
  __shared__ float halo_all[kWarpsPerBlock][kStages][kHalo];
  __shared__ float win_all[kWarpsPerBlock][kStages][kWinPix];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarpsPerBlock + warp;
  const int stride = gridDim.x * kWarpsPerBlock;
  if (first >= M) return;  // warps are independent: no block barrier below

  float2 c = centers[first];
  int4 id = dual_index(c, origins[first], Hp, Wp, pad);
  start_copies(plane_of(rimg, first, per, Hp, Wp), plane_of(qimg, first, per, Hp, Wp),
               Hp, Wp, id, halo_all[warp][0], win_all[warp][0], lane);
  cp_async_commit();
  int stage = 0;
  for (int m = first; m < M; m += stride) {
    const int next = m + stride;
    float2 c_next = c;
    int4 id_next = id;
    if (next < M) {
      c_next = centers[next];
      id_next = dual_index(c_next, origins[next], Hp, Wp, pad);
      start_copies(plane_of(rimg, next, per, Hp, Wp), plane_of(qimg, next, per, Hp, Wp),
                   Hp, Wp, id_next, halo_all[warp][stage ^ 1],
                   win_all[warp][stage ^ 1], lane);
    }
    cp_async_commit();   // (an empty group after the last point)
    cp_async_wait<1>();  // this point's group has landed; the next is in flight
    __syncwarp();        // and every lane's copies are visible to the warp
    const size_t out0 = (size_t)m * kNpix;
    patch_grad_from_halo(halo_all[warp][stage], Hp, Wp, id.x, id.y, kPsz, pad,
                         bilinear_weights(c.x, c.y), p_img + out0, p_dx + out0,
                         p_dy + out0, lane);
    copy_window(win_all[warp][stage], kWin, kWin, kWin,
                qwin + (size_t)m * kWinPix, lane);
    __syncwarp();        // the stage is free before the next copies reuse it
    c = c_next;
    id = id_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
}

}  // namespace icgn

extern "C" int icgn_gather_prefetch(const float* rimg, const float* qimg, int P,
                                    int Hp, int Wp, const float* centers,
                                    const int* origins, float* p_img,
                                    float* p_dx, float* p_dy, float* qwin,
                                    int M, int pad, void* stream) {
  const int per = icgn::points_per_plane(M, P);
  if (per < 0 || Hp < icgn::kWin || Wp < icgn::kWin)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = std::min(icgn::blocks_for(M), sms * icgn::kPrefetchBlocksPerSM);
  icgn::gather_prefetch_kernel<<<blocks, icgn::kWarpsPerBlock * 32, 0,
                                 (cudaStream_t)stream>>>(
      rimg, qimg, Hp, Wp, reinterpret_cast<const float2*>(centers),
      reinterpret_cast<const int2*>(origins), p_img, p_dx, p_dy, qwin, M, per,
      pad);
  return (int)cudaGetLastError();
}
