// Per-vertex pieces shared by the hand-energy kernels (mask_lookup.cu,
// hand_energy.cu, hand_energy_skin.cu): the packed background mask's bit at a
// pixel, the pinhole projection to that pixel, and the vertex's coordinates
// in the object's frame.
//
// Computes what `_energy_core` of hotrack_tpu/ops/pallas/hand_energy.py
// computes around its MLP. Not carried over from the TPU: the one-hot row
// selection by matrix products, the two-level and int8 packing, float words.
// Here a mask bit is one byte load and a shift: the mask is uint8
// (H, ceil(W / 8)), bit b of byte k of a row = pixel 8 k + b
// (hotrack_tpu_torch/ops/mask_lookup.py pack_mask); 38,400 bytes at
// 480 x 640, read through L1/L2.
//
// Exactness: the plain PyTorch version computes (a / z) * f + c and
// ((r0 x + r1 y) + r2 z) - rt as separate float32 operations, each rounded.
// The same here, with the round-to-nearest intrinsics so that the compiler
// contracts nothing into a fused multiply-add; the pixel is then equal to the
// plain version's, and so is the hit. The conversion truncates toward zero and
// saturates (NaN gives 0), then the clip brings the pixel into the image: a
// vertex with z <= 0 gets a pixel on the border, never an address outside
// the mask.
//
// frame (16 floats in device memory, ops/hand_energy.py hand_frame):
//   [0..8] R^T row-major  [9..11] R^T t  [12] fx [13] fy [14] cx [15] cy

#pragma once

#include <cuda_runtime.h>

namespace hotrack {

constexpr int kFrameFloats = 16;

__device__ __forceinline__ int clip_int(int v, int hi) { return min(max(v, 0), hi); }

// The mask's bit at pixel (iy, ix), 0.0f or 1.0f; the indices are clipped.
__device__ __forceinline__ float mask_bit(const unsigned char* __restrict__ mask, int h, int w,
                                          int iy, int ix) {
  iy = clip_int(iy, h - 1);
  ix = clip_int(ix, w - 1);
  const int wp = (w + 7) >> 3;
  const unsigned word = __ldg(mask + static_cast<long long>(iy) * wp + (ix >> 3));
  return static_cast<float>((word >> (ix & 7)) & 1u);
}

// clip(int((a / z) * f + c), 0, hi), each step rounded to nearest on its own.
__device__ __forceinline__ int pixel_coord(float a, float z, float f, float c, int hi) {
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(a, z), f), c);
  return clip_int(__float2int_rz(v), hi);
}

// Whether the camera-frame vertex (x, y, z) projects onto a background pixel.
__device__ __forceinline__ float silhouette_hit(const unsigned char* __restrict__ mask, int h,
                                                int w, const float* frame, float x, float y,
                                                float z) {
  const int iy = pixel_coord(y, z, frame[13], frame[15], h - 1);
  const int ix = pixel_coord(x, z, frame[12], frame[14], w - 1);
  return mask_bit(mask, h, w, iy, ix);
}

// scale * (((r_c0 x + r_c1 y) + r_c2 z) - (R^T t)_c) for c = 0, 1, 2: the
// vertex in the object's frame, scaled as the MLP's features want it.
__device__ __forceinline__ void scaled_object_frame(const float* frame, float scale, float x,
                                                    float y, float z, float (&out)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = __fadd_rn(__fmul_rn(frame[3 * c], x), __fmul_rn(frame[3 * c + 1], y));
    v = __fadd_rn(v, __fmul_rn(frame[3 * c + 2], z));
    v = __fsub_rn(v, frame[9 + c]);
    out[c] = __fmul_rn(v, scale);
  }
}

}  // namespace hotrack
