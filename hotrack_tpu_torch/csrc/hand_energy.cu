// Fused per-vertex hand energy terms for Hopper (sm_90a).
//
// Replaces the TPU kernel of hotrack_tpu/ops/pallas/hand_energy.py
// (_energy_kernel on _energy_core, reached through _fused_impl from
// fused_hand_energy): for every camera-frame hand vertex x, in one pass,
//   sdf = clamp(MLP(fourier(scale * (R^T x - R^T t))))   (sdf_mlp_core.cuh)
//   hit = the background mask's bit at the vertex's pixel
//         (iy, ix) = clip(int((x_y / x_z) fy + cy)), clip(int((x_x / x_z) fx + cx))
//                                                          (hand_energy_core.cuh)
// so the vertices are read once, and neither the object-frame points nor the
// pixel coordinates reach device memory. Gradient-free, like the TPU kernel.
//
// Bound: operations (71,168 float32 operations a vertex at 21-128-128-128-1
// against 12 bytes in and 8 out). Precision: float32 FMA with float32
// accumulation in the MLP, no tensor cores, sinf / cosf; the transform and
// the projection with every step rounded on its own, as the plain version
// computes them, so the hit is exact against it.
//
// Design: one block of 256 threads per tile of 128 vertices of the flattened
// (M, 3) array; both halves of the block load the slot's vertex, the lower
// half writes the sdf after the MLP, the upper half looks the pixel up while
// it would otherwise wait. The ragged last tile computes zeros for its
// missing vertices and writes nothing for them.

#include "hand_energy_core.cuh"
#include "sdf_mlp_core.cuh"

namespace {

using namespace hotrack;

__global__ void __launch_bounds__(kMlpThreads, 2)
hand_energy_kernel(const float* __restrict__ pts, const float* __restrict__ frame_g,
                   const unsigned char* __restrict__ mask, const float* __restrict__ packed,
                   float* __restrict__ sdf_out, float* __restrict__ hit_out, long long m, int h,
                   int w, MlpShape shape) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  float* red = act + kActFloats;
  const float scale = __ldg(packed), clamp = __ldg(packed + 1);
  const float* freqs = packed + 4;
  const float* layers = freqs + round_up4(shape.n_freqs);
  float frame[kFrameFloats];
#pragma unroll
  for (int i = 0; i < kFrameFloats; ++i) frame[i] = __ldg(frame_g + i);

  const long long mi = static_cast<long long>(blockIdx.x) * kTilePoints
      + (threadIdx.x & (kTilePoints - 1));
  float x = 0.0f, y = 0.0f, z = 1.0f;
  float obj[3] = {0.0f, 0.0f, 0.0f};
  if (mi < m) {
    x = __ldg(pts + 3 * mi);
    y = __ldg(pts + 3 * mi + 1);
    z = __ldg(pts + 3 * mi + 2);
    scaled_object_frame(frame, scale, x, y, z, obj);
  }
  build_features(act, freqs, shape.n_freqs, obj[0], obj[1], obj[2]);
  __syncthreads();
  if (threadIdx.x >= kTilePoints && mi < m)
    hit_out[mi] = silhouette_hit(mask, h, w, frame, x, y, z);
  const float s = mlp_tile(act, red, layers, shape, clamp);
  if (threadIdx.x < kTilePoints && mi < m) sdf_out[mi] = s;
}

}  // namespace

extern "C" {

// Opts the kernel into its 72 KB of dynamic shared memory, once per process.
int hotrack_hand_energy_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      hand_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlpSmemBytes));
}

// pts (m, 3), frame (16,), mask (h, ceil(w / 8)) uint8, packed, sdf (m,), hit (m,):
// device pointers; widths: n_hidden + 1 host ints.
int hotrack_hand_energy(const void* pts, const void* frame, const void* mask,
                        const void* packed, void* sdf, void* hit, long long m, int h, int w,
                        int n_freqs, int n_hidden, const int* widths, void* stream) {
  const MlpShape shape = make_mlp_shape(n_freqs, n_hidden, widths);
  if (mlp_shape_error(shape) || m < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (m + kTilePoints - 1) / kTilePoints;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  hand_energy_kernel<<<static_cast<unsigned>(tiles), kMlpThreads, kMlpSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(frame),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(packed),
      static_cast<float*>(sdf), static_cast<float*>(hit), m, h, w, shape);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
