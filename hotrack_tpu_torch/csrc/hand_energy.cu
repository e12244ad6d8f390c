// Fused per-vertex hand energy terms for Hopper (sm_90a).
//
// Replaces the TPU kernel of hotrack_tpu/ops/pallas/hand_energy.py
// (_energy_kernel on _energy_core, reached through _fused_impl from
// fused_hand_energy): for every camera-frame hand vertex x, in one pass,
//   sdf = clamp(MLP(fourier(scale * (R^T x - R^T t))))   (sdf_mlp_wgmma.cuh)
//   hit = the background mask's bit at the vertex's pixel
//         (iy, ix) = clip(int((x_y / x_z) fy + cy)), clip(int((x_x / x_z) fx + cx))
//                                                          (hand_energy_core.cuh)
// so the vertices are read once, and neither the object-frame points nor the
// pixel coordinates reach device memory. Gradient-free, like the TPU kernel.
//
// Bound: operations, the MLP's 3 x 71,168 tensor-core operations a vertex at
// 21-128-128-128-1 at TF32's 495 TFLOP/s, plus 27 float32 operations for the
// transform and the projection, against 12 bytes in and 8 out (1.720 ms at
// 5120 x 778 vertices). Precision: the MLP of sdf_mlp.cu (#3), 3xTF32 on the
// tensor cores with the output layer and the clamp in float32; the
// transform and the projection with every step rounded on its own, as the
// plain version computes them. So `sdf` is bitwise #3 on the plain version's
// object-frame points (ops/hand_energy.object_frame) and `hit` bitwise the
// mask lookup (#5) at its pixels (pixel_coords): exact against the plain
// version.
//
// Design: the persistent walk of sdf_mlp.cu (wg::walk: two consumer
// warpgroups run wgmma m64n128k8 in 3xTF32 on 128-vertex rounds, the producer
// warp streams the weight tiles the block cannot keep), with two pieces of
// its own. A consumer reads a vertex's three floats a round ahead and moves
// it into the object's frame, scaled (scaled_object_frame, the frame's 12
// floats loaded where the round starts, so that they hold no register across
// the MLP), when its round starts. The hit runs off the consumers' path: the
// producer warpgroup's three other warps, which walk the same items and wait
// on nothing but the block's barriers, project each vertex of the item and
// look its bit up (coalesced, 128 vertices by 96 threads). The ragged last
// round computes on zeros for its missing vertices and stores neither an sdf
// nor a hit for them. A vertex's values depend on its inputs only: two
// launches agree bitwise.
//
// bf16 (HOTRACK_SDF_BF16): a second instantiation with the bf16 MLP of
// sdf_mlp_wgmma.cuh (PackedSDF.wg16, the model's head in shared memory beside
// the pinned tiles), entry hotrack_hand_energy_bf16: its sdf is bitwise
// sdf_mlp.cu's bf16 instantiation on object_frame's points, its hit the same
// as above. Bound: one bf16 pass at 989 TFLOP/s plus the 27 float32
// operations, 0.288 ms at 5120 x 778 vertices; as for #3, the consumer warps'
// CUDA-core issue (the features, the epilogues, the output layer, here also
// the frame transform) holds the kernel to about three times it, and the
// core's schedule (one wait a layer, the head in shared memory, two
// activations a conversion) trims it; the values are bitwise the
// one-k-step-at-a-time core's.

#include "hand_energy_core.cuh"
#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

struct Vertices : wg::Job {
  const float* __restrict__ pts;      // (m, 3) camera frame
  const float* __restrict__ frame;    // (16,) ops/hand_energy.hand_frame
  const unsigned char* __restrict__ mask;
  float* __restrict__ sdf;
  float* __restrict__ hit;
  long long m;
  int h, w;

  __device__ __forceinline__ void load(long long, long long row, float (&x)[3]) const {
    x[0] = x[1] = x[2] = 0.0f;
    if (row >= m) return;
    x[0] = __ldg(pts + 3 * row);
    x[1] = __ldg(pts + 3 * row + 1);
    x[2] = __ldg(pts + 3 * row + 2);
  }
  __device__ __forceinline__ void place(long long, long long, const float (&raw)[3], float scale,
                                        float (&x)[3]) const {
    float f[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) f[i] = wg::frame_at(frame + i);
    scaled_object_frame(f, scale, raw[0], raw[1], raw[2], x);
  }
  __device__ __forceinline__ void store(long long, long long row, float value) const {
    sdf[row] = value;
  }
  __device__ __forceinline__ void aside(long long, long long round, int t) const {
    for (int v = t; v < wg::kRoundPoints; v += wg::kAsideThreads) {
      const long long row = round * wg::kRoundPoints + v;
      if (row < m)
        hit[row] = silhouette_hit(mask, h, w, frame, __ldg(pts + 3 * row),
                                  __ldg(pts + 3 * row + 1), __ldg(pts + 3 * row + 2));
    }
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(wg::kThreads, 1)
hand_energy_kernel(const __grid_constant__ Vertices job, const float* __restrict__ packed,
                   long long rounds, wg::Shape shape, int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<kBf16>(job, smem, packed, 0, rounds, rounds, shape, pinned, ring);
}

int g_smem_limit = 0;   // what a block of this kernel may opt into
wg::Grid g_grid[2];     // by instantiation

template <bool kBf16>
int launch(const void* pts, const void* frame, const void* mask, const void* packed, void* sdf,
           void* hit, long long m, int h, int w, int n_freqs, int n_hidden, const int* widths,
           void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, kBf16);
  if (shape.tiles == 0 || m < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rounds = (m + wg::kRoundPoints - 1) / wg::kRoundPoints;
  int pinned = 0, ring = 0;
  long long smem = 0;
  unsigned grid = 0;
  const cudaError_t err = wg::plan_launch(hand_energy_kernel<kBf16>, shape, g_smem_limit, rounds,
                                          g_grid[kBf16], pinned, ring, smem, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Vertices job{{}, static_cast<const float*>(pts), static_cast<const float*>(frame),
                     static_cast<const unsigned char*>(mask), static_cast<float*>(sdf),
                     static_cast<float*>(hit), m, h, w};
  hand_energy_kernel<kBf16><<<grid, wg::kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      job, static_cast<const float*>(packed), rounds, shape, pinned, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts both instantiations into as much dynamic shared memory as a block may
// have on the current device, once per process.
int hotrack_hand_energy_init() {
  const cudaError_t err = wg::opt_in(hand_energy_kernel<false>, g_smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wg::opt_in(hand_energy_kernel<true>, g_smem_limit));
}

// pts (m, 3), frame (16,), mask (h, ceil(w / 8)) uint8, packed (PackedSDF.wg),
// sdf (m,), hit (m,): device pointers; widths: n_hidden + 1 host ints.
int hotrack_hand_energy(const void* pts, const void* frame, const void* mask,
                        const void* packed, void* sdf, void* hit, long long m, int h, int w,
                        int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch<false>(pts, frame, mask, packed, sdf, hit, m, h, w, n_freqs, n_hidden, widths,
                       stream);
}

// The same in bf16: packed is PackedSDF.wg16.
int hotrack_hand_energy_bf16(const void* pts, const void* frame, const void* mask,
                             const void* packed, void* sdf, void* hit, long long m, int h,
                             int w, int n_freqs, int n_hidden, const int* widths,
                             void* stream) {
  return launch<true>(pts, frame, mask, packed, sdf, hit, m, h, w, n_freqs, n_hidden, widths,
                      stream);
}

}  // extern "C"
