// Distilled-SDF MLP evaluation for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/sdf_mlp.py: _mlp_kernel,
// reached through _cf_impl from fused_sdf_mlp and fused_sdf_mlp_cf, and its
// per-sequence form _mlp_kernel_b, reached through _cf_impl_batched when
// several sequences are tracked with a model each. For every point, Fourier
// features -> Dense + ReLU layers -> Dense to one value -> clamp.
// Gradient-free, like the TPU kernels.
//
// Bound: operations (71,168 float32 operations a point at 21-128-128-128-1
// against 16 bytes of traffic). Precision: float32 FMA, float32 accumulation,
// no tensor cores; sinf / cosf, never the fast intrinsics.
//
// Design: one block of 256 threads per tile of 128 points; the whole network
// runs on the tile inside shared memory and registers (sdf_mlp_core.cuh), so
// the points are read once and the sdf written once. The points are addressed
// through strides, so the channels-first (..., 3, N) and the channels-last
// (..., 3) layouts need no transpose, and no count needs padding: the ragged
// last tile computes zeros for its missing points and writes nothing for them.
// Sequences: blockIdx.y is the sequence s; its points, its packed model and
// its output lie s times their per-sequence strides further on (a stride of 0
// shares an input between the sequences). An unbatched launch is the case of
// one sequence, so sequence s of a batched launch computes bitwise what an
// unbatched launch on s's inputs computes.

#include "sdf_mlp_core.cuh"

namespace {

using namespace hotrack;

// Point m of a sequence's flattened batch: batch element m / n_inner, point
// m % n_inner; its coordinate c is at
// pts[s * pts_seq + b * batch_stride + c * chan_stride + n * point_stride].
__global__ void __launch_bounds__(kMlpThreads, 2)
sdf_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ packed,
               float* __restrict__ out, long long m, long long n_inner,
               long long batch_stride, long long chan_stride, long long point_stride,
               long long pts_seq, long long packed_seq, MlpShape shape) {
  extern __shared__ float4 smem4[];
  pts += blockIdx.y * pts_seq;
  packed += blockIdx.y * packed_seq;
  out += blockIdx.y * m;
  float* act = reinterpret_cast<float*>(smem4);
  float* red = act + kActFloats;
  const float scale = __ldg(packed), clamp = __ldg(packed + 1);
  const float* freqs = packed + 4;
  const float* layers = freqs + round_up4(shape.n_freqs);

  const long long mi = static_cast<long long>(blockIdx.x) * kTilePoints
      + (threadIdx.x & (kTilePoints - 1));
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  if (mi < m) {
    const long long b = mi / n_inner, n = mi - b * n_inner;
    const float* q = pts + b * batch_stride + n * point_stride;
    x0 = __fmul_rn(__ldg(q), scale);
    x1 = __fmul_rn(__ldg(q + chan_stride), scale);
    x2 = __fmul_rn(__ldg(q + 2 * chan_stride), scale);
  }
  build_features(act, freqs, shape.n_freqs, x0, x1, x2);
  __syncthreads();
  const float s = mlp_tile(act, red, layers, shape, clamp);
  if (threadIdx.x < kTilePoints && mi < m) out[mi] = s;
}

}  // namespace

extern "C" {

// Opts the kernel into its 72 KB of dynamic shared memory, once per process.
int hotrack_sdf_mlp_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      sdf_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlpSmemBytes));
}

// pts, packed, out: device pointers; m points a sequence, n_seq sequences,
// out (n_seq, m); pts_seq, packed_seq: floats from one sequence's points or
// model to the next (0: shared); widths: n_hidden + 1 host ints.
int hotrack_sdf_mlp(const void* pts, const void* packed, void* out, long long m,
                    long long n_inner, long long batch_stride, long long chan_stride,
                    long long point_stride, int n_seq, long long pts_seq, long long packed_seq,
                    int n_freqs, int n_hidden, const int* widths, void* stream) {
  const MlpShape shape = make_mlp_shape(n_freqs, n_hidden, widths);
  if (mlp_shape_error(shape) || m < 1 || n_inner < 1 || n_seq < 1 || n_seq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (m + kTilePoints - 1) / kTilePoints;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_seq));
  sdf_mlp_kernel<<<grid, kMlpThreads, kMlpSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(packed),
      static_cast<float*>(out), m, n_inner, batch_stride, chan_stride, point_stride, pts_seq,
      packed_seq, shape);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
