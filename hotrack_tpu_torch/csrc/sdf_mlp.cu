// Distilled-SDF MLP evaluation for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/sdf_mlp.py: _mlp_kernel,
// reached through _cf_impl from fused_sdf_mlp and fused_sdf_mlp_cf, and its
// per-sequence form _mlp_kernel_b, reached through _cf_impl_batched when
// several sequences are tracked with a model each. For every point, Fourier
// features -> Dense + ReLU layers -> Dense to one value -> clamp.
// Gradient-free, like the TPU kernels.
//
// Bound: operations. 71,168 operations a point at 21-128-128-128-1 against
// 16 bytes of traffic; in 3xTF32 that is three tensor-core passes at TF32's
// 495 TFLOP/s (0.904 ms for 2048 x 1024 points, against 2.228 ms for the same
// work in float32 FMA at 67 TFLOP/s). Precision: the hidden layers in 3xTF32
// on the tensor cores, the output layer and the clamp in float32, as the
// other tensor-core kernels round.
//
// Design: the MLP of sdf_mlp_wgmma.cuh (wgmma.m64n128k8 TF32, A from
// registers, the weight tiles in shared memory, pinned or streamed through a
// ring by a producer warp) on its persistent walk (wg::walk; hand_energy.cu
// runs the same walk with another point reader and store): a grid of one
// block (two consumer warpgroups at 232 registers a thread and the
// producer's warpgroup at 40, setmaxnreg) an SM. A work item is a round of 128
// consecutive points of one sequence's flattened batch, 64 a warpgroup, 16 a
// warp; a block walks the items b, b + grid, ... in ascending order and copies
// its pinned tiles again only when the walk enters another sequence.
// The points are addressed through strides, so the channels-first
// (..., 3, N) and the channels-last (..., 3) layouts need no transpose, and no
// count needs padding: the ragged last round computes zeros for its missing
// points and stores nothing for them. Each point's clamped sdf is stored once,
// 4 bytes, by lanes 0-15 of its warp (16 consecutive floats).
// Sequences: sequence s's points, packed model and output lie s times their
// per-sequence strides further on (a stride of 0 shares an input); a round
// never spans two sequences and a point's value depends on nothing but its
// inputs and model, so two launches agree bitwise and sequence s of a batched
// launch computes bitwise what an unbatched launch on s's inputs computes.
//
// bf16 (HOTRACK_SDF_BF16): a second instantiation of the same walk with the
// bf16 MLP of sdf_mlp_wgmma.cuh (wgmma m64n128k16 bf16, PackedSDF.wg16, 18
// tiles for 21-128-128-128-1, all pinned, the model's head in shared memory
// beside them), entry hotrack_sdf_mlp_bf16. Bound: one bf16 pass at 989
// TFLOP/s, 0.151 ms for 2048 x 1024 points; what holds the kernel to about
// three times that is its consumer warps' CUDA-core issue (the features'
// sincosf, the bias, ReLU and conversion of each activation, the output
// layer's FMA chains), which the core's schedule trims: one wait a layer, the
// head's loads from shared memory, two activations a conversion, and here the
// point's batch element found by a 32-bit division where the points fit (a
// 64-bit one takes several times the instructions). Its values are bitwise the
// one-k-step-at-a-time core's, and it keeps the properties above: two
// launches agree bitwise, and so do a batched launch's sequence and the
// unbatched launch on its inputs.

#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

// Point mi of a sequence's flattened batch: batch element mi / n_inner, point
// mi % n_inner; its coordinate c is at
// pts[b * batch_stride + c * chan_stride + n * point_stride]. Zeros past m.
struct Points : wg::Job {
  const float* __restrict__ pts;
  float* __restrict__ out;   // (n_seq, m)
  long long m, n_inner, batch_stride, chan_stride, point_stride, pts_seq;

  __device__ __forceinline__ void load(long long s, long long mi, float (&x)[3]) const {
    x[0] = x[1] = x[2] = 0.0f;
    if (mi >= m) return;
    // in 32 bits where every point fits in them (a 64-bit division costs
    // several times the instructions)
    const long long b = m <= 0xFFFFFFFFLL
                            ? static_cast<unsigned>(mi) / static_cast<unsigned>(n_inner)
                            : mi / n_inner;
    const long long n = mi - b * n_inner;
    const float* q = pts + s * pts_seq + b * batch_stride + n * point_stride;
    x[0] = __ldg(q);
    x[1] = __ldg(q + chan_stride);
    x[2] = __ldg(q + 2 * chan_stride);
  }
  __device__ __forceinline__ void place(long long, long long, const float (&raw)[3], float scale,
                                        float (&x)[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = __fmul_rn(raw[c], scale);
  }
  __device__ __forceinline__ void store(long long s, long long row, float sdf) const {
    out[s * m + row] = sdf;
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(wg::kThreads, 1)
sdf_mlp_kernel(const __grid_constant__ Points job, const float* __restrict__ packed,
               long long packed_seq, long long rounds, long long items, wg::Shape shape,
               int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<kBf16>(job, smem, packed, packed_seq, rounds, items, shape, pinned, ring);
}

int g_smem_limit = 0;   // what a block of this kernel may opt into
wg::Grid g_grid[2];     // by instantiation

template <bool kBf16>
int launch(const void* pts, const void* packed, void* out, long long m, long long n_inner,
           long long batch_stride, long long chan_stride, long long point_stride, int n_seq,
           long long pts_seq, long long packed_seq, int n_freqs, int n_hidden, const int* widths,
           void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, kBf16);
  if (shape.tiles == 0 || m < 1 || n_inner < 1 || n_seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rounds = (m + wg::kRoundPoints - 1) / wg::kRoundPoints;
  const long long items = rounds * n_seq;
  int pinned = 0, ring = 0;
  long long smem = 0;
  unsigned grid = 0;
  const cudaError_t err = wg::plan_launch(sdf_mlp_kernel<kBf16>, shape, g_smem_limit, items,
                                          g_grid[kBf16], pinned, ring, smem, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Points job{{}, static_cast<const float*>(pts), static_cast<float*>(out), m, n_inner,
                   batch_stride, chan_stride, point_stride, pts_seq};
  sdf_mlp_kernel<kBf16><<<grid, wg::kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      job, static_cast<const float*>(packed), packed_seq, rounds, items, shape, pinned, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts both instantiations into as much dynamic shared memory as a block may
// have on the current device, once per process.
int hotrack_sdf_mlp_init() {
  const cudaError_t err = wg::opt_in(sdf_mlp_kernel<false>, g_smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wg::opt_in(sdf_mlp_kernel<true>, g_smem_limit));
}

// pts, packed (PackedSDF.wg), out: device pointers; m points a sequence,
// n_seq sequences, out (n_seq, m); pts_seq, packed_seq: floats from one
// sequence's points or model to the next (0: shared); widths: n_hidden + 1
// host ints.
int hotrack_sdf_mlp(const void* pts, const void* packed, void* out, long long m,
                    long long n_inner, long long batch_stride, long long chan_stride,
                    long long point_stride, int n_seq, long long pts_seq, long long packed_seq,
                    int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch<false>(pts, packed, out, m, n_inner, batch_stride, chan_stride, point_stride,
                       n_seq, pts_seq, packed_seq, n_freqs, n_hidden, widths, stream);
}

// The same in bf16: packed is PackedSDF.wg16.
int hotrack_sdf_mlp_bf16(const void* pts, const void* packed, void* out, long long m,
                         long long n_inner, long long batch_stride, long long chan_stride,
                         long long point_stride, int n_seq, long long pts_seq,
                         long long packed_seq, int n_freqs, int n_hidden, const int* widths,
                         void* stream) {
  return launch<true>(pts, packed, out, m, n_inner, batch_stride, chan_stride, point_stride,
                      n_seq, pts_seq, packed_seq, n_freqs, n_hidden, widths, stream);
}

}  // extern "C"
