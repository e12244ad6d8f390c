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
// ring by a producer warp) on a persistent grid of one block (two consumer
// warpgroups at 232 registers a thread and the producer's warpgroup at 40,
// setmaxnreg) an SM. A work item is a round of 128 consecutive points of one
// sequence's flattened batch, 64 a warpgroup, 16 a warp; a block walks the
// items b, b + grid, ... in ascending order and copies its pinned tiles again
// only when the walk enters another sequence.
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

#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

// Point mi of a sequence's flattened batch: batch element mi / n_inner, point
// mi % n_inner; its coordinate c is at
// pts[b * batch_stride + c * chan_stride + n * point_stride]. Zeros past m.
__device__ __forceinline__ void read_point(const float* __restrict__ pts, long long mi,
                                           long long m, long long n_inner,
                                           long long batch_stride, long long chan_stride,
                                           long long point_stride, float (&x)[3]) {
  x[0] = x[1] = x[2] = 0.0f;
  if (mi >= m) return;
  const long long b = mi / n_inner, n = mi - b * n_inner;
  const float* q = pts + b * batch_stride + n * point_stride;
  x[0] = __ldg(q);
  x[1] = __ldg(q + chan_stride);
  x[2] = __ldg(q + 2 * chan_stride);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
sdf_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ packed,
               float* __restrict__ out, long long m, long long n_inner,
               long long batch_stride, long long chan_stride, long long point_stride,
               long long pts_seq, long long packed_seq, long long rounds, long long items,
               wg::Shape shape, int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  wg::Tiles w;
  w.pinned_base = wg::smem_addr(smem);
  w.ring_base = w.pinned_base + static_cast<uint32_t>(pinned) * wg::kTileBytes;
  w.full = w.ring_base + static_cast<uint32_t>(ring) * wg::kTileBytes;
  w.empty = w.full + 8 * ring;
  w.pinned = pinned;
  w.next = 0;
  const uint32_t pin = w.empty + 8 * ring;   // the pinned tiles' copy
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      wg::mbar_init(w.full + 8 * i, 1);
      wg::mbar_init(w.empty + 8 * i, wg::kConsumerWarps);
    }
    wg::mbar_init(pin, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  long long loaded = -1;
  if (warp >= wg::kConsumerWarps) {   // the producer's warpgroup
    wg::setmaxnreg_dec<wg::kProducerRegs>();
    const bool copies = warp == wg::kProducerWarp;   // the other three only meet the barriers
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const long long s = item / rounds;
      const float* tiles = wg::net_of(packed + s * packed_seq, shape).tiles;
      if (s != loaded) {   // the consumers are done with the previous model's tiles
        __syncthreads();
        loaded = s;
        if (copies) {
          if (lane == 0)
            wg::mbar_expect_tx(pin, static_cast<uint32_t>(pinned) * wg::kTileBytes);
          __syncwarp();
          for (int t = lane; t < pinned; t += 32)
            wg::bulk_copy(w.pinned_base + static_cast<uint32_t>(t) * wg::kTileBytes,
                          tiles + static_cast<long long>(t) * wg::kTileFloats, wg::kTileBytes,
                          pin);
        }
      }
      if (!copies) continue;
      for (int t = pinned; t < shape.tiles; ++t) {
        const uint32_t n = w.next++;   // streaming, the ring has kRing slots
        const uint32_t slot = n % wg::kRing;
        wg::mbar_wait(w.empty + 8 * slot, ((n / wg::kRing) & 1) ^ 1);
        if (lane == 0) {
          wg::mbar_expect_tx(w.full + 8 * slot, wg::kTileBytes);
          wg::bulk_copy(w.ring_base + slot * wg::kTileBytes,
                        tiles + static_cast<long long>(t) * wg::kTileFloats, wg::kTileBytes,
                        w.full + 8 * slot);
        }
        __syncwarp();
      }
    }
    return;
  }

  wg::setmaxnreg_inc<wg::kConsumerRegs>();
  const int g = lane >> 2;
  uint32_t reloads = 0;
  // the rows' points of the walk's next item are read a round ahead
  float na[3], nb[3];
  const auto fetch = [&](long long item) {
    const long long s = item / rounds;
    const long long row = (item - s * rounds) * wg::kRoundPoints + warp * 16 + g;
    read_point(pts + s * pts_seq, row, m, n_inner, batch_stride, chan_stride, point_stride, na);
    read_point(pts + s * pts_seq, row + 8, m, n_inner, batch_stride, chan_stride, point_stride,
               nb);
  };
  if (blockIdx.x < items) fetch(blockIdx.x);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long s = item / rounds;
    const wg::Net net = wg::net_of(packed + s * packed_seq, shape);
    if (s != loaded) {
      __syncthreads();
      wg::mbar_wait(pin, reloads++ & 1);
      loaded = s;
    }
    float xa[3], xb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xa[c] = __fmul_rn(na[c], net.scale);
      xb[c] = __fmul_rn(nb[c], net.scale);
    }
    if (item + gridDim.x < items) fetch(item + gridDim.x);
    const float2 sdf = wg::mlp_rows(xa, xb, net, shape, w);
    // lane l < 16 stores the warp's row l, which lanes 4 (l % 8) .. + 3 hold
    const long long base = (item - s * rounds) * wg::kRoundPoints + warp * 16;
    const float lo = __shfl_sync(0xffffffffu, sdf.x, 4 * (lane & 7));
    const float hi = __shfl_sync(0xffffffffu, sdf.y, 4 * (lane & 7));
    if (lane < 16 && base + lane < m) out[s * m + base + lane] = lane < 8 ? lo : hi;
  }
}

int g_smem_limit = 0;           // what a block of this kernel may opt into
long long g_grid_smem = -1;     // the persistent grid's size, remembered per smem size
int g_grid_blocks = 0;

}  // namespace

extern "C" {

// Opts the kernel into as much dynamic shared memory as a block may have on
// the current device, once per process.
int hotrack_sdf_mlp_init() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&g_smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      sdf_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_limit));
}

// pts, packed (PackedSDF.wg), out: device pointers; m points a sequence,
// n_seq sequences, out (n_seq, m); pts_seq, packed_seq: floats from one
// sequence's points or model to the next (0: shared); widths: n_hidden + 1
// host ints.
int hotrack_sdf_mlp(const void* pts, const void* packed, void* out, long long m,
                    long long n_inner, long long batch_stride, long long chan_stride,
                    long long point_stride, int n_seq, long long pts_seq, long long packed_seq,
                    int n_freqs, int n_hidden, const int* widths, void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths);
  if (shape.tiles == 0 || m < 1 || n_inner < 1 || n_seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int pinned = 0, ring = 0;
  wg::plan(shape, g_smem_limit, pinned, ring);
  if (pinned < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = wg::smem_bytes(pinned, ring);
  if (smem != g_grid_smem) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sdf_mlp_kernel, wg::kThreads,
                                                          static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_grid_smem = smem;
    g_grid_blocks = sms * per_sm;
  }
  const long long rounds = (m + wg::kRoundPoints - 1) / wg::kRoundPoints;
  const long long items = rounds * n_seq;
  const unsigned grid = static_cast<unsigned>(items < g_grid_blocks ? items : g_grid_blocks);
  sdf_mlp_kernel<<<grid, wg::kThreads, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(packed),
      static_cast<float*>(out), m, n_inner, batch_stride, chan_stride, point_stride, pts_seq,
      packed_seq, rounds, items, shape, pinned, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
