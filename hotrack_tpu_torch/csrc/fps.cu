// Farthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel hotrack_tpu/ops/pallas/fps.py:_fps_kernel and
// computes what it computes (not how): xyz (B, N, 3) f32 and an optional
// validity mask (B, N) -> indices (B, npoint) int32. The scan seeds at index
// 0 (even when point 0 is invalid), keeps a running min of the squared
// distance to the chosen set, and picks the argmax each step with ties going
// to the lowest index. Invalid points start at -1 and are never picked while
// a valid point is left.
//
// What bounds it: FPS is a chain of npoint - 1 dependent argmax steps over
// one cloud, so it is bound by the latency of a step (the distances, the
// running minima, a reduction of N candidates and the winner's coordinates
// reaching every thread), not by bytes: the cloud is read from device memory
// once. The design keeps what a step touches in registers and takes the
// reduction in as few dependent rounds as the card allows:
//
//   - N <= 1024 (the model's sa1 and sa2 clouds): one warp a cloud, several
//     clouds a block (one a warp, no block barrier). Lane l holds points
//     l, l + 32, ... (up to 32 a lane) and their running minima. A lane picks
//     its best (value, index) in up to four select chains over its points,
//     merged by value, then index. The warp's winner takes two hardware warp
//     reductions (redux.sync): the largest value as an order-preserving
//     unsigned key, then the lowest index among the lanes that hold it (a
//     5-round __shfl_xor_sync butterfly of the pair measured 15-20% slower a
//     step). Its coordinates are one 16-byte load from a float4 copy of the
//     cloud in shared memory (as fast as shuffling them from the owning lane,
//     which must carry them through its selects).
//   - N > 1024 (prepare_batch's masked clouds): one block a cloud, thread t
//     holding points t, t + T, ... in registers (N <= 8192; above that their
//     coordinates are read from the shared copy and only the minima sit in
//     registers). Each warp reduces as above and lane 0 writes the warp's
//     (key, index) to a double-buffered slot; after the step's one barrier
//     every warp reduces the slots itself, the same way, so no second
//     barrier is needed, and loads the winner from the shared copy.
//
// Both kernels declare one block an SM in __launch_bounds__: without it the
// compiler kept the registers of a step to two temporaries and issued one
// dependent float operation every other cycle (a 512-point cloud took 0.081
// ms, 0.055 with it, on an H100). hotrack_fps chooses the launch layout
// (points a thread, threads a cloud) from N alone.
//
// Rounding: the distance is ((dx*dx) + (dy*dy)) + (dz*dz) with explicit
// round-to-nearest intrinsics, so no FMA contraction changes it; the plain
// PyTorch version (ops/pointops.py:_farthest_point_sample_torch) and the JAX
// reference sum in the same order, and any rounding difference would change
// the sample set through the argmax chain.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpPoints = 1024;      // the warp kernel's largest cloud (32 a lane)
constexpr int kBlockThreads = 512;     // the block kernel's most threads a cloud
constexpr int kRegisterPoints = 8192;  // 16 a thread in registers at 512 threads
constexpr int kMaxPoints = 14336;      // the float4 copy within a block's shared memory
constexpr int kCloudsPerBlock = 4;     // warps (clouds) a block of the warp kernel, at most

// A candidate of a thread, warp or block: the larger value wins, then the
// lower index.
struct Cand {
  float v;
  int i;
};

// a < b as floats (no NaN) exactly when order_key(a) < order_key(b)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One step over a thread's P points (point k has index first + k * stride
// and coordinates coords(k)): lower each running minimum d[k] by the distance
// to the centre, then pick the thread's best in up to four select chains
// (chain c takes the points k = c mod C in ascending k, so a strict '>' keeps
// its lowest index), merged by value, then index. No branches: the points'
// distances are independent, and the chains keep the selects short.
// Padding points hold -inf and never win against a real point.
template <int P, typename Coords>
__device__ __forceinline__ Cand thread_step(Coords coords, float (&d)[P], int first, int stride,
                                            float4 centre) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float3 q = coords(k);
    const float dx = __fsub_rn(q.x, centre.x);
    const float dy = __fsub_rn(q.y, centre.y);
    const float dz = __fsub_rn(q.z, centre.z);
    d[k] = fminf(d[k], __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz)));  // invalid points stay at -1
  }
  constexpr int C = P < 4 ? P : 4;
  float bv[C];
  int bk[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bv[c] = d[c];
    bk[c] = c;
  }
#pragma unroll
  for (int k = C; k < P; ++k) {
    const bool better = d[k] > bv[k % C];
    bv[k % C] = better ? d[k] : bv[k % C];
    bk[k % C] = better ? k : bk[k % C];
  }
#pragma unroll
  for (int c = 1; c < C; ++c) {
    // bitwise, not short-circuit: a short-circuit compiled to divergent branches
    const bool better = (bv[c] > bv[0]) | ((bv[c] == bv[0]) & (bk[c] < bk[0]));
    bv[0] = better ? bv[c] : bv[0];
    bk[0] = better ? bk[c] : bk[0];
  }
  return {bv[0], first + bk[0] * stride};
}

// The winning index among a warp's candidates: the largest key, then the
// lowest index among the lanes that hold it (two hardware reductions; every
// lane gets the result and `top`).
__device__ __forceinline__ int warp_winner(unsigned key, int i, unsigned& top) {
  top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == top ? i : INT_MAX);
}

// The shared-memory address of `p`, made opaque so that the compiler keeps
// it in a register instead of recomputing it inside the step loop.
__device__ __forceinline__ unsigned shared_address(const void* p) {
  unsigned a;
  asm("mov.b32 %0, %1;" : "=r"(a) : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return a;
}

// The float4 at shared address `base` + 16 i: the next step's centre.
__device__ __forceinline__ float4 centre_at(unsigned base, int i) {
  float4 c;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(c.x), "=f"(c.y), "=f"(c.z), "=f"(c.w)
               : "r"(base + 16u * static_cast<unsigned>(i))
               : "memory");
  return c;
}

// Loads point i of a cloud (3 floats a point) into registers and its float4
// copy into shared memory; returns its starting running minimum.
__device__ __forceinline__ float load_point(const float* p, const uint8_t* m, int i, int n,
                                            float4* copy, float3& q) {
  if (i >= n) {
    q = make_float3(0.0f, 0.0f, 0.0f);
    return -INFINITY;
  }
  q = make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
  copy[i] = make_float4(q.x, q.y, q.z, 0.0f);
  return (m == nullptr || m[i] != 0) ? 1e10f : -1.0f;
}

// One warp a cloud; lane l holds points l + 32 k, k < P. Dynamic shared
// memory: a float4 copy of each of the block's clouds, 32 P points apart.
template <int P>
__global__ void __launch_bounds__(32 * kCloudsPerBlock, 1)
    fps_kernel_warp(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                    int* __restrict__ out, int b, int n, int npoint) {
  extern __shared__ float4 clouds[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= b) return;  // a whole warp; the kernel has no block barrier
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* m = mask == nullptr ? nullptr : mask + static_cast<size_t>(row) * n;
  int* o = out + static_cast<size_t>(row) * npoint;
  float4* copy = clouds + warp * 32 * P;

  float x[P], y[P], z[P], d[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float3 q;
    d[k] = load_point(p, m, lane + 32 * k, n, copy, q);
    x[k] = q.x;
    y[k] = q.y;
    z[k] = q.z;
  }
  __syncwarp();
  const unsigned base = shared_address(copy);
  float4 centre = centre_at(base, 0);
  if (lane == 0) o[0] = 0;
  const auto coords = [&](int k) { return make_float3(x[k], y[k], z[k]); };
  for (int it = 1; it < npoint; ++it) {
    const Cand t = thread_step<P>(coords, d, lane, 32, centre);
    unsigned top;
    const int far = warp_winner(order_key(t.v), t.i, top);
    centre = centre_at(base, far);
    if (lane == 0) o[it] = far;
  }
}

// One block of T threads a cloud; thread t holds points t + T k, k < P, in
// registers, or (kSharedXyz) reads their coordinates from the shared copy.
template <int P, bool kSharedXyz>
__global__ void __launch_bounds__(kBlockThreads, 1)
    fps_kernel_block(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                     int* __restrict__ out, int n, int npoint) {
  extern __shared__ float4 copy[];
  __shared__ unsigned slot_key[2][kBlockThreads / 32];
  __shared__ int slot_i[2][kBlockThreads / 32];

  const int row = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* m = mask == nullptr ? nullptr : mask + static_cast<size_t>(row) * n;
  int* o = out + static_cast<size_t>(row) * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, nwarps = threads >> 5;

  constexpr int R = kSharedXyz ? 1 : P;  // coordinates held in registers
  float x[R], y[R], z[R], d[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float3 q;
    d[k] = load_point(p, m, tid + threads * k, n, copy, q);
    if constexpr (!kSharedXyz) {
      x[k] = q.x;
      y[k] = q.y;
      z[k] = q.z;
    }
  }
  __syncthreads();
  const unsigned base = shared_address(copy);
  float4 centre = centre_at(base, 0);
  if (tid == 0) o[0] = 0;
  const auto coords = [&](int k) {
    if constexpr (kSharedXyz) {
      const float4 q = copy[min(tid + threads * k, n - 1)];  // padding: d is -inf, never wins
      return make_float3(q.x, q.y, q.z);
    } else {
      return make_float3(x[k], y[k], z[k]);
    }
  };
  for (int it = 1; it < npoint; ++it) {
    const Cand t = thread_step<P>(coords, d, tid, threads, centre);
    const unsigned key = order_key(t.v);
    unsigned top;
    const int wi = warp_winner(key, t.i, top);
    const int buf = it & 1;
    if (lane == 0) {
      slot_key[buf][warp] = top;
      slot_i[buf][warp] = wi;
    }
    __syncthreads();
    // Every warp reduces the slots itself. A warp writes buffer `buf` again
    // two steps later, after the next barrier, which every warp passes only
    // once it has read this step's slots.
    const bool has = lane < nwarps;
    unsigned stop;
    const int far = warp_winner(has ? slot_key[buf][lane] : 0u,  // 0: below every float's key
                                has ? slot_i[buf][lane] : INT_MAX, stop);
    centre = centre_at(base, far);
    if (tid == 0) o[it] = far;
  }
}

template <int P>
void launch_warp(const float* xyz, const uint8_t* mask, int* out, int b, int n, int npoint,
                 int clouds_per_block, cudaStream_t stream) {
  const int blocks = (b + clouds_per_block - 1) / clouds_per_block;
  const size_t smem = static_cast<size_t>(clouds_per_block) * 32 * P * sizeof(float4);
  fps_kernel_warp<P><<<blocks, 32 * clouds_per_block, smem, stream>>>(xyz, mask, out, b, n,
                                                                       npoint);
}

template <int P, bool kSharedXyz>
void launch_block(const float* xyz, const uint8_t* mask, int* out, int b, int n, int npoint,
                  int threads, cudaStream_t stream) {
  fps_kernel_block<P, kSharedXyz><<<b, threads, static_cast<size_t>(n) * sizeof(float4),
                                    stream>>>(xyz, mask, out, n, npoint);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int g_sms = 132;  // the current device's SMs, read at init

}  // namespace

extern "C" {

// Reads the device's SM count and lets the kernels take the shared memory of
// their largest clouds (above the 48 KB a launch may take without opting
// in), on the current device. Called once, at load; returns the cudaError_t.
int hotrack_fps_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  const int warp_bytes = kCloudsPerBlock * kWarpPoints * static_cast<int>(sizeof(float4));
  const int block_bytes = kMaxPoints * static_cast<int>(sizeof(float4));
  const cudaError_t each[] = {
      allow_shared(fps_kernel_warp<1>, warp_bytes), allow_shared(fps_kernel_warp<2>, warp_bytes),
      allow_shared(fps_kernel_warp<4>, warp_bytes), allow_shared(fps_kernel_warp<8>, warp_bytes),
      allow_shared(fps_kernel_warp<16>, warp_bytes),
      allow_shared(fps_kernel_warp<32>, warp_bytes),
      allow_shared(fps_kernel_block<4, false>, block_bytes),
      allow_shared(fps_kernel_block<8, false>, block_bytes),
      allow_shared(fps_kernel_block<16, false>, block_bytes),
      allow_shared(fps_kernel_block<32, true>, block_bytes)};
  for (const cudaError_t e : each) {
    if (err == cudaSuccess) err = e;
  }
  return static_cast<int>(err);
}

// Launches FPS on `stream`; returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for an empty problem or N above
// kMaxPoints). Does not synchronise. `mask` may be null (all valid). The
// layout: up to kWarpPoints points, one warp a cloud with the fewest
// power-of-two points a lane; above, one block a cloud with 4, 8 or 16
// points a thread in registers (the fewest that keep the block within
// kBlockThreads), or above kRegisterPoints 32 a thread with the coordinates
// in the shared copy. Point k of thread t is t + k * threads.
int hotrack_fps(const float* xyz, const uint8_t* mask, int* out, int b, int n, int npoint,
                void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kWarpPoints) {
    // enough clouds a block that the grid still covers the SMs, at most 4
    const int per_block = b <= g_sms ? 1 : min(kCloudsPerBlock, (b + g_sms - 1) / g_sms);
    if (n <= 32) launch_warp<1>(xyz, mask, out, b, n, npoint, per_block, st);
    else if (n <= 64) launch_warp<2>(xyz, mask, out, b, n, npoint, per_block, st);
    else if (n <= 128) launch_warp<4>(xyz, mask, out, b, n, npoint, per_block, st);
    else if (n <= 256) launch_warp<8>(xyz, mask, out, b, n, npoint, per_block, st);
    else if (n <= 512) launch_warp<16>(xyz, mask, out, b, n, npoint, per_block, st);
    else launch_warp<32>(xyz, mask, out, b, n, npoint, per_block, st);
  } else {
    // the threads of a block with p points each: whole warps that cover n
    const auto threads = [n](int p) { return 32 * ((n + 32 * p - 1) / (32 * p)); };
    if (threads(4) <= kBlockThreads) {
      launch_block<4, false>(xyz, mask, out, b, n, npoint, threads(4), st);
    } else if (threads(8) <= kBlockThreads) {
      launch_block<8, false>(xyz, mask, out, b, n, npoint, threads(8), st);
    } else if (n <= kRegisterPoints) {
      launch_block<16, false>(xyz, mask, out, b, n, npoint, threads(16), st);
    } else {
      launch_block<32, true>(xyz, mask, out, b, n, npoint, threads(32), st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
