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
// What bounds it: FPS is a chain of npoint dependent argmax steps over one
// cloud, so on this card it is bound by the latency of each step (a pass over
// the cloud in shared memory, then a block-wide reduction and a barrier), not
// by bytes: the cloud is read from device memory once. The design keeps the
// whole row (coordinates and running min-distance, 16 bytes a point) in
// shared memory, runs one thread block per batch row, and needs a single
// barrier per step: the per-warp winners go to a double-buffered slot in
// shared memory, and every warp reduces those slots itself, so the chosen
// index is known to all threads without a second barrier. Batch 1 runs on one
// SM; that is inherent to one cloud and left to later work.
//
// Rounding: the distance is ((dx*dx) + (dy*dy)) + (dz*dz) with explicit
// round-to-nearest intrinsics, so no FMA contraction changes it; the plain
// PyTorch version (ops/pointops.py:_farthest_point_sample_torch) and the JAX
// reference sum in the same order, and any rounding difference would change
// the sample set through the argmax chain.

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then lower index.
__device__ __forceinline__ void keep_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const uint8_t* __restrict__ mask,
                           int* __restrict__ out, int n, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sd = sz + n;
  __shared__ float red_v[2][kMaxWarps];
  __shared__ int red_i[2][kMaxWarps];

  const int row = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* m = mask == nullptr ? nullptr : mask + static_cast<size_t>(row) * n;
  int* o = out + static_cast<size_t>(row) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < n; i += blockDim.x) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    sd[i] = (m == nullptr || m[i] != 0) ? 1e10f : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int far = 0;
  for (int it = 1; it < npoint; ++it) {
    const float cx = sx[far];
    const float cy = sy[far];
    const float cz = sz[far];
    float best = -FLT_MAX;
    int best_i = INT_MAX;
    // each thread owns points tid, tid + blockDim, ... in increasing order,
    // so a strict '>' keeps the lowest index among its own ties
    for (int i = tid; i < n; i += blockDim.x) {
      const float dx = __fsub_rn(sx[i], cx);
      const float dy = __fsub_rn(sy[i], cy);
      const float dz = __fsub_rn(sz[i], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float cur = fminf(sd[i], d);  // invalid points stay at -1
      sd[i] = cur;
      if (cur > best) {
        best = cur;
        best_i = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, best, off);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
      keep_better(best, best_i, v2, i2);
    }
    const int buf = it & 1;
    if (lane == 0) {
      red_v[buf][warp] = best;
      red_i[buf][warp] = best_i;
    }
    __syncthreads();
    // Every warp reduces the per-warp winners itself. The slots alternate
    // between two buffers: a warp writes buffer `buf` again two steps later,
    // after the next barrier, which every warp passes only once it has read
    // this step's slots.
    float v = lane < nwarps ? red_v[buf][lane] : -FLT_MAX;
    int vi = lane < nwarps ? red_i[buf][lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, vi, off);
      keep_better(v, vi, v2, i2);
    }
    far = vi;
    if (tid == 0) o[it] = far;
  }
}

}  // namespace

extern "C" {

// Largest cloud one block holds: 16 bytes a point in dynamic shared memory,
// within the 227 KB a block may use, beside the static reduction slots.
constexpr int kMaxPoints = 14336;

// Lets fps_kernel take shared memory for kMaxPoints (above the 48 KB a launch
// may take without opting in) on the current device. Called once, at load;
// returns the cudaError_t.
int hotrack_fps_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxPoints * 4 * sizeof(float))));
}

// Launches FPS on `stream`; returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for an empty problem or N above kMaxPoints).
// Does not synchronise. `mask` may be null (all valid).
int hotrack_fps(const float* xyz, const uint8_t* mask, int* out, int b, int n,
                int npoint, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n <= 1024 ? 256 : 512;
  const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float);
  fps_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(xyz, mask, out, n,
                                                                      npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
