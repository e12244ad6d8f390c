// Batched row gather and its deterministic scatter-add adjoint for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/gather_mm.py
// (_gather_kernel and its backward _scatter_kernel) and computes what they
// compute, not how: the TPU kernels turn the gather into one-hot matrix
// products to reach the MXU; a GPU copies rows directly.
//
//   gather_rows:       out[b, s, :]  = src[b, idx[b, s], :]          (bitwise)
//   scatter_rows_add:  dsrc[b, n, :] = sum over {s : idx[b, s] == n} of
//                      dout[b, s, :], accumulated in f32 in ascending s
//
// An index outside [0, N) never touches memory outside the tensors: the
// gather writes a zero row for it (as the TPU kernel does for its -1
// padding) and the scatter-add skips it.
//
// What bounds them: both are pure data movement, bound by bytes. The gather
// reads S rows and writes S rows per batch element; a group of 2..32 lanes
// copies one row, in 16-byte units when the row size and the pointers allow
// it, so neighbouring lanes touch neighbouring addresses. The scatter-add
// must be the same on every run, so it uses no floating-point atomics: one
// warp owns one source row (b, n) and up to 128 of its channels as f32
// accumulators in registers; the block streams idx[b, :] through shared
// memory in chunks, each warp ballots the positions that select its row and
// adds those dout rows in ascending s. That reads every matching dout row
// once (coalesced) and writes every dsrc element once (zeros for rows that
// no index selects); the price is B*N*S integer compares, which is small
// beside the bytes at the shapes of PointNet++ grouping (N <= 512).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;         // indices staged in shared memory at a time
constexpr int kChannelsPerWarp = 128;  // 4 f32 accumulators a lane

template <typename IdxT>
__device__ __forceinline__ int checked_index(const IdxT* idx, long long at, int n) {
  const IdxT v = idx[at];
  return (v < 0 || v >= static_cast<IdxT>(n)) ? -1 : static_cast<int>(v);
}

// One group of 2^lanes_log2 lanes copies one row of `units` elements of T.
template <typename T, typename IdxT>
__global__ void gather_rows_kernel(const T* __restrict__ src, const IdxT* __restrict__ idx,
                                   T* __restrict__ out, long long rows, int s, int n,
                                   int units, int lanes_log2) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t >> lanes_log2;
  if (row >= rows) return;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t) & (lanes - 1);
  const int i = checked_index(idx, row, n);
  T* o = out + row * units;
  if (i < 0) {
    for (int u = lane; u < units; u += lanes) o[u] = T{};
    return;
  }
  const long long b = row / s;
  const T* p = src + (b * n + i) * units;
  for (int u = lane; u < units; u += lanes) o[u] = p[u];
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// Block (bx, by): batch element b = bx / nblocks, source rows
// (bx % nblocks) * kWarps + warp, channels [by * 128, by * 128 + 128).
template <typename T, typename IdxT>
__global__ void scatter_rows_add_kernel(const T* __restrict__ dout,
                                        const IdxT* __restrict__ idx, T* __restrict__ dsrc,
                                        int s, int n, int c, int nblocks) {
  __shared__ int sidx[kChunk];
  const int b = blockIdx.x / nblocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = (blockIdx.x % nblocks) * kWarps + warp;
  const int c0 = blockIdx.y * kChannelsPerWarp + lane;
  const T* g = dout + static_cast<long long>(b) * s * c;
  const IdxT* ib = idx + static_cast<long long>(b) * s;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int chunk0 = 0; chunk0 < s; chunk0 += kChunk) {
    const int len = min(kChunk, s - chunk0);
    __syncthreads();  // the previous chunk has been read by every warp
    for (int j = threadIdx.x; j < len; j += kThreads) {
      sidx[j] = checked_index(ib, chunk0 + j, n);
    }
    __syncthreads();
    if (row >= n) continue;  // no early return: the barriers need every warp
    for (int base = 0; base < len; base += 32) {
      const int j = base + lane;
      unsigned hits = __ballot_sync(0xffffffffu, j < len && sidx[j] == row);
      while (hits != 0) {  // ascending s: lowest set bit first
        const int at = chunk0 + base + __ffs(hits) - 1;
        hits &= hits - 1;
        const T* grow = g + static_cast<long long>(at) * c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = c0 + 32 * k;
          if (ch < c) acc[k] += to_float(grow[ch]);
        }
      }
    }
  }
  if (row >= n) return;
  T* o = dsrc + (static_cast<long long>(b) * n + row) * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ch = c0 + 32 * k;
    if (ch < c) from_float(acc[k], o + ch);
  }
}

template <typename T, typename IdxT>
void launch_gather(const void* src, const void* idx, void* out, long long rows, int s,
                   int n, int units, cudaStream_t stream) {
  int lanes_log2 = 1;
  while (lanes_log2 < 5 && (1 << lanes_log2) < units) ++lanes_log2;
  const long long threads = rows << lanes_log2;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  gather_rows_kernel<T, IdxT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const IdxT*>(idx), static_cast<T*>(out), rows,
      s, n, units, lanes_log2);
}

template <typename IdxT>
void launch_gather_units(const void* src, const void* idx, void* out, long long rows, int s,
                         int n, int row_bytes, cudaStream_t stream) {
  // the widest unit that divides the row and both base pointers (a bf16 view
  // may start at an odd element of its storage, 2 bytes off a 4-byte boundary)
  const uintptr_t both = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && both % 16 == 0) {
    launch_gather<uint4, IdxT>(src, idx, out, rows, s, n, row_bytes / 16, stream);
  } else if (row_bytes % 4 == 0 && both % 4 == 0) {
    launch_gather<uint32_t, IdxT>(src, idx, out, rows, s, n, row_bytes / 4, stream);
  } else {
    launch_gather<uint16_t, IdxT>(src, idx, out, rows, s, n, row_bytes / 2, stream);
  }
}

template <typename T, typename IdxT>
void launch_scatter(const void* dout, const void* idx, void* dsrc, int b, int s, int n,
                    int c, cudaStream_t stream) {
  const int nblocks = (n + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(b) * nblocks,
                  (c + kChannelsPerWarp - 1) / kChannelsPerWarp);
  scatter_rows_add_kernel<T, IdxT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const IdxT*>(idx), static_cast<T*>(dsrc), s, n,
      c, nblocks);
}

}  // namespace

extern "C" {

// out (B*S rows of row_bytes) <- rows of src (B, N, row_bytes) picked by idx
// (B*S, int32, or int64 when idx64 != 0). row_bytes is even (f32 or bf16
// elements). Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an empty or oversized
// problem).
int hotrack_gather_rows(const void* src, const void* idx, void* out, long long rows, int s,
                        int n, int row_bytes, int idx64, void* stream) {
  if (rows <= 0 || s <= 0 || n <= 0 || row_bytes <= 0 || row_bytes % 2 != 0 ||
      rows > (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64) {
    launch_gather_units<int64_t>(src, idx, out, rows, s, n, row_bytes, st);
  } else {
    launch_gather_units<int32_t>(src, idx, out, rows, s, n, row_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// dsrc (B, N, C) <- scatter-add of dout (B, S, C) by idx (B, S); both tensors
// f32, or both bf16 when bf16 != 0 (the sum is f32 either way and rounded
// once at the end). Same launch conventions as above.
int hotrack_scatter_rows_add(const void* dout, const void* idx, void* dsrc, int b, int s,
                             int n, int c, int bf16, int idx64, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || c <= 0 ||
      static_cast<long long>(b) * ((n + kWarps - 1) / kWarps) > 2147483647LL ||
      (c + kChannelsPerWarp - 1) / kChannelsPerWarp > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (idx64) launch_scatter<__nv_bfloat16, int64_t>(dout, idx, dsrc, b, s, n, c, st);
    else launch_scatter<__nv_bfloat16, int32_t>(dout, idx, dsrc, b, s, n, c, st);
  } else {
    if (idx64) launch_scatter<float, int64_t>(dout, idx, dsrc, b, s, n, c, st);
    else launch_scatter<float, int32_t>(dout, idx, dsrc, b, s, n, c, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
