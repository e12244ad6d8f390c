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
// must be the same on every run, so it uses no floating-point atomics and
// adds each output element's terms in ascending s, one after another: its
// output is bitwise the plain version's on the CPU (index_add_ in float32).
// A block owns 32 source rows of one batch element. It buckets that batch
// row's indices by source row once, in shared memory (integer counts, a scan,
// and a stable placement ranked within each warp by __match_any_sync), so a
// row's hits lie in ascending s; then a warp sums one row at a time over all
// its channels with 16-byte loads, keeping four hits' loads in flight before
// their adds, and writes each output element once with 16-byte stores (zeros
// for rows that no index selects). The indices are read once a block (int64
// from the ball query: 10.75 KB a batch row at S = 1344), not once a warp and
// a channel slice, so the bytes are dout's, dsrc's and little else. Above
// kScatterChunk positions the sum so far waits between chunks in float32:
// in dsrc itself for float32, in a float32 scratch of dsrc's shape for bf16
// and fp16, so a 2-byte output is still rounded once, at the last chunk.
//
// Element types: float32, bf16 and fp16 (HandTrackNet's compute dtypes).
// The gather copies bytes and does not look at the type; the scatter-add is
// one template over the type, the sum float32 for each.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // the gather's block
constexpr int kScatterRows = 32;     // source rows a scatter block owns: a lane each in the scan
constexpr int kScatterWarps = 4;
constexpr int kScatterThreads = 32 * kScatterWarps;
constexpr int kScatterChunk = 2048;  // positions bucketed in shared memory at a time
constexpr int kAccFloats = 16;       // float32 accumulators a lane
constexpr int kInFlight = 4;         // hits whose loads are issued before their adds

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
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_float(float v, __half* o) { *o = __float2half_rn(v); }

// the 16 bits of a 2-byte element (bf16 or fp16) as float32, and back,
// rounded to nearest even
template <typename T>
__device__ __forceinline__ float bits_to_float(unsigned bits) {
  const unsigned short b = static_cast<unsigned short>(bits);
  if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__ushort_as_half(b));
  } else {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
}
template <typename T>
__device__ __forceinline__ unsigned float_to_bits(float v) {
  if constexpr (std::is_same_v<T, __half>) {
    return __half_as_ushort(__float2half_rn(v));
  } else {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// W consecutive elements of T (dout, which the kernel never writes) as
// float32, through the read-only path: one 16-byte load when W > 1 (W = 4
// for f32, 8 for bf16 and fp16), else one element.
template <typename T, int W>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = to_float(__ldg(p));
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (W == 4) {
      f[0] = __uint_as_float(v.x);
      f[1] = __uint_as_float(v.y);
      f[2] = __uint_as_float(v.z);
      f[3] = __uint_as_float(v.w);
    } else {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[2 * k] = bits_to_float<T>(w[k] & 0xffffu);  // the lower address
        f[2 * k + 1] = bits_to_float<T>(w[k] >> 16);
      }
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_unit(T* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    from_float(f[0], p);
  } else {
    uint4 v;
    if constexpr (W == 4) {
      v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                     __float_as_uint(f[3]));
    } else {
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = float_to_bits<T>(f[2 * k]) | (float_to_bits<T>(f[2 * k + 1]) << 16);
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
}

// W float32 partial sums that this thread wrote in an earlier chunk, in
// 16-byte units when W > 1 (W is a multiple of 4 then), and their store.
template <int W>
__device__ __forceinline__ void load_partial(const float* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      f[4 * k] = v.x;
      f[4 * k + 1] = v.y;
      f[4 * k + 2] = v.z;
      f[4 * k + 3] = v.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_partial(float* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      reinterpret_cast<float4*>(p)[k] =
          make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
    }
  }
}

// The scatter-add. Block x owns batch element b = x / blocks_per_row and
// the kScatterRows source rows from r0 = (x % blocks_per_row) * kScatterRows.
// For each chunk of up to kScatterChunk positions s (ascending):
//   1. every position's row in the block's range (or -1: another block's,
//      or an index outside [0, n)) goes to shared memory, read coalesced;
//   2. warp w counts the rows of its contiguous segment of the chunk
//      (integer shared atomics: a count does not depend on their order);
//   3. warp 0 scans the counts (lane r owns row r), giving each row its
//      start in `hits` and each warp its first slot within that row;
//   4. warp w walks its segment again in ascending s and places each
//      position at its warp's slot plus its rank among the lanes of the same
//      row (__match_any_sync), so every row's hits lie in ascending s;
//   5. warp w sums rows w, w + kScatterWarps, ...: its lanes hold the row's
//      channels as float32 accumulators (16-byte loads), issue the loads of
//      kInFlight hits, then add them in ascending s, and write each output
//      element once with 16-byte stores (the first chunk starts from 0, a
//      later one from the float32 sum so far, so the order is one sequential
//      sum; only the last chunk writes dsrc's type, and for bf16 and fp16
//      the chunks before it write the sum to `partial`, float32 of dsrc's
//      shape).
template <typename T, typename IdxT, int W>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_rows_add_kernel(const T* __restrict__ dout, const IdxT* __restrict__ idx,
                            T* __restrict__ dsrc, float* __restrict__ partial, int s, int n,
                            int c, int blocks_per_row) {
  constexpr int kUnitsPerLane = kAccFloats / W;
  __shared__ int row_of[kScatterChunk];
  __shared__ int hits[kScatterChunk];
  __shared__ int slot[kScatterWarps][kScatterRows];  // counts, then each warp's next slot
  __shared__ int row_start[kScatterRows], row_count[kScatterRows];

  const int b = blockIdx.x / blocks_per_row;
  const int r0 = (blockIdx.x % blocks_per_row) * kScatterRows;
  const int rows = min(kScatterRows, n - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const IdxT* ib = idx + static_cast<long long>(b) * s;
  const T* g = dout + static_cast<long long>(b) * s * c;
  const long long row0 = (static_cast<long long>(b) * n + r0) * c;
  T* ob = dsrc + row0;
  // where the sum waits between chunks: dsrc itself when it is float32
  float* pb = std::is_same_v<T, float> ? reinterpret_cast<float*>(ob) : partial + row0;
  const int units = c / W;

  for (int chunk0 = 0; chunk0 < s; chunk0 += kScatterChunk) {
    // (the shared arrays that step 5 reads are written again only after the
    // barrier below, which every warp reaches once it has summed its rows)
    const int len = min(kScatterChunk, s - chunk0);
    const bool last = chunk0 + len == s;
#pragma unroll 4
    for (int j = threadIdx.x; j < len; j += kScatterThreads) {
      const IdxT v = ib[chunk0 + j];
      row_of[j] = (v >= static_cast<IdxT>(r0) && v < static_cast<IdxT>(r0 + rows))
                      ? static_cast<int>(v - static_cast<IdxT>(r0))
                      : -1;
    }
    for (int j = threadIdx.x; j < kScatterWarps * kScatterRows; j += kScatterThreads) {
      slot[j / kScatterRows][j % kScatterRows] = 0;
    }
    __syncthreads();
    const int seg = ((len + kScatterWarps - 1) / kScatterWarps + 31) & ~31;
    const int lo = min(len, warp * seg), hi = min(len, lo + seg);
    for (int j = lo + lane; j < hi; j += 32) {
      const int r = row_of[j];
      if (r >= 0) atomicAdd(&slot[warp][r], 1);
    }
    __syncthreads();
    if (warp == 0) {
      int count[kScatterWarps], total = 0;
#pragma unroll
      for (int w = 0; w < kScatterWarps; ++w) {
        count[w] = slot[w][lane];
        total += count[w];
      }
      int incl = total;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      int start = incl - total;
      row_start[lane] = start;
      row_count[lane] = total;
#pragma unroll
      for (int w = 0; w < kScatterWarps; ++w) {
        slot[w][lane] = start;
        start += count[w];
      }
    }
    __syncthreads();
    for (int base = lo; base < hi; base += 32) {
      const int j = base + lane;
      const int r = j < hi ? row_of[j] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, r);
      const unsigned below = peers & ((1u << lane) - 1u);
      const int at = r >= 0 ? slot[warp][r] + __popc(below) : 0;
      __syncwarp();
      if (r >= 0) {
        hits[at] = chunk0 + j;
        if (below == 0) slot[warp][r] += __popc(peers);  // the group's lowest lane
      }
      __syncwarp();
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kScatterWarps) {
      const int* h = hits + row_start[r];
      const int count = row_count[r];
      T* orow = ob + static_cast<long long>(r) * c;
      float* prow = pb + static_cast<long long>(r) * c;
      for (int u0 = lane; u0 < units; u0 += 32 * kUnitsPerLane) {
        float acc[kUnitsPerLane][W];
#pragma unroll
        for (int v = 0; v < kUnitsPerLane; ++v) {
          const int u = u0 + 32 * v;
#pragma unroll
          for (int e = 0; e < W; ++e) acc[v][e] = 0.0f;
          if (chunk0 > 0 && u < units) load_partial<W>(prow + u * W, acc[v]);
        }
        for (int k0 = 0; k0 < count; k0 += kInFlight) {
          float in[kInFlight][kUnitsPerLane][W];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            if (k0 + q < count) {
              const T* grow = g + static_cast<long long>(h[k0 + q]) * c;
#pragma unroll
              for (int v = 0; v < kUnitsPerLane; ++v) {
                const int u = u0 + 32 * v;
                if (u < units) load_unit<T, W>(grow + u * W, in[q][v]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {  // ascending s
            if (k0 + q < count) {
#pragma unroll
              for (int v = 0; v < kUnitsPerLane; ++v) {
#pragma unroll
                for (int e = 0; e < W; ++e) acc[v][e] += in[q][v][e];
              }
            }
          }
        }
#pragma unroll
        for (int v = 0; v < kUnitsPerLane; ++v) {
          const int u = u0 + 32 * v;
          if (u >= units) continue;
          if (last) {
            store_unit<T, W>(orow + u * W, acc[v]);
          } else {
            store_partial<W>(prow + u * W, acc[v]);
          }
        }
      }
    }
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
void launch_scatter(const void* dout, const void* idx, void* dsrc, float* partial, int b, int s,
                    int n, int c, cudaStream_t stream) {
  const int blocks_per_row = (n + kScatterRows - 1) / kScatterRows;
  const unsigned grid = static_cast<unsigned>(b) * blocks_per_row;
  // 16-byte units where the row size and both base pointers allow them
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const uintptr_t both = reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dsrc);
  if (c % kVec == 0 && both % 16 == 0) {
    scatter_rows_add_kernel<T, IdxT, kVec><<<grid, kScatterThreads, 0, stream>>>(
        static_cast<const T*>(dout), static_cast<const IdxT*>(idx), static_cast<T*>(dsrc),
        partial, s, n, c, blocks_per_row);
  } else {
    scatter_rows_add_kernel<T, IdxT, 1><<<grid, kScatterThreads, 0, stream>>>(
        static_cast<const T*>(dout), static_cast<const IdxT*>(idx), static_cast<T*>(dsrc),
        partial, s, n, c, blocks_per_row);
  }
}

}  // namespace

extern "C" {

// out (B*S rows of row_bytes) <- rows of src (B, N, row_bytes) picked by idx
// (B*S, int32, or int64 when idx64 != 0). row_bytes is even (f32, bf16 or
// fp16 elements). Launches on `stream`, does not synchronise; returns the
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

// The element types of hotrack_scatter_rows_add's `dtype`.
enum { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// The float32 elements of the scratch that hotrack_scatter_rows_add needs
// for these sizes: B * N * C for a 2-byte type above kScatterChunk
// positions (the sum so far, between chunks), else 0.
long long hotrack_scatter_rows_add_scratch(int b, int s, int n, int c, int dtype) {
  return dtype != kFloat32 && s > kScatterChunk ? static_cast<long long>(b) * n * c : 0;
}

// dsrc (B, N, C) <- scatter-add of dout (B, S, C) by idx (B, S); both tensors
// of `dtype` (kFloat32, kBFloat16, kFloat16; the sum is f32 for each and
// rounded once at the end). `partial` is the float32 scratch of
// hotrack_scatter_rows_add_scratch's size (null when that is 0), 16-byte
// aligned. Same launch conventions as above.
int hotrack_scatter_rows_add(const void* dout, const void* idx, void* dsrc, void* partial,
                             int b, int s, int n, int c, int dtype, int idx64, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || c <= 0 || dtype < kFloat32 || dtype > kFloat16 ||
      static_cast<long long>(b) * ((n + kScatterRows - 1) / kScatterRows) > 2147483647LL ||
      (partial == nullptr && hotrack_scatter_rows_add_scratch(b, s, n, c, dtype) > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == kBFloat16) {
    if (idx64) launch_scatter<__nv_bfloat16, int64_t>(dout, idx, dsrc, p, b, s, n, c, st);
    else launch_scatter<__nv_bfloat16, int32_t>(dout, idx, dsrc, p, b, s, n, c, st);
  } else if (dtype == kFloat16) {
    if (idx64) launch_scatter<__half, int64_t>(dout, idx, dsrc, p, b, s, n, c, st);
    else launch_scatter<__half, int32_t>(dout, idx, dsrc, p, b, s, n, c, st);
  } else {
    if (idx64) launch_scatter<float, int64_t>(dout, idx, dsrc, p, b, s, n, c, st);
    else launch_scatter<float, int32_t>(dout, idx, dsrc, p, b, s, n, c, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
