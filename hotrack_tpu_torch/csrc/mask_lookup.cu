// Background-mask lookup at integer pixels for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/mask_lookup.py:
// _lookup_kernel, reached through _lookup_impl from packed_mask_lookup, and
// its per-sequence form _lookup_kernel_b, reached through _lookup_impl_batched
// when several sequences are tracked with a mask each:
// out[i] = the mask's value at pixel (iy[i], ix[i]) as 0.0f or 1.0f, exact.
// The TPU kernel selects the row and the word by one-hot matrix products
// because a gather is slow there; here a lookup is a byte load and a shift,
// and the packed mask (38,400 bytes at 480 x 640) stays in L1/L2.
//
// Bound: bytes. Two int32 in and one float32 out a query, 12 bytes; the mask
// itself is read once. No arithmetic to speak of.
//
// Design: a thread takes four consecutive queries where the three arrays are
// 16-byte aligned (two 16-byte loads, four byte loads, one 16-byte store),
// and one query at a time otherwise and for the last n % 4. Indices outside
// the image are clipped, so nothing outside the mask is read. Sequences: the
// queries are n_seq blocks of n, one a sequence, and query i reads the mask
// of sequence i / n, mask_seq bytes on from the last (0: one mask for all).
// A group of four never straddles two sequences (it is taken only where n is
// a multiple of 4 or there is one sequence), so an unbatched launch is the
// case of one sequence and a batched one reads bitwise what it reads.

#include <cstdint>

#include "hand_energy_core.cuh"

namespace {

using namespace hotrack;

// The mask of query i (no division where every sequence shares one mask).
__device__ __forceinline__ const unsigned char* query_mask(const unsigned char* mask,
                                                           long long i, long long n,
                                                           long long mask_seq) {
  return mask_seq == 0 ? mask : mask + (i / n) * mask_seq;
}

__global__ void __launch_bounds__(256)
mask_lookup_kernel(const unsigned char* __restrict__ mask, const int* __restrict__ iy,
                   const int* __restrict__ ix, float* __restrict__ out, long long total,
                   long long n, long long mask_seq, int h, int w, int vectorised) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorised) {
    const long long groups = total >> 2;
    const int4* iy4 = reinterpret_cast<const int4*>(iy);
    const int4* ix4 = reinterpret_cast<const int4*>(ix);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long g = first; g < groups; g += stride) {
      const unsigned char* m = query_mask(mask, g << 2, n, mask_seq);
      const int4 y = __ldg(iy4 + g), x = __ldg(ix4 + g);
      out4[g] = make_float4(mask_bit(m, h, w, y.x, x.x), mask_bit(m, h, w, y.y, x.y),
                            mask_bit(m, h, w, y.z, x.z), mask_bit(m, h, w, y.w, x.w));
    }
    done = groups << 2;
  }
  for (long long i = done + first; i < total; i += stride)
    out[i] = mask_bit(query_mask(mask, i, n, mask_seq), h, w, __ldg(iy + i), __ldg(ix + i));
}

}  // namespace

extern "C" {

// mask (n_seq, h, ceil(w / 8)) uint8 (mask_seq bytes apart, 0: shared), iy, ix
// (n_seq, n) int32, out (n_seq, n) float32: device pointers.
int hotrack_mask_lookup(const void* mask, const void* iy, const void* ix, void* out,
                        long long n, int n_seq, long long mask_seq, int h, int w,
                        void* stream) {
  if (n < 1 || n_seq < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n * n_seq;
  const std::uintptr_t bits = reinterpret_cast<std::uintptr_t>(iy) |
                              reinterpret_cast<std::uintptr_t>(ix) |
                              reinterpret_cast<std::uintptr_t>(out);
  const int vectorised = (bits & 15u) == 0 && (n_seq == 1 || n % 4 == 0);
  const long long work = vectorised ? (total + 3) / 4 : total;
  long long blocks = (work + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond that
  mask_lookup_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const int*>(iy),
      static_cast<const int*>(ix), static_cast<float*>(out), total, n, mask_seq, h, w,
      vectorised);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
