// Fused object-pose SDF energy for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/obj_energy.py:
// _obj_energy_kernel, reached through _obj_impl from fused_obj_sdf_energy,
// and its per-sequence form _obj_energy_kernel_b, reached through
// _obj_impl_batched when several sequences are tracked with a model each:
// for every (sequence and) candidate pose p
//   out[p] = sum over n of | SDF( R_p^T x_n - R_p^T t_p ) |
// with the distilled-SDF MLP of sdf_mlp_core.cuh. Inputs: the observed cloud
// channels-first (3, N), and per candidate rts (P, 12) = row-major R^T then
// R^T t (ops/obj_energy.py obj_rts). The transformed cloud (P, 3, N) and the
// (P, N) sdf never reach device memory. Not carried over from the TPU: N
// padded to 128 with a validity mask, P padded to the particle tile, the
// role-major rts slab and the tile knobs; any P and any N are taken as they
// are.
//
// Bound: operations. 2048 candidates x 1024 points x 71,168 float32
// operations = 149.2 GFLOP a launch against 12 KB of cloud, 96 KB of poses
// and 8 KB out. Precision: float32 FMA with float32 accumulation, no tensor
// cores; the transform is computed as ((-rt_c + r_c0 x) + r_c1 y) + r_c2 z
// with each product and sum rounded on its own, as the plain version does.
//
// Design: one block of 256 threads per candidate. It walks the cloud in tiles
// of 128 points: transform in registers, features into shared memory, the MLP
// on the tile, |sdf| added to the point slot's running sum (tiles in ascending
// order). At the end the 128 slot sums are added by a fixed tree in shared
// memory. No atomics and no dependence on the grid, so two launches agree
// bitwise. Sequences: the grid is (P, S), blockIdx.y the sequence s; its
// cloud, its candidates, its packed model and its output lie s times their
// per-sequence strides further on (0 shares an input). An unbatched launch is
// the case of one sequence: sequence s of a batched launch sums bitwise what
// an unbatched launch on s's inputs sums.

#include "sdf_mlp_core.cuh"

namespace {

using namespace hotrack;

__global__ void __launch_bounds__(kMlpThreads, 2)
obj_energy_kernel(const float* __restrict__ pcld_cf, const float* __restrict__ rts,
                  const float* __restrict__ packed, float* __restrict__ out, int n,
                  long long pcld_seq, long long packed_seq, MlpShape shape) {
  extern __shared__ float4 smem4[];
  const long long cand = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  pcld_cf += blockIdx.y * pcld_seq;
  packed += blockIdx.y * packed_seq;
  float* act = reinterpret_cast<float*>(smem4);
  float* red = act + kActFloats;
  const float scale = __ldg(packed), clamp = __ldg(packed + 1);
  const float* freqs = packed + 4;
  const float* layers = freqs + round_up4(shape.n_freqs);

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rts + cand * 12 + i);

  const int slot = threadIdx.x & (kTilePoints - 1);
  float energy = 0.0f;
  for (int base = 0; base < n; base += kTilePoints) {
    const int i = base + slot;
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (i < n) {
      const float px = __ldg(pcld_cf + i), py = __ldg(pcld_cf + n + i),
                  pz = __ldg(pcld_cf + 2 * static_cast<long long>(n) + i);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = __fadd_rn(-r[9 + c], __fmul_rn(r[3 * c], px));
        v = __fadd_rn(v, __fmul_rn(r[3 * c + 1], py));
        v = __fadd_rn(v, __fmul_rn(r[3 * c + 2], pz));
        x[c] = __fmul_rn(v, scale);
      }
    }
    build_features(act, freqs, shape.n_freqs, x[0], x[1], x[2]);
    __syncthreads();
    const float s = mlp_tile(act, red, layers, shape, clamp);
    if (threadIdx.x < kTilePoints && i < n) energy += fabsf(s);
  }
  // a thread below 128 read only its own column of red in mlp_tile
  if (threadIdx.x < kTilePoints) red[threadIdx.x] = energy;
  __syncthreads();
  for (int s = kTilePoints / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[cand] = red[0];
}

}  // namespace

extern "C" {

int hotrack_obj_energy_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      obj_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlpSmemBytes));
}

// pcld_cf (n_seq, 3, n), rts (n_seq, p, 12), packed, out (n_seq, p): device
// pointers; pcld_seq, packed_seq: floats from one sequence's cloud or model to
// the next (0: shared); widths: n_hidden + 1 host ints.
int hotrack_obj_energy(const void* pcld_cf, const void* rts, const void* packed, void* out,
                       int p, int n, int n_seq, long long pcld_seq, long long packed_seq,
                       int n_freqs, int n_hidden, const int* widths, void* stream) {
  const MlpShape shape = make_mlp_shape(n_freqs, n_hidden, widths);
  if (mlp_shape_error(shape) || p < 1 || n < 1 || n_seq < 1 || n_seq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(p), static_cast<unsigned>(n_seq));
  obj_energy_kernel<<<grid, kMlpThreads, kMlpSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pcld_cf), static_cast<const float*>(rts),
      static_cast<const float*>(packed), static_cast<float*>(out), n, pcld_seq, packed_seq,
      shape);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
