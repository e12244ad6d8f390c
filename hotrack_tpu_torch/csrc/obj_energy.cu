// Fused object-pose SDF energy for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/obj_energy.py:
// _obj_energy_kernel, reached through _obj_impl from fused_obj_sdf_energy,
// and its per-sequence form _obj_energy_kernel_b, reached through
// _obj_impl_batched when several sequences are tracked with a model each:
// for every (sequence and) candidate pose p
//   out[p] = sum over n of | SDF( R_p^T x_n - R_p^T t_p ) |
// with the distilled-SDF MLP of sdf_mlp_tc.cuh on the tensor cores. Inputs:
// the observed cloud channels-first (3, N), and per candidate rts (P, 12) =
// row-major R^T then R^T t (ops/obj_energy.py obj_rts). The transformed cloud
// (P, 3, N) and the (P, N) sdf never reach device memory. Not carried over
// from the TPU: N padded to 128 with a validity mask, P padded to the
// particle tile, the role-major rts slab and the tile knobs; any P and any N
// are taken as they are.
//
// Bound: operations. 2048 candidates x 1024 points x 71,168 operations =
// 149.2 GFLOP a launch, three tensor-core passes of it in 3xTF32 at 495
// TFLOP/s: 0.904 ms (2.228 ms in float32 FMA at 67 TFLOP/s), against 12 KB of
// cloud, 96 KB of poses and 8 KB out. Precision: 3xTF32 with float32
// accumulation for the hidden layers (sdf_mlp_tc.cuh); the transform is
// float32, ((-rt_c + r_c0 x) + r_c1 y) + r_c2 z with each product and sum
// rounded on its own, as the plain version computes it.
//
// Design: a persistent grid of one block (256 threads, 8 warps) an SM, each
// walking the (sequence, candidate) items b, b + grid, ... in ascending
// order, with the model's later layers resident in shared memory (197,632
// bytes for 21-128-128-128-1; copied again only when the walk enters another
// sequence). An item is its candidate's
// cloud in rounds of 128 points, 16 a warp: the transform in registers, the
// MLP (sdf_mlp_tc.cuh), |sdf| added to the lane's running sum (rows g, then
// g + 8, rounds ascending). At the end the lanes' sums are added by a fixed
// butterfly in the warp and the 8 warps' in ascending order. No atomics and
// nothing depends on the grid or on which block took the item, so two
// launches agree bitwise, and sequence s of a batched launch (its cloud,
// candidates, model and output s times their per-sequence strides further on;
// a stride of 0 shares an input) sums bitwise what an unbatched launch on s's
// inputs sums: that launch is the case of one sequence.
//
// bf16 (HOTRACK_SDF_BF16), entry hotrack_obj_energy_bf16: a job on the
// persistent bf16 wgmma walk of sdf_mlp_wgmma.cuh (wg::walk<true>, wgmma
// m64n128k16, PackedSDF.wg16: 18 tiles for 21-128-128-128-1, all pinned), the
// walk that #3 and #6 run. Rows: candidate p's cloud padded to whole rounds
// of 128 (R = ceil(N / 128) rounds a candidate; row p R 128 + i is point i of
// candidate p's cloud, i >= N computes and counts nothing), sequence-major, and
// a group is a candidate's R rounds, which one block walks in ascending order.
// `load` reads the cloud point a round ahead (all candidates share the
// cloud), `place` applies the candidate's 12 rts floats, loaded where the round
// starts, with the float32 expression above, so the object-frame points are
// bitwise the 3xTF32 kernel's. The sum: the same order as above (a lane's
// rows g, then g + 8, rounds ascending; a fixed butterfly in the warp; the 8
// consumer warps' in ascending order after a named barrier of the two
// consumer warpgroups, in a shared-memory pair of 8 floats taken in turns by
// group), no atomics. So two launches agree bitwise, and sequence s of a
// batched launch sums bitwise what an unbatched launch on s's inputs sums.
// Bound: one bf16 pass at 989 TFLOP/s, 0.151 ms at 2048 x 1024.

#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

__device__ __forceinline__ void transform(const float* __restrict__ pc, int n, int i,
                                          const float (&r)[12], float scale, float (&x)[3]) {
  x[0] = x[1] = x[2] = 0.0f;
  if (i >= n) return;
  const float px = __ldg(pc + i), py = __ldg(pc + n + i),
              pz = __ldg(pc + 2 * static_cast<long long>(n) + i);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = __fadd_rn(-r[9 + c], __fmul_rn(r[3 * c], px));
    v = __fadd_rn(v, __fmul_rn(r[3 * c + 1], py));
    v = __fadd_rn(v, __fmul_rn(r[3 * c + 2], pz));
    x[c] = __fmul_rn(v, scale);
  }
}

__global__ void __launch_bounds__(tc::kThreads, 1)
obj_energy_kernel(const float* __restrict__ pcld_cf, const float* __restrict__ rts,
                  const float* __restrict__ packed, float* __restrict__ out, int p, int n,
                  long long items, long long pcld_seq, long long packed_seq, tc::Shape shape,
                  int resident) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* red = wsm + tc::weight_smem_floats(shape, resident != 0);   // one float a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  long long loaded = -1;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long s = item / p;
    const tc::Net net = tc::net_of(packed + s * packed_seq, shape);
    if (resident && s != loaded) {
      tc::load_resident(wsm, net, shape);
      loaded = s;
    }
    const float* pc = pcld_cf + s * pcld_seq;
    float r[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) r[i] = __ldg(rts + item * 12 + i);
    float energy = 0.0f;
    for (int base = 0; base < n; base += tc::kRoundPoints) {
      const int i0 = base + warp * tc::kRows + g, i1 = i0 + 8;
      float xa[3], xb[3];
      transform(pc, n, i0, r, net.scale, xa);
      transform(pc, n, i1, r, net.scale, xb);
      const float2 sdf = tc::mlp_rows(xa, xb, net, shape, resident != 0, wsm);
      if (t == 0) {
        if (i0 < n) energy += fabsf(sdf.x);
        if (i1 < n) energy += fabsf(sdf.y);
      }
    }
    energy += __shfl_xor_sync(0xffffffffu, energy, 4);
    energy += __shfl_xor_sync(0xffffffffu, energy, 8);
    energy += __shfl_xor_sync(0xffffffffu, energy, 16);
    if (lane == 0) red[warp] = energy;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = red[0];
#pragma unroll
      for (int w = 1; w < tc::kWarps; ++w) sum += red[w];
      out[item] = sum;
    }
    __syncthreads();   // red is read before the next item writes it
  }
}

// The bf16 kernel's rows and sums on the walk (wg::Job): sequence s's cloud
// is pcld_seq floats further on, its candidates' rts and energies p x 12 and
// p floats.
struct Candidates : wg::Job {
  static constexpr bool kGroups = true;
  static constexpr bool kSums = true;
  const float* __restrict__ pcld_cf;   // (n_seq, 3, n)
  const float* __restrict__ rts;       // (n_seq, p, 12)
  float* __restrict__ out;             // (n_seq, p)
  long long pcld_seq;
  long long m;                         // rows a sequence: p R 128
  int p, n, rounds;                    // rounds: R, a candidate's

  __host__ __device__ long long span() const { return rounds; }
  __host__ long long scratch_bytes() const { return 2 * 4 * wg::kConsumerWarps; }

  // the row's point in its candidate's cloud (rows a sequence < 2^31)
  __device__ __forceinline__ int point(long long row) const {
    return static_cast<int>(static_cast<unsigned>(row) %
                            static_cast<unsigned>(rounds * wg::kRoundPoints));
  }
  __device__ __forceinline__ void load(long long s, long long row, float (&x)[3]) const {
    x[0] = x[1] = x[2] = 0.0f;
    const int i = point(row);
    if (i >= n) return;
    const float* pc = pcld_cf + s * pcld_seq;
    x[0] = __ldg(pc + i);
    x[1] = __ldg(pc + n + i);
    x[2] = __ldg(pc + 2 * static_cast<long long>(n) + i);
  }
  __device__ __forceinline__ void place(long long s, long long row, const float (&raw)[3],
                                        float scale, float (&x)[3]) const {
    const long long cand = s * p + static_cast<unsigned>(row) /
                                       static_cast<unsigned>(rounds * wg::kRoundPoints);
    float r[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) r[i] = wg::frame_at(rts + cand * 12 + i);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = __fadd_rn(-r[9 + c], __fmul_rn(r[3 * c], raw[0]));
      v = __fadd_rn(v, __fmul_rn(r[3 * c + 1], raw[1]));
      v = __fadd_rn(v, __fmul_rn(r[3 * c + 2], raw[2]));
      x[c] = __fmul_rn(v, scale);
    }
  }
  // lane t = 0 of rows g and g + 8 adds their |sdf| where they are points
  __device__ __forceinline__ void add(float& e, long long row, float2 sdf) const {
    const int i = point(row);
    if ((threadIdx.x & 3) == 0) {
      if (i < n) e += fabsf(sdf.x);
      if (i + 8 < n) e += fabsf(sdf.y);
    }
  }
  __device__ __forceinline__ void total(float& e, long long group, unsigned char* scratch,
                                        int parity) const {
    e += __shfl_xor_sync(0xffffffffu, e, 4);
    e += __shfl_xor_sync(0xffffffffu, e, 8);
    e += __shfl_xor_sync(0xffffffffu, e, 16);
    float* red = reinterpret_cast<float*>(scratch) + wg::kConsumerWarps * parity;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = e;
    wg::consumer_sync();   // a warp writes this half again two groups on, past the next barrier
    if (threadIdx.x == 0) {
      float sum = red[0];
#pragma unroll
      for (int w = 1; w < wg::kConsumerWarps; ++w) sum += red[w];
      out[group] = sum;
    }
    e = 0.0f;
  }
};

__global__ void __launch_bounds__(wg::kThreads, 1)
obj_energy_wg_kernel(const __grid_constant__ Candidates job, const float* __restrict__ packed,
                     long long packed_seq, long long rounds, long long items, wg::Shape shape,
                     int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<true>(job, smem, packed, packed_seq, rounds, items, shape, pinned, ring);
}

int g_smem_limit = 0;            // what a block of either kernel may opt into
long long g_grid_smem = -1;      // persistent_blocks' memo
int g_grid_blocks = 0;
wg::Grid g_grid_wg;

int launch(const void* pcld_cf, const void* rts, const void* packed, void* out, int p, int n,
           int n_seq, long long pcld_seq, long long packed_seq, int n_freqs, int n_hidden,
           const int* widths, void* stream) {
  const tc::Shape shape = tc::make_shape(n_freqs, n_hidden, widths);
  if (shape.k0 == 0 || p < 1 || n < 1 || n_seq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long red_bytes = 4LL * tc::kWarps;
  const int resident = tc::resident_mode(shape, red_bytes, g_smem_limit);
  if (resident < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = red_bytes + 4LL * tc::weight_smem_floats(shape, resident != 0);
  const long long items = static_cast<long long>(p) * n_seq;
  const int blocks = tc::persistent_blocks(obj_energy_kernel, smem, g_grid_smem, g_grid_blocks);
  if (blocks < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const unsigned grid = static_cast<unsigned>(items < blocks ? items : blocks);
  obj_energy_kernel<<<grid, tc::kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pcld_cf), static_cast<const float*>(rts),
      static_cast<const float*>(packed), static_cast<float*>(out), p, n, items, pcld_seq,
      packed_seq, shape, resident);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* pcld_cf, const void* rts, const void* packed, void* out, int p, int n,
                int n_seq, long long pcld_seq, long long packed_seq, int n_freqs, int n_hidden,
                const int* widths, void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, true);
  if (shape.tiles == 0 || p < 1 || n < 1 || n_seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rounds = (n + wg::kRoundPoints - 1) / wg::kRoundPoints;
  if (static_cast<long long>(p) * rounds * wg::kRoundPoints > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Candidates job{{}, static_cast<const float*>(pcld_cf), static_cast<const float*>(rts),
                       static_cast<float*>(out), pcld_seq,
                       static_cast<long long>(p) * rounds * wg::kRoundPoints, p, n, rounds};
  const long long seq_rounds = static_cast<long long>(p) * rounds;
  int pinned = 0, ring = 0;
  long long smem = 0;
  unsigned grid = 0;
  const cudaError_t err = wg::plan_launch(obj_energy_wg_kernel, shape, g_smem_limit,
                                          static_cast<long long>(p) * n_seq, g_grid_wg, pinned,
                                          ring, smem, grid, wg::job_bytes(job));
  if (err != cudaSuccess) return static_cast<int>(err);
  obj_energy_wg_kernel<<<grid, wg::kThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      job, static_cast<const float*>(packed), packed_seq, seq_rounds, seq_rounds * n_seq, shape,
      pinned, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts both instantiations into as much dynamic shared memory as a block may
// have on the current device, once per process.
int hotrack_obj_energy_init() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&g_smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(obj_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wg::opt_in(obj_energy_wg_kernel, g_smem_limit));
}

// pcld_cf (n_seq, 3, n), rts (n_seq, p, 12), packed (PackedSDF.tc), out
// (n_seq, p): device pointers; pcld_seq, packed_seq: floats from one
// sequence's cloud or model to the next (0: shared); widths: n_hidden + 1
// host ints.
int hotrack_obj_energy(const void* pcld_cf, const void* rts, const void* packed, void* out,
                       int p, int n, int n_seq, long long pcld_seq, long long packed_seq,
                       int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch(pcld_cf, rts, packed, out, p, n, n_seq, pcld_seq, packed_seq, n_freqs, n_hidden,
                widths, stream);
}

// The same in bf16 on the wgmma walk: packed is PackedSDF.wg16.
int hotrack_obj_energy_bf16(const void* pcld_cf, const void* rts, const void* packed, void* out,
                            int p, int n, int n_seq, long long pcld_seq, long long packed_seq,
                            int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch_bf16(pcld_cf, rts, packed, out, p, n, n_seq, pcld_seq, packed_seq, n_freqs,
                     n_hidden, widths, stream);
}

}  // extern "C"
