// Fused object-pose SDF energy for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/obj_energy.py:
// _obj_energy_kernel, reached through _obj_impl from fused_obj_sdf_energy,
// and its per-sequence form _obj_energy_kernel_b, reached through
// _obj_impl_batched when several sequences are tracked with a model each:
// for every (sequence and) candidate pose p
//   out[p] = sum over n of | SDF( R_p^T x_n - R_p^T t_p ) |
// with the distilled-SDF MLP of sdf_mlp_wgmma.cuh on the tensor cores. Inputs:
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
// cloud, 96 KB of poses and 8 KB out. Precision: the MLP of sdf_mlp.cu (#3),
// 3xTF32 on the tensor cores with the output layer and the clamp in float32;
// the transform is float32, ((-rt_c + r_c0 x) + r_c1 y) + r_c2 z with each
// product and sum rounded on its own, as the plain version computes it.
//
// Design: a job on the persistent wgmma walk of sdf_mlp_wgmma.cuh
// (wg::walk, wgmma m64n128k8 TF32 from PackedSDF.wg: 48 of the 70 tiles of
// 21-128-128-128-1 pinned and 22 streamed through the ring, as for #3; the
// job adds 64 bytes of shared memory), the walk that #3 and #6 run. Rows:
// candidate p's cloud padded to whole rounds of 128 (R = ceil(N / 128) rounds
// a candidate; row p R 128 + i is point i of candidate p's cloud, i >= N
// computes and counts nothing), sequence-major, and a group is a candidate's
// R rounds, which one block walks in ascending order. `load` reads the cloud
// point a round ahead (all candidates share the cloud), `place` applies the
// candidate's 12 rts floats, loaded where the round starts, with the float32
// expression above, then the scale, as #3's `place` scales its points. The
// sum: |sdf| added to the lane's running sum (a lane's rows g, then g + 8,
// rounds ascending); at the group's end the lanes' sums are added by a fixed
// butterfly in the warp and the 8 consumer warps' in ascending order, after a
// named barrier of the two consumer warpgroups, in a shared-memory pair of 8
// floats taken in turns by group. No atomics; a point's value depends on its
// raw values and its model only, so two launches agree bitwise, the per-point
// |sdf| is #3's on the same object-frame points, and sequence s of a batched
// launch (its cloud, candidates, model and output s times their per-sequence
// strides further on; a stride of 0 shares an input) sums bitwise what an
// unbatched launch on s's inputs sums: that launch is the case of one
// sequence.
//
// bf16 (HOTRACK_SDF_BF16), entry hotrack_obj_energy_bf16: the same job on the
// bf16 instantiation of the walk (wg::walk<true>, wgmma m64n128k16,
// PackedSDF.wg16: 18 tiles for 21-128-128-128-1, all pinned), with the same
// rows, transform and order of the sum. Bound: one bf16 pass at 989 TFLOP/s,
// 0.151 ms at 2048 x 1024.

#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

// The rows and sums on the walk (wg::Job), in either precision: sequence s's
// cloud is pcld_seq floats further on, its candidates' rts and energies p x 12
// and p floats.
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

template <bool kBf16>
__global__ void __launch_bounds__(wg::kThreads, 1)
obj_energy_wg_kernel(const __grid_constant__ Candidates job, const float* __restrict__ packed,
                     long long packed_seq, long long rounds, long long items, wg::Shape shape,
                     int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<kBf16>(job, smem, packed, packed_seq, rounds, items, shape, pinned, ring);
}

int g_smem_limit = 0;   // what a block of either instantiation may opt into
wg::Grid g_grid[2];     // by instantiation

template <bool kBf16>
int launch(const void* pcld_cf, const void* rts, const void* packed, void* out, int p, int n,
           int n_seq, long long pcld_seq, long long packed_seq, int n_freqs, int n_hidden,
           const int* widths, void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, kBf16);
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
  const cudaError_t err = wg::plan_launch(obj_energy_wg_kernel<kBf16>, shape, g_smem_limit,
                                          static_cast<long long>(p) * n_seq, g_grid[kBf16],
                                          pinned, ring, smem, grid, wg::job_bytes(job));
  if (err != cudaSuccess) return static_cast<int>(err);
  obj_energy_wg_kernel<kBf16><<<grid, wg::kThreads, static_cast<size_t>(smem),
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
  const cudaError_t err = wg::opt_in(obj_energy_wg_kernel<false>, g_smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wg::opt_in(obj_energy_wg_kernel<true>, g_smem_limit));
}

// pcld_cf (n_seq, 3, n), rts (n_seq, p, 12), packed (PackedSDF.wg), out
// (n_seq, p): device pointers; pcld_seq, packed_seq: floats from one
// sequence's cloud or model to the next (0: shared); widths: n_hidden + 1
// host ints.
int hotrack_obj_energy(const void* pcld_cf, const void* rts, const void* packed, void* out,
                       int p, int n, int n_seq, long long pcld_seq, long long packed_seq,
                       int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch<false>(pcld_cf, rts, packed, out, p, n, n_seq, pcld_seq, packed_seq, n_freqs,
                       n_hidden, widths, stream);
}

// The same in bf16: packed is PackedSDF.wg16.
int hotrack_obj_energy_bf16(const void* pcld_cf, const void* rts, const void* packed, void* out,
                            int p, int n, int n_seq, long long pcld_seq, long long packed_seq,
                            int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch<true>(pcld_cf, rts, packed, out, p, n, n_seq, pcld_seq, packed_seq, n_freqs,
                      n_hidden, widths, stream);
}

}  // extern "C"
