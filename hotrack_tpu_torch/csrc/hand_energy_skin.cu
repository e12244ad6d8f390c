// MANO skinning fused with the per-vertex hand energy for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/hand_energy_skin.py:
// _skin_energy_kernel, reached through _skin_impl from
// fused_hand_energy_skin, and its per-sequence form _skin_energy_kernel_b,
// reached through _skin_impl_batched when several sequences are tracked, each
// with its shape, object pose, mask and model: per candidate p and vertex v
//   vp_c  = v_shaped[c][v] + sum_k posedirs[c][k][v] * pose_map[p][k]
//   s_r   = sum_j rt[p][r][j] * weights[j][v]        r = 0..11: R (9) then t (3)
//   x_c   = ((s_3c vp_0 + s_3c+1 vp_1 + s_3c+2 vp_2) + s_9+c) + offset[p][c]
//   sdf, hit = the per-vertex energy of hand_energy.cu at x
// which is the linear blend skinning of mano_forward followed by
// fused_hand_energy, with the vertices never written to device memory.
// Inputs: per candidate pose_map (P, K), rt (P, 12, 16) (rt_flat of
// mano/layer.py mano_skin_inputs), offset (P, 3); per call, vertex-minor,
// posedirs (3, K, N), v_shaped (3, N), weights (16, N). Not carried over from
// the TPU: vertices padded to a lane multiple, the particle tile with its
// role-major slab and sub-tiles, P padded by repeating particle 0.
//
// Bound: operations. A vertex costs the MLP's 71,168 float32 operations plus
// 2 (3 K + 12 * 16) + 18 = 1,212 of skinning at K = 135; the inputs are
// 1.35 KB a candidate and 1.3 MB a call, the outputs 8 bytes a vertex.
// Precision: float32 FMA, float32 accumulation, sums in ascending k and j
// from 0; the transform and projection as in hand_energy_core.cuh.
//
// Design: one block of 256 threads per pair of candidates. Phase 1 builds
// the pair's vertices into shared memory (2 x 3 x N floats): a thread takes a
// vertex and computes it for both candidates, so a value of posedirs or
// weights is loaded once (through L1/L2, neighbouring threads on neighbouring
// addresses) and used twice, and the block's two halves take alternate tiles
// of 128 vertices. Phase 2 walks the pair's 2 N vertices as one flat list in
// tiles of 128, so only the list's last tile is ragged (13 tiles for 2 x 778
// vertices, where a tile per candidate and 128 vertices would need 14):
// features, MLP and pixel lookup per tile as in hand_energy.cu. With an odd
// P the last block has one candidate. No atomics; nothing depends on the
// grid, so two launches agree bitwise. Sequences: the grid is (pairs, S),
// blockIdx.y the sequence s. The per-candidate inputs and the outputs are
// (S, P, ...); each per-call input (posedirs, v_shaped, weights, frame, mask,
// packed model) lies s times its own stride further on, and a stride of 0
// shares it between the sequences (posedirs and weights always are). An
// unbatched launch is the case of one sequence: sequence s of a batched launch
// computes bitwise what an unbatched launch on s's inputs computes.

#include "hand_energy_core.cuh"
#include "sdf_mlp_core.cuh"

namespace {

using namespace hotrack;

constexpr int kPair = 2;       // candidates a block
constexpr int kJoints = 16;
constexpr int kRoles = 12;     // 9 rotation entries, 3 translation entries

// Floats (bytes for the mask) from one sequence's per-call input to the
// next; 0 shares the input between the sequences.
struct SeqStrides {
  long long posedirs, v_shaped, weights, frame, mask, packed;
};

// floats of shared memory beyond the MLP's: the pair's vertices, then per
// candidate pose_map (K), rt (12 x 16) and offset (3, padded to 4)
__host__ __device__ inline int stage_floats(int k) { return round_up4(k) + kRoles * kJoints + 4; }
inline long long skin_smem_bytes(int k, int n) {
  return kMlpSmemBytes + static_cast<long long>(sizeof(float)) *
      (kPair * 3LL * round_up4(n) + kPair * stage_floats(k));
}

__global__ void __launch_bounds__(kMlpThreads, 2)
hand_energy_skin_kernel(const float* __restrict__ pose_map, const float* __restrict__ rt,
                        const float* __restrict__ offset, const float* __restrict__ posedirs,
                        const float* __restrict__ v_shaped, const float* __restrict__ weights,
                        const float* __restrict__ frame_g, const unsigned char* __restrict__ mask,
                        const float* __restrict__ packed, float* __restrict__ sdf_out,
                        float* __restrict__ hit_out, int p_total, int k_pose, int n, int h, int w,
                        SeqStrides seq, MlpShape shape) {
  extern __shared__ float4 smem4[];
  {
    const long long s = blockIdx.y;
    pose_map += s * p_total * k_pose;
    rt += s * p_total * (kRoles * kJoints);
    offset += s * p_total * 3;
    sdf_out += s * p_total * n;
    hit_out += s * p_total * n;
    posedirs += s * seq.posedirs;
    v_shaped += s * seq.v_shaped;
    weights += s * seq.weights;
    frame_g += s * seq.frame;
    mask += s * seq.mask;
    packed += s * seq.packed;
  }
  float* act = reinterpret_cast<float*>(smem4);
  float* red = act + kActFloats;
  float* xs = red + kRedFloats;                      // [cand][coord][n4]
  const int n4 = round_up4(n);
  float* stage = xs + kPair * 3 * n4;                // [cand][stage_floats]
  const int stage_n = stage_floats(k_pose);
  const int k4 = round_up4(k_pose);

  const int p0 = blockIdx.x * kPair;
  const int n_cand = min(kPair, p_total - p0);
  const int tid = threadIdx.x;
  const int slot = tid & (kTilePoints - 1), half = tid >> 7;

  // the pair's per-candidate inputs into shared memory (zeros for a missing one)
  for (int i = tid; i < kPair * stage_n; i += kMlpThreads) {
    const int g = i / stage_n, j = i - g * stage_n;
    const long long p = p0 + g;
    float v = 0.0f;
    if (g < n_cand) {
      if (j < k_pose) v = __ldg(pose_map + p * k_pose + j);
      else if (j >= k4 && j < k4 + kRoles * kJoints) v = __ldg(rt + p * (kRoles * kJoints) + (j - k4));
      else if (j >= k4 + kRoles * kJoints && j < k4 + kRoles * kJoints + 3)
        v = __ldg(offset + p * 3 + (j - k4 - kRoles * kJoints));
    }
    stage[i] = v;
  }
  __syncthreads();

  // ---- phase 1: the pair's vertices ----
  const float* pm0 = stage;
  const float* pm1 = stage + stage_n;
  for (int base = half * kTilePoints; base < n; base += 2 * kTilePoints) {
    const int v = base + slot;
    if (v >= n) continue;
    float vp[kPair][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* pd = posedirs + static_cast<long long>(c) * k_pose * n + v;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 9
      for (int k = 0; k < k_pose; ++k) {
        const float d = __ldg(pd + static_cast<long long>(k) * n);
        a0 = fmaf(d, pm0[k], a0);
        a1 = fmaf(d, pm1[k], a1);
      }
      const float vs = __ldg(v_shaped + static_cast<long long>(c) * n + v);
      vp[0][c] = __fadd_rn(a0, vs);
      vp[1][c] = __fadd_rn(a1, vs);
    }
    float wv[kJoints];
#pragma unroll
    for (int j = 0; j < kJoints; ++j) wv[j] = __ldg(weights + static_cast<long long>(j) * n + v);
#pragma unroll
    for (int g = 0; g < kPair; ++g) {
      const float* rg = stage + g * stage_n + k4;       // [role][joint]
      const float* og = rg + kRoles * kJoints;
      float s[kRoles];
#pragma unroll
      for (int r = 0; r < kRoles; ++r) {
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < kJoints; ++j) a = fmaf(rg[r * kJoints + j], wv[j], a);
        s[r] = a;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float a = __fmul_rn(s[3 * c], vp[g][0]);
        a = fmaf(s[3 * c + 1], vp[g][1], a);
        a = fmaf(s[3 * c + 2], vp[g][2], a);
        xs[(g * 3 + c) * n4 + v] = __fadd_rn(__fadd_rn(a, s[9 + c]), og[c]);
      }
    }
  }
  __syncthreads();

  // ---- phase 2: the per-vertex energy over the pair's flat vertex list ----
  const float scale = __ldg(packed), clamp = __ldg(packed + 1);
  const float* freqs = packed + 4;
  const float* layers = freqs + round_up4(shape.n_freqs);
  float frame[kFrameFloats];
#pragma unroll
  for (int i = 0; i < kFrameFloats; ++i) frame[i] = __ldg(frame_g + i);
  const int total = n_cand * n;
  const long long out_base = static_cast<long long>(p0) * n;
  for (int base = 0; base < total; base += kTilePoints) {
    const int i = base + slot;
    float x = 0.0f, y = 0.0f, z = 1.0f;
    float obj[3] = {0.0f, 0.0f, 0.0f};
    if (i < total) {
      const int g = i >= n ? 1 : 0;
      const int v = i - g * n;
      x = xs[(g * 3 + 0) * n4 + v];
      y = xs[(g * 3 + 1) * n4 + v];
      z = xs[(g * 3 + 2) * n4 + v];
      scaled_object_frame(frame, scale, x, y, z, obj);
    }
    build_features(act, freqs, shape.n_freqs, obj[0], obj[1], obj[2]);
    __syncthreads();
    if (half == 1 && i < total) hit_out[out_base + i] = silhouette_hit(mask, h, w, frame, x, y, z);
    const float s = mlp_tile(act, red, layers, shape, clamp);
    if (half == 0 && i < total) sdf_out[out_base + i] = s;
  }
}

int g_smem_limit = 0;  // what the device lets a block of this kernel opt into

}  // namespace

extern "C" {

// Opts the kernel into as much dynamic shared memory as a block may have on
// the current device, once per process; a launch takes what its N needs.
int hotrack_hand_energy_skin_init() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&g_smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      hand_energy_skin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_limit));
}

// pose_map (p, k), rt (p, 12, 16), offset (p, 3), posedirs (3, k, n), v_shaped (3, n),
// weights (16, n), frame (16,), mask (h, ceil(w / 8)) uint8, packed, sdf (p, n),
// hit (p, n), each with a leading n_seq: device pointers; seq_strides: 6 host
// long longs, SeqStrides' fields in order; widths: n_hidden + 1 host ints.
// Returns cudaErrorInvalidValue when the pair's vertices do not fit a block's
// shared memory (n above about 6000).
int hotrack_hand_energy_skin(const void* pose_map, const void* rt, const void* offset,
                             const void* posedirs, const void* v_shaped, const void* weights,
                             const void* frame, const void* mask, const void* packed,
                             void* sdf, void* hit, int p, int k, int n, int h, int w,
                             int n_seq, const long long* seq_strides, int n_freqs,
                             int n_hidden, const int* widths, void* stream) {
  const MlpShape shape = make_mlp_shape(n_freqs, n_hidden, widths);
  if (mlp_shape_error(shape) || p < 1 || k < 1 || n < 1 || h < 1 || w < 1 || n_seq < 1 ||
      n_seq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const SeqStrides seq{seq_strides[0], seq_strides[1], seq_strides[2], seq_strides[3],
                       seq_strides[4], seq_strides[5]};
  const long long smem = skin_smem_bytes(k, n);
  if (smem > g_smem_limit || static_cast<long long>(kPair) * n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p + kPair - 1) / kPair), static_cast<unsigned>(n_seq));
  hand_energy_skin_kernel<<<grid, kMlpThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose_map), static_cast<const float*>(rt),
      static_cast<const float*>(offset), static_cast<const float*>(posedirs),
      static_cast<const float*>(v_shaped), static_cast<const float*>(weights),
      static_cast<const float*>(frame), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(packed), static_cast<float*>(sdf), static_cast<float*>(hit), p,
      k, n, h, w, seq, shape);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
